"""PyTorch port vs the JAX package on the MDR / MVSEC slice, on trees
written into ``tmp_path`` in the pattern of ``tests/test_e2e_mdr_chain.py``:

- ``events_to_voxel_grid`` (both ``pol`` modes) bitwise; the numpy
  bilinear resize against ``cv2.resize`` (equal shapes, within 1e-4 on
  standard-normal data); ``estimate_corresponding_gt_flow`` equal to JAX's
  cv2 version away from .5 ties; ``DenseSparseAugmentor`` with a shared seed
  within 1e-4;
- ``MDREventFlow`` (train with and without augmentation, val),
  ``MvsecEventFlow`` and ``MvsecEventFlow_dt4`` (``outdoor_day1``'s row cut
  included) and both adapters, item for item (bitwise where no resize
  runs, else within 1e-4);
- ``eval_mvsec.main --device cpu`` against JAX's ``scripts/eval_mvsec.main``
  with the same float64 weights (``from_jax``), metrics within 1e-9;
- ``train_mdr``: JAX's script and the port's give the loop the same config
  and the same batches; the port's trains 2 steps on the CPU, writes
  ``metrics.jsonl`` and a checkpoint that ``eval_mvsec --ckpt`` reads.
"""

import json
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sdformerflow_tpu.data import adapters as j_adapters
from sdformerflow_tpu.data import dsec as j_dsec
from sdformerflow_tpu.data import loader_utils as j_lu
from sdformerflow_tpu.data import mdr as j_mdr
from sdformerflow_tpu.data import mvsec as j_mvsec
from sdformerflow_tpu.models import get_model as j_get_model
from sdformerflow_tpu.ops.normalization import encode_input as j_encode
from sdformerflow_tpu.training import config as j_config
from sdformerflow_tpu.training.evaluate import (
    make_metrics_fn as j_make_metrics_fn)
from sdformerflow_tpu_torch import eval_mvsec, train_mdr
from sdformerflow_tpu_torch.data import adapters, dsec, loader_utils as lu
from sdformerflow_tpu_torch.data import mdr, mvsec
from sdformerflow_tpu_torch.models.registry import get_model
from sdformerflow_tpu_torch.training import config as t_config
from sdformerflow_tpu_torch.training.from_jax import from_jax

from torch_port_harness import randomize_tree
from torch_port_harness import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(REPO, "scripts"))

RES, CROP, BINS = (36, 44), (32, 32), 4
# outdoor_day1 at a sensor tall enough that its row cut (rows >= 193 of
# the sensor) falls inside the crop
OUT_RES, OUT_CROP = (200, 24), (196, 16)
N_GT = 6                    # GT frames written per sequence and interval
MDR_SCENES = 4
INDOOR, OUTDOOR = "indoor_flying1", "outdoor_day1"


# ------------------------------------------------------------- the tree

def _npz_events(path, rng, h, w, n=600):
    t0 = rng.uniform(0, 1e9)
    np.savez(path, t=(t0 + np.sort(rng.uniform(0, 3e7, n))).astype(np.float64),
             x=rng.integers(0, w, n).astype(np.float64),
             y=rng.integers(0, h, n).astype(np.float64),
             p=rng.integers(0, 2, n).astype(np.float64))


def _write_flo(path, flow_hw2):
    h, w, _ = flow_hw2.shape
    with open(path, "wb") as f:
        np.asarray([202021.25], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow_hw2.astype(np.float32).tofile(f)


def _mdr_split(base, rng, best_density):
    h, w = RES
    for i in range(MDR_SCENES):
        scene = f"scene_{i:02d}"
        for sub in ("events1", "events2"):
            os.makedirs(os.path.join(base, sub, scene), exist_ok=True)
            _npz_events(os.path.join(base, sub, scene, f"{scene}_{sub}.npz"),
                        rng, h, w)
        if best_density:
            for sub in ("best_density_events1", "best_density_events2"):
                os.makedirs(os.path.join(base, sub), exist_ok=True)
                _npz_events(os.path.join(base, sub, f"{scene}_{sub}.npz"),
                            rng, h, w)
        os.makedirs(os.path.join(base, "flow"), exist_ok=True)
        _write_flo(os.path.join(base, "flow", f"{scene}_flow.flo"),
                   rng.normal(0, 2, (h, w, 2)))


def _mvsec_sequence(root, seq, rng, res):
    """Event files for N_GT dt4 samples (N_GT + 7) and N_GT GT frames for
    each interval, written by the port's writer."""
    first = mvsec.VALID_TIME_INDEX[seq][0][0]
    h, w = res
    os.makedirs(os.path.join(root, seq, "event"))
    t = 0.0
    for k in range(N_GT + 7):
        n = 500
        ev = np.stack([t + np.sort(rng.uniform(0, 0.05, n)),
                       rng.integers(0, w, n).astype(np.float64),
                       rng.integers(0, h, n).astype(np.float64),
                       rng.choice([0.0, 1.0], n)], axis=1)
        lu.write_events_h5(os.path.join(root, seq, "event",
                                        f"{first + 1 + k:06d}.h5"), ev)
        t += 0.05
    for dt in ("dt1", "dt4"):
        os.makedirs(os.path.join(root, seq, f"flowgt_{dt}"))
        for k in range(N_GT):
            flow = rng.normal(0, 3, (2, h, w)).astype(np.float32)
            flow[:, h // 2, w // 2] = 2000.0   # outside |flow| < 1000
            np.save(os.path.join(root, seq, f"flowgt_{dt}",
                                 f"{first + k}.npy"), flow)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mdr_mvsec"))
    rng = np.random.default_rng(11)
    _mdr_split(os.path.join(root, "dt1", "train"), rng, best_density=True)
    _mdr_split(os.path.join(root, "dt1", "test", "0.09_0.24"), rng,
               best_density=False)
    _mvsec_sequence(root, INDOOR, rng, RES)
    _mvsec_sequence(root, OUTDOOR, rng, OUT_RES)
    return root


def tiny_config(root, **data):
    """An en4 small enough for float64 on the CPU at the tree's crop."""
    cfg = {
        "data": {"path": root, "num_frames": BINS, "num_chunks": 1,
                 "preprocessed": False, "valid_sequence": "0.09_0.24",
                 "test_sequence": INDOOR, "event_interval": "dt1", **data},
        "model": {"name": "MS_SpikingformerFlowNet_en4", "encoding": "voxel",
                  "norm_input": "minmax", "num_bins": BINS,
                  "base_num_channels": 8, "kernel_size": 3,
                  "use_upsample_conv": False},
        "swin_transformer": {
            "use_arc": ["swinv1", "MS_PED_Spiking_PatchEmbed_Conv_sfn"],
            "swin_depths": [1, 1, 1, 1], "swin_num_heads": [2, 2, 4, 4],
            "swin_out_indices": [0, 1, 2, 3], "swin_patch_size": [1, 1, 2, 2],
            "window_size": [2, 3, 3], "pretrained_window_size": [0, 0, 0],
            "mlp_ratio": 2},
        "spiking_neuron": {"num_steps": BINS, "v_th": 0.1, "v_reset": None,
                           "neuron_type": "psn", "surrogate_fun": "atan",
                           "spike_norm": "BN"},
        "loss": {"clip_grad": 100.0},
        "optimizer": {"lr": 1e-4, "milestones": [10], "use_amp": False},
        "loader": {"batch_size": 2, "resolution": list(RES),
                   "crop": list(CROP), "polarity": True, "n_epochs": 1,
                   "min_scale": -0.1, "max_scale": 1.0, "seed": 0,
                   "augment": ["Horizontal"], "augment_prob": [0.5]},
        "metrics": {"name": ["AEE"], "flow_scaling": 1,
                    "mask_events": False},
        "test": {"sample": 2, "n_valid": 1},
    }
    return cfg


def write_yaml(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _same_items(got, want, atol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same_items(got[k], want[k], atol)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_items(a, b, atol)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if atol and want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- loader utilities

@pytest.mark.parametrize("pol", [True, False])
def test_events_to_voxel_grid_matches_jax(pol):
    rng = np.random.default_rng(0)
    n = 3000
    ev = np.stack([rng.uniform(0, 0.03, n), rng.integers(0, 44, n),
                   rng.integers(0, 36, n), rng.choice([-1.0, 1.0], n)], 1)
    got = lu.events_to_voxel_grid(
        lu.EventSequence(ev, 36, 44, timestamp_multiplier=1e6,
                         convert_to_relative=True), 5, pol=pol)
    want = j_lu.events_to_voxel_grid(
        j_lu.EventSequence(ev, 36, 44, timestamp_multiplier=1e6,
                           convert_to_relative=True), 5, pol=pol)
    assert got.shape == ((5, 36, 44) if pol else (5, 2, 36, 44))
    _same_items(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_resize_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        h, w = rng.integers(4, 50, 2)
        c = int(rng.integers(1, 21))
        a = rng.standard_normal((h, w, c)).astype(np.float32)
        fx, fy = 2 ** rng.uniform(-0.3, 1.2, 2)
        want = cv2.resize(a, None, fx=fx, fy=fy,
                          interpolation=cv2.INTER_LINEAR)
        got = lu.resize_linear(a, fx, fy)
        assert got.shape == want.shape[:2] + (c,) and got.dtype == a.dtype
        np.testing.assert_allclose(got, want.reshape(got.shape), atol=1e-4,
                                   rtol=0)
    flat = rng.standard_normal((9, 13)).astype(np.float32)
    np.testing.assert_allclose(
        lu.resize_linear(flat, 1.7, 1.3),
        cv2.resize(flat, None, fx=1.7, fy=1.3,
                   interpolation=cv2.INTER_LINEAR), atol=1e-4, rtol=0)


def test_resize_refuses_what_cv2_refuses():
    a = np.zeros((8, 8, 4, 2), np.float32)
    with pytest.raises(cv2.error):
        cv2.resize(a, None, fx=1.5, fy=1.5, interpolation=cv2.INTER_LINEAR)
    with pytest.raises(ValueError, match="4-D"):
        lu.resize_linear(a, 1.5, 1.5)


def test_remap_nearest_matches_cv2_with_ties():
    rng = np.random.default_rng(3)
    img = rng.standard_normal((20, 30)).astype(np.float32)
    mx = rng.uniform(-3, 33, (20, 30)).astype(np.float32)
    my = rng.uniform(-3, 23, (20, 30)).astype(np.float32)
    mx[0, :6] = np.float32([0.5, 1.5, 2.5, -0.5, 28.5, 29.5])
    my[0, :6] = np.float32([0.5, 1.5, 18.5, 19.5, -0.5, 2.5])
    np.testing.assert_array_equal(
        lu.remap_nearest(img, mx, my),
        cv2.remap(img, mx, my, cv2.INTER_NEAREST))


@pytest.mark.parametrize("start,end", [(0.013, 0.031), (0.0301, 0.0302),
                                       (0.001, 0.099)])
def test_estimate_corresponding_gt_flow_matches_jax(start, end):
    """A chain of 10 GT frames 10 ms apart: the short interval scales one
    frame, the others chain 2 and 10 remaps."""
    rng = np.random.default_rng(4)
    xf = rng.normal(0, 2.0, (10, 24, 30))
    yf = rng.normal(0, 2.0, (10, 24, 30))
    ts = np.arange(11) * 0.01
    got = lu.estimate_corresponding_gt_flow(xf, yf, ts, start, end)
    want = j_lu.estimate_corresponding_gt_flow(xf, yf, ts, start, end)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert np.abs(got[0]).sum() > 0


@pytest.mark.parametrize("seed", range(6))
def test_dense_sparse_augmentor_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    arrays = [rng.standard_normal((36, 44, 5)).astype(np.float32)
              for _ in range(4)]
    flow = rng.normal(0, 2, (36, 44, 2)).astype(np.float32)
    kw = dict(min_scale=-0.1, max_scale=1.0, do_flip=True)
    got = lu.DenseSparseAugmentor((32, 32), rng=np.random.default_rng(seed),
                                  **kw)(*arrays, flow)
    want = j_lu.DenseSparseAugmentor(
        (32, 32), rng=np.random.default_rng(seed), **kw)(*arrays, flow)
    _same_items(got, want, atol=1e-4)


# --------------------------------------------------------------- datasets

@pytest.mark.parametrize("case", ["train_aug", "train", "val",
                                  "train_per_polarity"])
def test_mdr_items_match_jax(root, case):
    cfg = tiny_config(root)
    if case == "train_per_polarity":
        cfg["loader"]["polarity"] = False
    train, aug = case != "val", case == "train_aug"
    got = mdr.MDREventFlow(cfg, train=train, aug=aug)
    want = j_mdr.MDREventFlow(cfg, train=train, aug=aug)
    assert len(got) == len(want) == MDR_SCENES
    for i in range(len(want)):
        _same_items(got[i], want[i], atol=1e-4 if aug else 0.0)
    if case == "val":
        assert 0 < got[0]["event_valid"].mean() < 1


def test_mdr_per_polarity_augmentation_raises_as_in_jax(root):
    """[bins, 2, H, W] volumes go to the resize as 4-D arrays: cv2 refuses
    them, and so does the port, on the items whose draw resizes (the
    others are cropped and flipped only, and equal)."""
    cfg = tiny_config(root)
    cfg["loader"]["polarity"] = False
    got = mdr.MDREventFlow(cfg, train=True, aug=True)
    want = j_mdr.MDREventFlow(cfg, train=True, aug=True)
    raised = 0
    for i in range(4 * MDR_SCENES):
        try:
            item = want[i]
        except cv2.error:
            with pytest.raises(ValueError, match="4-D"):
                got[i]
            raised += 1
        else:
            _same_items(got[i], item)
    assert 0 < raised < 4 * MDR_SCENES


def _mvsec_config(root, seq, dt):
    if seq == OUTDOOR:
        cfg = tiny_config(root, test_sequence=seq, event_interval=dt)
        cfg["loader"].update(resolution=list(OUT_RES), crop=list(OUT_CROP))
        return cfg
    return tiny_config(root, test_sequence=seq, event_interval=dt)


@pytest.mark.parametrize("seq", [INDOOR, OUTDOOR])
@pytest.mark.parametrize("dt", ["dt1", "dt4"])
def test_mvsec_items_match_jax(root, seq, dt):
    cfg = _mvsec_config(root, seq, dt)
    cls, jcls = ((mvsec.MvsecEventFlow, j_mvsec.MvsecEventFlow) if dt == "dt1"
                 else (mvsec.MvsecEventFlow_dt4, j_mvsec.MvsecEventFlow_dt4))
    got, want = cls(cfg), jcls(cfg)
    assert len(got) == len(want)
    for i in range(N_GT):
        _same_items(got[i], want[i])
    item = got[0]
    assert item["valid"].min() == 0 and item["valid"].mean() > 0.5
    if seq == OUTDOOR:       # the hood: sensor rows >= 193 are not valid
        i0 = round((OUT_RES[0] - OUT_CROP[0]) / 2)
        assert not item["valid"][193 - i0:].any()
        assert item["valid"][:193 - i0].mean() > 0.99


@pytest.mark.parametrize("num_chunks", [1, 2])
def test_adapters_match_jax(root, num_chunks):
    cfg = tiny_config(root)
    pairs = [
        (adapters.MDRChunkAdapter(mdr.MDREventFlow(cfg), num_chunks),
         j_adapters.MDRChunkAdapter(j_mdr.MDREventFlow(cfg), num_chunks)),
        (adapters.MDRChunkAdapter(mdr.MDREventFlow(cfg, train=False),
                                  num_chunks, train=False),
         j_adapters.MDRChunkAdapter(j_mdr.MDREventFlow(cfg, train=False),
                                    num_chunks, train=False)),
        (adapters.MvsecChunkAdapter(mvsec.MvsecEventFlow(cfg), num_chunks),
         j_adapters.MvsecChunkAdapter(j_mvsec.MvsecEventFlow(cfg),
                                      num_chunks))]
    for got, want in pairs:
        for i in range(2):
            _same_items(got[i], want[i])
        assert got[0][0].shape[0] == BINS * num_chunks
    # the MVSEC chunk is the new volume (after the old one with 2 chunks)
    item = mvsec.MvsecEventFlow(cfg)[0]
    np.testing.assert_array_equal(pairs[2][0][0][0][-BINS:],
                                  item["event_volume_new"])


# -------------------------------------------------------- the entries

@pytest.fixture(scope="module")
def weights(root):
    """(JAX model, randomized float64 JAX variables) of the tiny en4."""
    cfg = j_config.load_config(write_yaml(
        os.path.join(root, "tiny_weights.yaml"), tiny_config(root)))
    jmodel = j_get_model(cfg["model"]["name"], *j_config.build_configs(cfg))
    x = j_encode(jnp.zeros((1, BINS) + CROP))
    variables = jax.eval_shape(lambda z: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, z, False), x)
    return jmodel, randomize_tree(variables, seed=5)


def _eval_config(root, dt):
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs",
                                           "eval_mvsec.yaml")))
    cfg["data"].update(path=root, event_interval=dt)
    cfg["loader"].update(resolution=list(RES), crop=list(CROP))
    return cfg


@pytest.mark.parametrize("dt", ["dt1", "dt4"])
def test_eval_mvsec_matches_jax_f64(root, weights, tmp_path, monkeypatch,
                                    dt):
    """Both entries on the same tree and float64 weights, the eval config
    merged over the train config (batch 1, event footprint mask, AEE and
    AAE), 3 batches; JAX's metrics fed float64 as the port feeds its own
    (its batcher's masks are float32)."""
    import eval_mvsec as j_eval_mvsec
    _, variables = weights
    train_cfg = write_yaml(tmp_path / "train.yaml", tiny_config(root))
    eval_cfg = write_yaml(tmp_path / "eval.yaml", _eval_config(root, dt))
    argv = ["--train_config", train_cfg, "--eval_config", eval_cfg,
            "--sequence", INDOOR, "--max_batches", "3"]

    def restore(path, state):
        return state.replace(params=variables["params"],
                             batch_stats=variables["batch_stats"]), 0

    def f64_metrics(**kw):
        # the port's evaluate: the step's flows, the labels and the masks
        # in float64, so the metrics are
        fn = j_make_metrics_fn(**kw)
        return lambda pred, label, mask, chunk=None: fn(
            *(a.astype(jnp.float64) for a in (pred, label, mask)), chunk)

    monkeypatch.setattr(j_eval_mvsec, "restore_checkpoint", restore)
    monkeypatch.setattr(j_eval_mvsec, "make_metrics_fn", f64_metrics)
    monkeypatch.setattr(sys, "argv", ["eval_mvsec"] + argv + [
        "--ckpt", "unused", "--run_dir", str(tmp_path / "jax")])
    with jax.enable_x64(True):
        j_eval_mvsec.main()
    with open(tmp_path / "jax" / "results.json") as f:
        want = json.load(f)

    cfg = t_config.load_config(train_cfg)
    model = get_model(cfg["model"]["name"],
                      *t_config.build_configs(cfg)).double()
    model.load_state_dict(from_jax(variables, model))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save({"model": model.state_dict(), "optimizer": {}, "step": 0,
                "epoch": 0, "metrics": {}}, ckpt / "epoch_000000.pt")
    build = eval_mvsec.get_model
    monkeypatch.setattr(eval_mvsec, "get_model",
                        lambda *a, **k: build(*a, **k).double())
    got = eval_mvsec.main(argv + ["--ckpt", str(ckpt), "--device", "cpu",
                                  "--run_dir", str(tmp_path / "port")])
    with open(tmp_path / "port" / "results.json") as f:
        assert json.load(f) == got
    assert got["num_samples"] == 3 and got["sequence"] == INDOOR
    assert set(got) == set(want) == {"AEE", "PE1", "PE2", "PE3", "outlier",
                                     "AAE", "num_batches", "num_samples",
                                     "sequence"}
    for k in ("AEE", "PE1", "PE2", "PE3", "outlier", "AAE"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)
    assert got["num_batches"] == want["num_batches"] == 3


def jax_script_loop_inputs(path, monkeypatch):
    """What JAX's ``scripts/train_mdr.py`` hands its loop: (config, train
    and valid datasets), its ``train`` replaced by a recorder."""
    import train_mdr as j_train_mdr
    captured = {}
    monkeypatch.setattr(j_train_mdr, "train",
                        lambda cfg, tr, va, **kw: captured.update(
                            cfg=cfg, train=tr, valid=va))
    monkeypatch.setattr(sys, "argv", ["train_mdr", "--config", path])
    j_train_mdr.main()
    return captured["cfg"], captured["train"], captured["valid"]


def test_train_mdr_gives_the_loop_what_jax_gives_it(root, tmp_path,
                                                    monkeypatch):
    """JAX's script and the port's: the same loop config (no augmentation,
    no crop, the crop as the resolution) and the same validation
    batches."""
    path = write_yaml(tmp_path / "mdr.yaml", tiny_config(root))
    jcfg, _, jvalid = jax_script_loop_inputs(path, monkeypatch)
    config = t_config.load_config(path)
    got_cfg = train_mdr.loop_config(config)
    assert got_cfg == jcfg
    assert got_cfg["loader"]["crop"] is None and \
        got_cfg["loader"]["augment"] == []
    assert got_cfg["loader"]["resolution"] == list(CROP)
    _, valid_ds = train_mdr.build_datasets(config)
    got = dsec.batch_iterator(valid_ds, 2)
    want = j_dsec.batch_iterator(jvalid, 2)
    for _ in range(2):
        _same_items(next(got), next(want))


def test_train_mdr_then_eval_mvsec_on_cpu(root, tmp_path, monkeypatch):
    """2 float32 steps on the MDR tree (crop None in the loop: the model is
    built at the datasets' crop), validation on MVSEC: the batches the
    loop trains on are those JAX's loop draws from its script's datasets
    (item 0 read twice first, then batches of the epoch's shuffle; the
    augmentation within 1e-4); metrics.jsonl, and the checkpoint restored
    by eval_mvsec --ckpt, dt4 through the eval config."""
    from sdformerflow_tpu_torch.training import train_loop
    path = write_yaml(tmp_path / "mdr.yaml", tiny_config(root))
    _, jtrain, _ = jax_script_loop_inputs(path, monkeypatch)
    fed, make = [], train_loop.make_train_step

    def recording(*args, **kw):
        step = make(*args, **kw)
        return lambda batch: (fed.append({k: v.numpy().copy() for k, v in
                                          batch.items()}), step(batch))[1]

    monkeypatch.setattr(train_loop, "make_train_step", recording)
    run = str(tmp_path / "run")
    with torch.backends.mkldnn.flags(enabled=False):
        model, opt = train_mdr.main(["--config", path, "--device", "cpu",
                                     "--max_steps", "2", "--run_dir", run])
    assert int(opt.count) == 2 and len(fed) == 2
    for _ in range(2):       # JAX's loop reads item 0 twice first
        jtrain[0]
    want = j_dsec.batch_iterator(jtrain, 2, shuffle=True, seed=0)
    for got in fed:
        _same_items(got, next(want), atol=1e-4)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert {"train_loss", "valid_loss"} <= {m["name"] for m in lines}
    assert all(np.isfinite(m["value"]) for m in lines)
    assert os.listdir(os.path.join(run, "ckpt"))
    eval_cfg = write_yaml(tmp_path / "eval.yaml", _eval_config(root, "dt4"))
    res = eval_mvsec.main(["--train_config", path, "--eval_config", eval_cfg,
                           "--ckpt", os.path.join(run, "ckpt"),
                           "--sequence", INDOOR, "--device", "cpu",
                           "--run_dir", run + "_eval", "--max_batches", "2"])
    assert res["num_batches"] == 2 and np.isfinite(res["AEE"])
    assert res["sequence"] == INDOOR


def test_entries_need_a_card_unless_told(root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        train_mdr.main(["--config", "x.yaml"])
    with pytest.raises(SystemExit, match="--device cpu"):
        eval_mvsec.main(["--train_config", "x.yaml"])
