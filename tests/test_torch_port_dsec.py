"""PyTorch port vs the JAX package on a DSEC tree written into
``tmp_path``: the readers, reference-named checkpoints in, and the
evaluation protocol end to end.

- ``DSECDatasetLite`` (1 and 2 chunks, ``NNbins`` and ``NNbins_pol``) and
  ``DSECEventListDataset`` (truncated or not) item for item against JAX.
- A reference-named ``.pt`` (``module.`` prefix, ``num_batches_tracked``
  and membrane-state keys), built from randomized JAX variables with JAX's
  ``flax_to_torch_key`` and inverse layouts, loads into the port with the
  tensors of ``from_jax``; the port's inverse gives JAX's names.
- ``eval_dsec.evaluate`` with a float64 tiny model against JAX's
  ``make_eval_step`` + ``make_metrics_fn`` + ``MetricsAccumulator`` with
  the same weights (``rtol=1e-9``), in both layouts (the events dyadic, so
  both voxelizers are exact), ``mask_events`` on and off, a ragged last
  batch; the event layout gives the voxel layout's results (the tree's
  voxels are the grids of its events); ``eval_dsec.main --device cpu``
  gives ``evaluate``'s results and submission PNGs within 1/128 px.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu.data import dsec as j_dsec
from sdformerflow_tpu.data.augmentation import center_crop as j_center_crop
from sdformerflow_tpu.models import get_model as j_get_model
from sdformerflow_tpu.ops.normalization import encode_input as j_encode
from sdformerflow_tpu.training import config as j_config
from sdformerflow_tpu.training import evaluate as j_evaluate
from sdformerflow_tpu.training import torch_interop as j_interop
from sdformerflow_tpu.training import train_step as j_train_step
from sdformerflow_tpu_torch import eval_dsec, train_dsec
from sdformerflow_tpu_torch.data import dsec
from sdformerflow_tpu_torch.models.registry import get_model
from sdformerflow_tpu_torch.training import config as t_config
from sdformerflow_tpu_torch.training import torch_interop
from sdformerflow_tpu_torch.training.from_jax import from_jax
from sdformerflow_tpu_torch.utils.visualization import read_flow_png

from dsec_tree import (BINS, CROP, FRAME, N_VALID, make_tree,
                       save_reference_checkpoint, tiny_config, write_config)
from torch_port_harness import randomize_tree
from torch_port_harness import one_torch_thread  # noqa: F401

# reference layouts from flax layouts (torch_interop's transforms inverted)
_INV = {"conv": lambda a: a.transpose(3, 2, 0, 1),
        "deconv": lambda a: a.transpose(2, 3, 0, 1),
        "linear": lambda a: a.T, "id": lambda a: a}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(str(tmp_path_factory.mktemp("dsec")))


@pytest.fixture(scope="module")
def weights(tree, tmp_path_factory):
    """(JAX model, randomized float64 JAX variables, path of the
    reference-named .pt built from them with JAX's key map)."""
    cfg = j_config.load_config(write_config(
        tmp_path_factory.mktemp("cfg") / "tiny.yaml", tiny_config(tree)))
    jmodel = j_get_model(cfg["model"]["name"], *j_config.build_configs(cfg))
    x = j_encode(jnp.zeros((1, BINS) + tuple(CROP)))
    variables = jax.jit(lambda z: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, z, False))(x)
    variables = randomize_tree(variables, seed=3)
    state = {}
    for coll, tree_ in variables.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree_)[0]:
            fpath = "/".join(p.key for p in path)
            key, tr = j_interop.flax_to_torch_key(coll, fpath, max_depth=1)
            assert key is not None, fpath
            state[key] = torch.from_numpy(
                np.ascontiguousarray(_INV[tr](np.asarray(leaf))))
    pt = save_reference_checkpoint(
        tmp_path_factory.mktemp("ckpt") / "reference.pt", state)
    return jmodel, variables, pt


def port_model(cfg, variables=None):
    model = get_model(cfg["model"]["name"], *t_config.build_configs(cfg))
    if variables is not None:
        model.double().load_state_dict(from_jax(variables, model))
    return model


# --------------------------------------------------------------- readers

def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
    else:
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("num_chunks", [1, 2])
@pytest.mark.parametrize("polarity", [True, False])
def test_dsec_dataset_lite_matches_jax(tree, num_chunks, polarity):
    cfg = {"data": {"path": tree, "num_frames": BINS,
                    "num_chunks": num_chunks},
           "model": {"encoding": "voxel"}, "loader": {"polarity": polarity}}
    want, got = j_dsec.DSECDatasetLite(cfg, "valid"), \
        dsec.DSECDatasetLite(cfg, "valid")
    assert len(got) == len(want) == N_VALID
    for i in range(N_VALID):
        for a, b in zip(got[i], want[i]):
            _same(a, b)
    chunk = got[0][0]
    assert chunk.shape == ((BINS * num_chunks,) if polarity
                           else (BINS * num_chunks, 2)) + FRAME


@pytest.mark.parametrize("max_events", [4096, 1 << 21])
def test_dsec_event_list_dataset_matches_jax(tree, max_events):
    """The port packs in file order: JAX's reader at ``presort=False``."""
    cfg = {"data": {"path": tree}}
    want = j_dsec.DSECEventListDataset(cfg, "valid", max_events=max_events,
                                       presort=False)
    got = dsec.DSECEventListDataset(cfg, "valid", max_events=max_events)
    for i in range(N_VALID):
        for a, b in zip(got[i], want[i]):
            _same(a, b)
    assert got[0][0]["t"][0] == 0.0
    if max_events == 4096:                          # some windows truncated
        assert got[0][0]["x"].size == 4096


# ----------------------------------------------------------- checkpoints

def test_reference_checkpoint_loads_as_from_jax(tree, weights):
    _, variables, pt = weights
    model = port_model(tiny_config(tree))
    sd = torch_interop.load_torch_checkpoint(pt)
    assert all(k.startswith("module.") for k in sd)
    got, unmatched = torch_interop.load_reference_state_dict(sd, model)
    assert unmatched == []
    want = from_jax(variables, model)
    assert set(got) == set(want) == set(model.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the inverse: JAX's reference names, the tensors of the .pt
    model.double().load_state_dict(want)
    ref = torch_interop.to_reference_state_dict(model)
    saved = {k[len("module."):]: v for k, v in torch.load(pt).items()
             if not k.endswith(("num_batches_tracked", "spiking_neuron.v"))}
    assert set(ref) == set(saved)
    for k in ref:
        np.testing.assert_array_equal(ref[k].numpy(), saved[k].numpy(),
                                      err_msg=k)
    # the port's copy of the key map names every variable as JAX's does
    for coll, tree_ in variables.items():
        for path, _ in jax.tree_util.tree_flatten_with_path(tree_)[0]:
            fpath = "/".join(p.key for p in path)
            assert torch_interop.flax_to_torch_key(
                coll, fpath, max_depth=1) == j_interop.flax_to_torch_key(
                    coll, fpath, max_depth=1), fpath
    # an unknown reference key is reported, a missing one raises
    sd["module.extra.weight"] = np.zeros(1)
    assert torch_interop.load_reference_state_dict(sd, model)[1] == [
        "extra.weight"]
    del sd[next(k for k in sd if k.endswith("proj.weight"))]
    with pytest.raises(KeyError, match="no JAX variable"):
        torch_interop.load_reference_state_dict(sd, model)


def test_load_torch_checkpoint_whole_model_needs_its_classes(tmp_path,
                                                            monkeypatch):
    (tmp_path / "refnet_mod.py").write_text(
        "import torch\nclass Net(torch.nn.Module):\n"
        "    def __init__(self):\n        super().__init__()\n"
        "        self.fc = torch.nn.Linear(2, 3)\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    import refnet_mod
    torch.save(refnet_mod.Net(), str(tmp_path / "whole.pt"))
    sd = torch_interop.load_torch_checkpoint(str(tmp_path / "whole.pt"))
    assert sorted(sd) == ["fc.bias", "fc.weight"]
    os.remove(tmp_path / "refnet_mod.py")
    monkeypatch.delitem(sys.modules, "refnet_mod")
    with pytest.raises(RuntimeError, match="state_dict"):
        torch_interop.load_torch_checkpoint(str(tmp_path / "whole.pt"))


# ------------------------------------------------------------ evaluation

def jax_evaluate(cfg, jmodel, variables, dataset):
    """The loop of scripts/eval_dsec.py with JAX's own pieces: its eval
    step's float32 flows, the labels and the masks cast to float64, so the
    metrics run in float64, as the port's ``evaluate`` runs them."""
    kw = dict(encoding="voxel", polarity=True, norm_input="minmax",
              spike_th=None)
    crop = tuple(cfg["loader"]["crop"])
    voxelize = None
    if isinstance(dataset[0][0], dict):
        voxelize = dict(num_bins=BINS, height=FRAME[0], width=FRAME[1],
                        presorted=dataset.events_presorted)
    step = j_train_step.make_eval_step(
        **kw, use_batch_stats=False, voxelize=voxelize,
        crop=crop if voxelize else None)
    state = j_train_step.TrainState(
        step=0, params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=(),
        apply_fn=jmodel.apply, tx=None)
    metrics_fn = j_evaluate.make_metrics_fn(
        metric_names=cfg["metrics"]["name"],
        mask_events=cfg["metrics"]["mask_events"], **kw)
    acc = j_evaluate.MetricsAccumulator()
    for batch in j_dsec.batch_iterator(dataset, cfg["loader"]["batch_size"],
                                       drop_last=False):
        label, mask = (jnp.asarray(batch[k], jnp.float64)
                       for k in ("label", "mask"))
        if "events" in batch:
            chunk = {k: jnp.asarray(v) for k, v in batch["events"].items()}
            _, label, mask = j_center_crop(label, label, mask, crop)
        else:
            chunk, label, mask = j_center_crop(jnp.asarray(batch["chunk"]),
                                               label, mask, crop)
        pred = step(state, chunk)[-1].astype(jnp.float64)
        acc.append(metrics_fn(pred, label, mask,
                              None if voxelize else chunk), label.shape[0])
    return acc.results()


@pytest.mark.parametrize("events,mask_events", [(False, False),
                                                (False, True), (True, False)])
def test_evaluate_matches_jax_f64(tree, weights, events, mask_events):
    """Three windows in batches of 2 and 1."""
    jmodel, variables, _ = weights
    cfg = tiny_config(tree, events=events, mask_events=mask_events)
    cls = dsec.DSECEventListDataset if events else dsec.DSECDatasetLite
    jcls = j_dsec.DSECEventListDataset if events else j_dsec.DSECDatasetLite
    with jax.enable_x64(True):
        want = jax_evaluate(cfg, jmodel, variables, jcls(cfg, "valid"))
    got = eval_dsec.evaluate(cfg, port_model(cfg, variables),
                             cls(cfg, "valid"), device="cpu")
    assert got["num_samples"] == N_VALID and got["num_batches"] == 2
    assert set(got) == set(want) == {"AEE", "PE1", "PE2", "PE3", "outlier",
                                     "AAE", "num_batches", "num_samples"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)


def test_event_layout_equals_voxel_layout(tree, weights):
    got = [eval_dsec.evaluate(cfg, port_model(cfg, weights[1]),
                              cls(cfg, "valid"), device="cpu")
           for cfg, cls in ((tiny_config(tree, events=True),
                             dsec.DSECEventListDataset),
                            (tiny_config(tree), dsec.DSECDatasetLite))]
    assert got[0] == got[1] and got[0]["num_samples"] == N_VALID


class _Recorder:
    def __init__(self):
        self.flows = []

    def update(self, flow, gt_flow, submission_flow):
        self.flows.append(submission_flow.numpy())


def test_main_on_cpu_matches_evaluate(tree, weights, tmp_path):
    """The entry with --torch_ckpt on the float32 model: results.json and
    the submission PNGs are those of ``evaluate`` with that model."""
    cfg = tiny_config(tree, mask_events=True, batch_size=1)
    path = write_config(tmp_path / "tiny.yaml", cfg)
    run = str(tmp_path / "run")
    got = eval_dsec.main(["--train_config", path, "--torch_ckpt", weights[2],
                          "--path", tree, "--device", "cpu", "--run_dir", run,
                          "--store_submission", "--fused_attn"])
    with open(os.path.join(run, "results.json")) as f:
        assert json.load(f) == got
    model = port_model(t_config.load_config(path))
    model.load_state_dict(torch_interop.load_reference_state_dict(
        torch_interop.load_torch_checkpoint(weights[2]), model)[0])
    rec = _Recorder()
    want = eval_dsec.evaluate(t_config.load_config(path), model,
                              dsec.DSECDatasetLite(cfg, "valid"),
                              device="cpu", vis=rec, submission=True)
    assert got == want and got["num_samples"] == N_VALID
    subs = sorted(os.listdir(os.path.join(run, "vis", "submission")))
    assert len(subs) == len(rec.flows) == N_VALID
    for name, flow in zip(subs, rec.flows):
        back, _ = read_flow_png(os.path.join(run, "vis", "submission", name))
        assert back.shape == (2, *CROP)
        assert np.abs(back - flow).max() < 1 / 128


@pytest.mark.parametrize("flag", ["--store_spike_rates", "--energy_report",
                                  "--store_membrane", "--log_attn", "--show"])
def test_main_refuses_what_is_not_ported(flag):
    """``--show`` (live cv2 windows) is refused with its reason; the four
    monitors are ported and get as far as reading the config."""
    if flag == "--show":
        with pytest.raises(NotImplementedError, match="item 9"):
            eval_dsec.main(["--train_config", "x.yaml", flag, "--device",
                            "cpu"])
        return
    with pytest.raises(FileNotFoundError, match="x.yaml"):
        eval_dsec.main(["--train_config", "x.yaml", flag, "--device", "cpu"])


def test_main_and_trainer_need_a_card_unless_told(tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        eval_dsec.main(["--train_config", "x.yaml"])
    with pytest.raises(SystemExit, match="--device cpu"):
        train_dsec.main(["--config", "x.yaml", "--path", tree])


@pytest.mark.parametrize("events", [False, True])
def test_trainer_reads_the_tree(tree, tmp_path, events):
    """train_dsec on the DSEC tree (no --synthetic): one float32 step from
    the train split (raw events on the whole frame, as in JAX), validation
    on the valid split; the voxel run's checkpoint restored by
    ``eval_dsec --ckpt`` and ``FlowServer(ckpt=...)``."""
    from sdformerflow_tpu_torch.serving import FlowServer
    cfg = tiny_config(tree, events=events, batch_size=1)
    cfg["optimizer"]["use_amp"] = False
    path = write_config(tmp_path / "tiny.yaml", cfg)
    run = str(tmp_path / "run")
    # oneDNN corrupted the heap in small float32 train steps on the CPU
    with torch.backends.mkldnn.flags(enabled=False):
        model, opt = train_dsec.main(["--config", path, "--device", "cpu",
                                      "--max_steps", "1", "--run_dir", run])
    assert int(opt.count) == 1
    with open(os.path.join(run, "metrics.jsonl")) as f:
        names = {json.loads(line)["name"] for line in f}
    assert {"train_loss", "valid_loss"} <= names
    if events:
        return
    ckpt = os.path.join(run, "ckpt")
    res = eval_dsec.main(["--train_config", path, "--ckpt", ckpt,
                          "--device", "cpu", "--run_dir", run + "_eval",
                          "--max_batches", "1"])
    assert res["num_batches"] == 1 and np.isfinite(res["AEE"])
    with FlowServer(t_config.load_config(path), ckpt=ckpt, device="cpu",
                    bf16=False) as server:
        for k, v in server.model.state_dict().items():
            assert torch.equal(v, model.state_dict()[k]), k
    with pytest.raises(ValueError, match="not both"):
        FlowServer(t_config.load_config(path), model.state_dict(), ckpt=ckpt,
                   device="cpu")
