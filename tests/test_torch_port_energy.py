"""PyTorch port vs the JAX package: the energy accounting, pure Python (no
model compile): ``utils/flops.py`` records integer for integer,
``utils/energy.py`` on the same rates (to 1e-12 relative, and the same
``KeyError`` on a missing site), ``utils/gradients.py`` on the same
arrays, the ``energy_sensitivity`` lines, and ``eval_dsec.main`` with its
four monitor flags on ``configs/test_tiny_snn.yaml`` (synthetic windows, the
CPU): all five artefacts under JAX's names, and ``energy.json`` equal to
JAX's join applied to the port's own ``spike_rates.json``."""

import csv
import json
import math
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from sdformerflow_tpu.models.common import SwinConfig as JSwinConfig
from sdformerflow_tpu.training.config import build_configs as j_build_configs
from sdformerflow_tpu.training.config import load_config as j_load_config
from sdformerflow_tpu.utils import energy as J
from sdformerflow_tpu.utils import flops as JF
from sdformerflow_tpu.utils import gradients as JG
from sdformerflow_tpu_torch import energy_sensitivity, eval_dsec
from sdformerflow_tpu_torch.models.common import SwinConfig
from sdformerflow_tpu_torch.models.registry import get_model, randomize_
from sdformerflow_tpu_torch.training.checkpoints import save_checkpoint
from sdformerflow_tpu_torch.training.config import build_configs, load_config
from sdformerflow_tpu_torch.utils import energy as E
from sdformerflow_tpu_torch.utils import flops as F
from sdformerflow_tpu_torch.utils import gradients as G

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "test_tiny_snn.yaml")
REL = 1e-12

# (SwinConfig fields, record keywords): the en4 flagship, the SEW model of
# the zoo (3 stages, swin-v1), the tiny geometry of tests/test_energy.py
SPIKINGFORMER = {
    "en4": (dict(arc_type="swinv1",
                 patch_embed_type="MS_PED_Spiking_PatchEmbed_Conv_sfn",
                 input_size=(288, 384), patch_size=(1, 1, 2, 2),
                 depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                 out_indices=(0, 1, 2, 3), window_size=(2, 9, 9),
                 qk_scale=0.125), dict(ms=True)),
    "sew-3stage": (dict(arc_type="swinv1",
                        patch_embed_type="Spiking_PatchEmbed_Conv_sfn",
                        input_size=(288, 384), depths=(2, 2, 6),
                        num_heads=(3, 6, 12), out_indices=(0, 1, 2),
                        window_size=(2, 9, 9)),
                   dict(ms=False, num_encoders=3)),
    "tiny": (dict(input_size=(16, 16), depths=(1, 1), num_heads=(2, 2),
                  out_indices=(0, 1), window_size=(2, 2, 2)),
             dict(ms=True, base_channels=16, num_encoders=2, num_ch=2)),
}


@pytest.mark.parametrize("name", sorted(SPIKINGFORMER))
def test_spikingformer_records_equal_jax(name):
    swin, kw = SPIKINGFORMER[name]
    got = F.record_flops_spikingformer(SwinConfig(**swin), **kw)
    want = JF.record_flops_spikingformer(JSwinConfig(**swin), **kw)
    assert got == want
    assert F.total_flops(got) == JF.total_flops(want) > 0
    assert isinstance(F.total_flops(got), int)


SCALARS = {
    # configs/train_dsec_stt_voxel.yaml's STTFlowNet and a 4-encoder one
    "stt": ("flops_stt", dict(img_size=(288, 384), patch=(10, 4, 4),
                              in_chans=20, embed_dim=96, depths=(2, 2, 6),
                              num_heads=(3, 6, 12), window_size=(2, 9, 9),
                              mlp_ratio=4)),
    "stt_4en": ("flops_stt", dict(img_size=(256, 256), patch=(5, 4, 4),
                                  in_chans=10, embed_dim=48,
                                  depths=(2, 2, 6, 2),
                                  num_heads=(3, 6, 12, 24),
                                  window_size=(2, 8, 8), mlp_ratio=4)),
    "multires_unet": ("flops_multires_unet",
                      dict(num_bins=10, base_channels=32, num_encoders=4,
                           kernel_size=5)),
    "multires_unet_3x3": ("flops_multires_unet",
                          dict(num_bins=20, base_channels=64,
                               num_encoders=3, img_size=(256, 256))),
}


@pytest.mark.parametrize("name", sorted(SCALARS))
def test_ann_flops_equal_jax(name):
    fn, kw = SCALARS[name]
    got, want = getattr(F, fn)(**kw), getattr(JF, fn)(**kw)
    assert isinstance(got, int) and got == want > 0


def test_compiled_flops_counts_the_plain_products():
    """Two flops a multiply-add: a linear and a 3x3 conv, counted over one
    call of the plain path on the CPU."""
    lin = torch.nn.Linear(16, 8, bias=False)
    conv = torch.nn.Conv2d(4, 6, 3, padding=1, bias=False)
    x, img = torch.rand(5, 16), torch.rand(2, 4, 7, 9)
    assert F.compiled_flops(lin, x) == 2 * 5 * 16 * 8
    assert F.compiled_flops(conv, img) == 2 * 2 * 7 * 9 * 4 * 6 * 9
    assert F.compiled_flops(lambda a: a + 1, x) == 0


def en4_rates(seed=0):
    """A rate for every MS neuron site the en4 join needs, keyed as the
    site dict of ``make_eval_step(collect_spike_rates=True)`` keys it, and
    one site called twice (its last call wins, in both packages)."""
    rng = np.random.default_rng(seed)
    suffixes = set()
    for src in J._site_rate_map((2, 2, 6, 2), 2, 4).values():
        if src is J.ANALOG:
            continue
        suffixes.update(src if isinstance(src, tuple) else (src,))
    out = {}
    for s in sorted(suffixes):
        path = "sttmultires_unet/" + ("encoders/" if s.startswith(
            ("patch_embed", "stage")) else "") + s.replace(".", "/")
        out[f"{path}/spike_rate/[0]"] = float(rng.random())
    out["sttmultires_unet/decoder0/sn/spike_rate/[1]"] = 0.125
    return out


def close(got, want):
    """Equal structure, numbers within REL relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            close(got[k], want[k])
    elif isinstance(want, (int, float)) and want is not None:
        assert math.isclose(got, want, rel_tol=REL, abs_tol=0.0), (got, want)
    else:
        assert got == want


def test_energy_join_equals_jax():
    swin, _ = SPIKINGFORMER["en4"]
    rates = en4_rates()
    tensors = {k: torch.tensor(v, dtype=torch.float32)
               for k, v in rates.items()}
    assert E.normalize_spike_rates(rates) == J.normalize_spike_rates(rates)
    # the port's site dict (tensors) and JAX's flat floats of the same
    # float32 values give the same rates
    assert E.normalize_spike_rates(tensors) == J.normalize_spike_rates(
        {k: float(v) for k, v in tensors.items()})
    got = E.energy_spikingformer(SwinConfig(**swin), rates, num_steps=10)
    want = J.energy_spikingformer(JSwinConfig(**swin), rates, num_steps=10)
    close(got, want)
    assert 0.0 < got["snn_vs_ann_ratio"] < 1.0
    record = F.record_flops_spikingformer(SwinConfig(**swin))
    close(E.energy_ann(record), J.energy_ann(record))
    assert (E.E_MAC_J, E.E_AC_J, E.ANALOG) == (J.E_MAC_J, J.E_AC_J, J.ANALOG)


def test_energy_join_raises_on_a_missing_site_in_both():
    swin, _ = SPIKINGFORMER["en4"]
    rates = {k: v for k, v in en4_rates().items()
             if "stage1/block1/attn/attn_sn" not in k}
    for pkg, cfg in ((E, SwinConfig), (J, JSwinConfig)):
        with pytest.raises(KeyError, match="attn_sn"):
            pkg.energy_spikingformer(cfg(**swin), rates, num_steps=10)


def test_normalize_takes_a_nested_tree():
    """A nested mapping with tuple leaves (JAX's intermediates as plain
    dicts) flattens as JAX's tree flatten does."""
    tree = {"a": {"sn": {"spike_rate": (0.25, 0.5)},
                  "b": {"sn": {"spike_rate": (0.75,),
                               "membrane": ([[1.0, 2.0, 3.0]],)}}}}
    assert E.normalize_spike_rates(tree) == J.normalize_spike_rates(tree) \
        == {"a.sn": 0.5, "a.b.sn": 0.75}


def test_gradient_statistics_and_csv_equal_jax(tmp_path):
    """The same dyadic arrays as a JAX grads tree and as a torch module's
    .grad (one parameter without a gradient is left out)."""
    rng = np.random.default_rng(3)
    arrays = {"enc": {"weight": rng.integers(-8, 8, (4, 3)) / 8.0,
                      "bias": rng.integers(-8, 8, (3,)) / 4.0},
              "head": {"weight": rng.integers(-8, 8, (2, 2)) / 2.0}}
    model = torch.nn.Module()
    for mod, leaves in arrays.items():
        sub = torch.nn.Module()
        for leaf, a in leaves.items():
            p = torch.nn.Parameter(torch.from_numpy(a).float())
            p.grad = torch.from_numpy(a).float()
            sub.register_parameter(leaf, p)
        model.add_module(mod, sub)
    model.enc.register_parameter("unused", torch.nn.Parameter(torch.ones(2)))
    jtree = {m: {k: np.asarray(a, np.float32) for k, a in v.items()}
             for m, v in arrays.items()}
    got, want = G.get_grads(model), JG.get_grads(jtree)
    assert got == want and len(got) == 3
    rows = []
    for pkg, rec in ((G, got), (JG, want)):
        path = tmp_path / f"{pkg.__name__.split('.')[0]}.csv"
        pkg.save_grads_csv([rec, rec], str(path))
        with open(path) as f:
            rows.append(list(csv.reader(f)))
    assert rows[0] == rows[1] and len(rows[0]) == 3


def test_energy_sensitivity_prints_what_the_jax_script_prints(
        tmp_path, capsys, monkeypatch):
    path = tmp_path / "spike_rates.json"
    path.write_text(json.dumps(en4_rates(seed=4)))
    argv = [str(path), "--scales=0.5,1,3"]
    energy_sensitivity.main(argv)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["energy_sensitivity.py"] + argv)
    runpy.run_path(os.path.join(ROOT, "scripts", "energy_sensitivity.py"),
                   run_name="__main__")
    want = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 3


@pytest.fixture(scope="module")
def monitored_run(tmp_path_factory):
    """``eval_dsec.main`` on the tiny config with the four monitor flags:
    (run directory, returned results)."""
    root = tmp_path_factory.mktemp("eval")
    run, ckpt = str(root / "run"), str(root / "ckpt")
    # seeded random weights: the init's PSN bias of -1 leaves the tiny
    # model silent, which would make the rate checks vacuous
    config = load_config(TINY)
    model = get_model(config["model"]["name"], *build_configs(config))
    randomize_(model, torch.Generator().manual_seed(0))
    save_checkpoint(ckpt, model, torch.optim.SGD(model.parameters(), lr=0.0),
                    0, 0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        results = eval_dsec.main([
            "--train_config", TINY, "--ckpt", ckpt, "--synthetic",
            "--device", "cpu", "--max_batches", "1", "--run_dir", run,
            "--store_spike_rates", "--energy_report", "--store_membrane",
            "--log_attn"])
    finally:
        torch.set_num_threads(n)
    return run, results


def test_eval_dsec_monitors_write_the_jax_artefacts(monitored_run):
    run, results = monitored_run
    names = ("results.json", "spike_rates.json", "energy.json",
             "membrane_stats.json", "attention_maps.npz")
    assert all(os.path.exists(os.path.join(run, n)) for n in names)
    with open(os.path.join(run, "results.json")) as f:
        assert json.load(f) == results
    with open(os.path.join(run, "spike_rates.json")) as f:
        rates = json.load(f)
    with open(os.path.join(run, "membrane_stats.json")) as f:
        membrane = json.load(f)
    assert all(k.endswith("/spike_rate/[0]") for k in rates)
    assert {k.replace("/membrane/", "/spike_rate/") for k in membrane} \
        == set(rates)
    assert all(np.asarray(v).shape[1] == 3 for v in membrane.values())
    assert math.isclose(results["mean_firing_rate"],
                        float(np.mean(list(rates.values()))), rel_tol=REL)
    assert 0.0 < results["mean_firing_rate"] < 1.0
    model = load_config(TINY)
    depths = build_configs(model)[1].depths
    maps = np.load(os.path.join(run, "attention_maps.npz"))
    assert sorted(maps.files) == [f"stage{k}" for k in range(len(depths))]
    assert all(maps[f].shape[0] == 2 for f in maps.files)   # [wd, B_, ...]


def test_eval_dsec_energy_is_the_jax_join_of_its_rates(monitored_run):
    run, results = monitored_run
    with open(os.path.join(run, "spike_rates.json")) as f:
        rates = json.load(f)
    with open(os.path.join(run, "energy.json")) as f:
        energy = json.load(f)
    config = j_load_config(TINY)
    model_cfg, swin, spiking = j_build_configs(config)
    want = J.energy_spikingformer(
        swin, rates, num_steps=spiking.num_steps,
        base_channels=model_cfg.get("base_num_channels", 96),
        num_encoders=len(swin.out_indices), num_ch=2,
        kernel_size=model_cfg.get("kernel_size", 3))
    close(energy, json.loads(json.dumps(want)))
    assert results["energy_mj"] == energy["energy_mj"]
    assert results["snn_vs_ann_ratio"] == energy["snn_vs_ann_ratio"]
