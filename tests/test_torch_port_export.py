"""The port's deployment surface on the CPU: the kernels as custom ops,
``training/export.py`` and ``export_model``.

The tiny SDformerFlow at 96x128 (every stage keeps an even window count,
so K1's op is in the graph), events at 104x136. Each artifact directory is
exported once per module. A reloaded program must equal the live eval step
bit for bit (the op's real implementation runs the same plain twin on the
CPU), hold one op node per eager kernel site, load in a process that has
imported no model code, and, in float64, match JAX's ``_eval_fn`` within
the tolerance of ``test_torch_port_model.py`` (1e-9 relative: float64
summation order only).
"""

import collections
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sdformerflow_tpu.models import get_model as j_get_model
from sdformerflow_tpu.training.config import build_configs as j_build_configs
from sdformerflow_tpu.training.export import _eval_fn as j_eval_fn
from sdformerflow_tpu.training.train_step import TrainState
from sdformerflow_tpu_torch import export_model
from sdformerflow_tpu_torch.models import spiking_layers, spiking_swin
from sdformerflow_tpu_torch.models.registry import randomize_
from sdformerflow_tpu_torch.ops import hopper_attn as A
from sdformerflow_tpu_torch.ops import hopper_psn as P
from sdformerflow_tpu_torch.ops import hopper_voxel as V
from sdformerflow_tpu_torch.training import train_step
from sdformerflow_tpu_torch.training.checkpoints import save_checkpoint
from sdformerflow_tpu_torch.training.config import load_config
from sdformerflow_tpu_torch.training.export import (build_inference_state,
                                                    cast_for,
                                                    export_flow_model,
                                                    load_exported,
                                                    step_kwargs)
from sdformerflow_tpu_torch.training.from_jax import from_jax
from sdformerflow_tpu_torch.training.train_step import make_eval_step

from torch_port_harness import randomize_tree
from torch_port_harness import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
CROP, SENSOR, BUCKET = (96, 128), (104, 136), 4096
OPS = {"K1": "sdformerflow_torch.qk_attn_interior.default",
       "K2": "sdformerflow_torch.fused_affine_psn.default",
       "K3": "sdformerflow_torch.voxelize_batch.default"}


def tiny_config():
    config = load_config(os.path.join(ROOT, "configs", "test_tiny_snn.yaml"))
    config["loader"]["crop"] = list(CROP)
    config["loader"]["resolution"] = list(SENSOR)
    return config


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """The tiny config, its seeded model saved as a trainer checkpoint, the
    f32 and bf16 artifacts (voxel + one events bucket) written by the
    ``export_model`` CLI, and both reloaded by its ``verify`` (what
    ``--verify`` runs), which holds each against the live step."""
    root = tmp_path_factory.mktemp("export")
    config = tiny_config()
    path = str(root / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    model = build_inference_state(config, device="cpu")
    randomize_(model, torch.Generator().manual_seed(0))
    ckpt = str(root / "ckpt")
    save_checkpoint(ckpt, model, torch.optim.SGD(model.parameters(), lr=0),
                    epoch=0, step=0)
    metas, errs, fns, live = {}, {}, {}, {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        metas[name] = export_model.main(
            ["--train_config", path, "--ckpt", ckpt, "--out",
             str(root / name), "--device", "cpu", "--event_buckets",
             str(BUCKET)] + ([] if bf16 else ["--no_bf16"]))
        errs[name], fns[name] = export_model.verify(config, model,
                                                    str(root / name), bf16)
        # the steps FlowServer runs, over one cast copy of the model
        cast = cast_for(model, bf16)
        live[name] = {kind: make_eval_step(cast, **step_kwargs(
            config, bf16=bf16, events=kind == "events"))
            for kind in ("voxel", "events")}
    return dict(config=config, model=model, ckpt=ckpt, root=root,
                metas=metas, errs=errs, fns=fns, live=live)


@pytest.fixture(scope="module")
def s2d_export(exports, tmp_path_factory):
    """The checkpoint's s2d re-expression exported (f32, voxel) and
    reloaded."""
    out = str(tmp_path_factory.mktemp("s2d"))
    model = build_inference_state(exports["config"], exports["ckpt"],
                                  s2d=True, device="cpu")
    export_flow_model(exports["config"], model, out, bf16=False,
                      device="cpu")
    return dict(model=model, out=out, fns=load_exported(out)[1])


def sparse_chunk(seed):
    rng = np.random.default_rng(seed)
    shape = (1, 10) + CROP
    return torch.from_numpy((rng.standard_normal(shape)
                             * (rng.random(shape) < 0.3)).astype(np.float32))


def event_window(seed, n=3000):
    """One row of ``n`` valid events at sensor size (some outside the
    frame) in a bucket of BUCKET slots."""
    rng = np.random.default_rng(seed)
    h, w = SENSOR
    ev = {"x": rng.uniform(-1, w, BUCKET), "y": rng.uniform(-1, h, BUCKET),
          "t": np.sort(rng.uniform(0, 0.1, BUCKET)),
          "p": rng.integers(0, 2, BUCKET)}
    out = {k: torch.from_numpy(v.astype(np.float32))[None]
           for k, v in ev.items()}
    out["valid"] = (torch.arange(BUCKET) < n)[None]
    return out


def test_export_cli_meta_and_verify(exports):
    for name, meta in exports["metas"].items():
        assert exports["errs"][name] == {"voxel": 0.0,
                                         f"events_{BUCKET}": 0.0}
        with open(exports["root"] / name / "export_meta.json") as f:
            on_disk = json.load(f)
        assert on_disk == meta
        assert on_disk["device"] == "cpu" and on_disk["batch"] == 1
        assert on_disk["bf16"] == (name == "bf16")
        assert on_disk["crop"] == list(CROP)
        assert on_disk["resolution"] == list(SENSOR)
        assert on_disk["artifacts"] == {
            "voxel": {"input": [1, 10, *CROP], "dtype": "float32"},
            f"events_{BUCKET}": {"input": {"x/y/t/p": [1, BUCKET],
                                           "valid": [1, BUCKET]}}}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["voxel", "events"])
def test_reloaded_artifact_equals_live_step(exports, dtype, kind):
    """The reloaded program against the step FlowServer runs
    (``make_eval_step`` with the config's keywords), bit for bit."""
    fn = exports["fns"][dtype]["voxel" if kind == "voxel"
                               else f"events_{BUCKET}"]
    step = exports["live"][dtype][kind]
    x = sparse_chunk(1) if kind == "voxel" else event_window(1)
    got = fn(x)
    assert got.dtype == torch.float32 and got.shape == (1, 2, *CROP)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    assert torch.equal(got, step(x)[-1])


def test_op_nodes_match_eager_kernel_sites(exports, monkeypatch):
    """The exported graph holds K1 once per attention block, K2 once per
    PSN site and K3 once in the events program: as many as the eager step
    makes kernel calls (counted at the model's call sites)."""
    calls = collections.Counter()

    def counted(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(spiking_swin, "fused_qk_attention",
                        counted("K1", spiking_swin.fused_qk_attention))
    monkeypatch.setattr(spiking_layers, "affine_psn",
                        counted("K2", spiking_layers.affine_psn))
    monkeypatch.setattr(train_step, "voxel_batch_signed",
                        counted("K3", train_step.voxel_batch_signed))
    blocks = sum(isinstance(m, spiking_swin.SpikingQKWindowAttention3D)
                 for m in exports["model"].modules())
    for kind, x in (("voxel", sparse_chunk(3)),
                    (f"events_{BUCKET}", event_window(3))):
        calls.clear()
        exports["live"]["bf16"]["voxel" if kind == "voxel" else "events"](x)
        program = exports["fns"]["bf16"][kind].program
        nodes = collections.Counter(str(n.target)
                                    for n in program.graph.nodes)
        graph = {key: nodes[op] for key, op in OPS.items()}
        assert graph == {key: calls[key] for key in OPS}, (kind, graph)
        assert graph["K1"] == blocks == 4 and graph["K2"] == 29
        assert graph["K3"] == (kind != "voxel")


def test_fresh_process_loads_without_model_code(s2d_export, tmp_path):
    """``load_exported`` in a new interpreter that imports only
    ``training/export.py``: no module of ``models`` (nor the server, nor
    jax) is imported, and its flow equals the live step's."""
    chunk = sparse_chunk(4)
    torch.save(chunk, tmp_path / "chunk.pt")
    probe = textwrap.dedent(f"""
        import sys, torch
        from sdformerflow_tpu_torch.training.export import load_exported
        meta, fns = load_exported({s2d_export["out"]!r})
        chunk = torch.load({str(tmp_path / "chunk.pt")!r})
        torch.save(fns["voxel"](chunk), {str(tmp_path / "out.pt")!r})
        print(sorted(m for m in sys.modules
                     if m.startswith(("sdformerflow_tpu_torch.models",
                                      "sdformerflow_tpu_torch.serving",
                                      "jax", "sdformerflow_tpu."))))
    """)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, check=True)
    assert out.stdout.split() == ["[]"], out.stdout
    step = make_eval_step(s2d_export["model"], **step_kwargs(
        tiny_config(), bf16=False, events=False))
    assert torch.equal(torch.load(tmp_path / "out.pt"), step(chunk)[-1])


def test_s2d_export_round_trips(s2d_export):
    model = s2d_export["model"]
    assert model.sttmultires_unet.encoders.patch_embed.s2d
    step = make_eval_step(model, **step_kwargs(tiny_config(), bf16=False,
                                               events=False))
    x = sparse_chunk(5)
    got = s2d_export["fns"]["voxel"](x)
    assert torch.isfinite(got).all() and torch.equal(got, step(x)[-1])
    program = s2d_export["fns"]["voxel"].program
    assert sum(str(n.target) == OPS["K1"] for n in program.graph.nodes) == 4


def test_traced_and_reloaded_kernels_stay_forward_only(exports):
    """Tracing with gradients on raises at K1's guard; a reloaded program
    run outside inference mode refuses the backward through its ops."""
    from sdformerflow_tpu_torch.training.export import _eval_fn
    fn = _eval_fn(exports["config"], exports["model"], bf16=False,
                  events=False)
    with pytest.raises(NotImplementedError, match="forward-only"):
        torch.export.export(fn, (sparse_chunk(6),))
    program = exports["fns"]["f32"]["voxel"].program
    flow = program.module()(sparse_chunk(6))
    with pytest.raises(RuntimeError, match="no autograd formula"):
        flow.sum().backward()


def test_artifact_matches_jax_f64(tmp_path):
    """Float64 on both sides, every variable randomized and crossed through
    ``from_jax``: the port's reloaded voxel artifact against JAX's
    ``training/export._eval_fn`` (its module attention, the port's K1 op
    running its plain twin), both fed the same float32 chunk."""
    config = tiny_config()
    name = config["model"]["name"]
    jmodel = j_get_model(name, *j_build_configs(config))
    chunk = np.random.default_rng(7).standard_normal(
        (1, 10) + CROP).astype(np.float32)
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda x: jmodel.init(
            jax.random.PRNGKey(0), x, False),
            jax.ShapeDtypeStruct((1, 10, 2) + CROP, jnp.float32))
        variables = randomize_tree(shapes, seed=11)
        state = TrainState(step=0, params=variables["params"],
                           batch_stats=variables["batch_stats"], opt_state=(),
                           apply_fn=jmodel.apply, tx=None)
        want = np.asarray(j_eval_fn(config, state, bf16=False,
                                    events=False)(jnp.asarray(chunk)))
    model = build_inference_state(config, device="cpu").double()
    model.load_state_dict(from_jax(variables, model))
    export_flow_model(config, model, str(tmp_path), bf16=False, device="cpu")
    _, fns = load_exported(str(tmp_path))
    assert sum(str(n.target) == OPS["K1"]
               for n in fns["voxel"].program.graph.nodes) == 4
    got = fns["voxel"](torch.from_numpy(chunk)).numpy()
    assert got.shape == want.shape == (1, 2) + CROP
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())


def _k1_inputs(dtype):
    g = torch.Generator().manual_seed(0)
    C, nh = 8, 2
    x = torch.randn(2, 4, 3, 3, C, generator=g).to(dtype)
    r = lambda *s: 0.3 * torch.randn(*s, generator=g)  # noqa: E731
    # PSN mixes near the identity and thresholds near 0: every site fires
    psn = lambda: (torch.eye(2) + r(2, 2), r(2) - 0.3)  # noqa: E731
    params = [*psn(), r(C, C) * 3, 1 + r(C), r(C), *psn(), r(C, C) * 3,
              1 + r(C), r(C), r(2, 9, C), *psn(), *psn()]
    assert len(params) == A.N_INTERIOR
    return (x, params, nh)


def _k2_inputs(affine, out_dtype):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(10, 3, 5, 8, generator=g)
    scale, shift = ((torch.rand(8, generator=g) + 0.5,
                     torch.randn(8, generator=g)) if affine else (None, None))
    return (x, 0.3 * torch.randn(10, 10, generator=g),
            torch.randn(10, 1, generator=g), scale, shift, out_dtype)


def _k3_inputs():
    rng = np.random.default_rng(2)
    B, N, h, w = 2, 64, 6, 10
    ev = [rng.uniform(-1, w, (B, N)), rng.uniform(-1, h, (B, N)),
          np.sort(rng.uniform(0, 1, (B, N)), axis=1),
          rng.integers(0, 2, (B, N))]
    ev = [torch.from_numpy(v.astype(np.float32)) for v in ev]
    return (*ev, torch.from_numpy(rng.random((B, N)) < 0.8), 5, h, w)


@pytest.mark.parametrize("op, make", [
    ("K1", lambda: _k1_inputs(torch.float32)),
    ("K1", lambda: _k1_inputs(torch.bfloat16)),
    ("K2", lambda: _k2_inputs(True, torch.float32)),
    ("K2", lambda: _k2_inputs(False, torch.bfloat16)),
    ("K3", _k3_inputs),
], ids=["K1-f32", "K1-bf16", "K2-affine", "K2-bf16-out", "K3"])
def test_opcheck(op, make):
    """torch.library.opcheck on CPU inputs: the schema (no aliasing, no
    mutation), the fake form against the real one, and the dispatch
    through aot_autograd."""
    target = {"K1": A.qk_attn_interior_op, "K2": P.fused_affine_psn_op,
              "K3": V.voxel_batch_signed_op}[op]
    args = make()
    out = target(*args)
    shape = {"K1": (2, 4, 9, 8), "K2": (10, 3, 5, 8),
             "K3": (2, 5, 6, 10)}[op]
    assert out.shape == shape and out.abs().sum() > 0
    result = torch.library.opcheck(target, args)
    assert set(result.values()) == {"SUCCESS"}, result
