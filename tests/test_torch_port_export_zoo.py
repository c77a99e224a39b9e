"""Exported programs of every model family on the CPU: the SEW
``SpikingformerFlowNet``, ``MS_SpikingformerFlowNet`` and
``SpikingMultiResUNet`` of the SNN zoo, and the ANN ``STTFlowNet`` (two
chunks a window, as the DSEC STT config) and ``STTFlowNet_4en``
(``tests/test_torch_port_export.py`` holds the en4).

Each family at a tiny size (96x128, 3 or 4 stages, narrow), every variable
randomized in float64 and crossed through ``from_jax``: the programs
``export_flow_model`` writes, reloaded by ``export_model.verify`` (which
requires them to equal the live step bit for bit), against JAX's
``training/export._eval_fn`` within 1e-9 of the largest flow, and the
graph's K1 / K2 / K3 op nodes against the eager step's kernel calls. The
SEW model also exports an events bucket; an STT config of two chunks
exports its voxel program at the chunk's bins and refuses event buckets.
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu.models import get_model as j_get_model
from sdformerflow_tpu.training.config import build_configs as j_build_configs
from sdformerflow_tpu.training.export import _eval_fn as j_eval_fn
from sdformerflow_tpu.training.train_step import TrainState
from sdformerflow_tpu_torch import export_model
from sdformerflow_tpu_torch.models import spiking_layers, spiking_swin
from sdformerflow_tpu_torch.training import train_step
from sdformerflow_tpu_torch.training.config import chunk_bins, load_config
from sdformerflow_tpu_torch.training.export import (build_inference_state,
                                                    export_flow_model,
                                                    step_kwargs)
from sdformerflow_tpu_torch.training.from_jax import from_jax

from test_torch_port_export import OPS, event_window
from torch_port_harness import randomize_tree
from torch_port_harness import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
CROP, SENSOR, BUCKET = (96, 128), (104, 136), 4096
TOL = 1e-9


def _config(path, name, **swin):
    config = load_config(os.path.join(ROOT, "configs", path))
    config["model"]["name"] = name
    config["swin_transformer"].update(swin)
    config["loader"]["crop"] = list(CROP)
    config["loader"]["resolution"] = list(SENSOR)
    return config


def snn(name, embed):
    config = _config("test_tiny_snn.yaml", name,
                     use_arc=["swinv1", embed], swin_depths=[1, 1, 1],
                     swin_num_heads=[2, 2, 4], swin_out_indices=[0, 1, 2])
    config["model"]["base_num_channels"] = 8
    return config


def ann(name, depths, chunks):
    config = _config("test_tiny_ann.yaml", name, swin_depths=depths,
                     swin_num_heads=[2] * len(depths),
                     swin_out_indices=list(range(len(depths))),
                     input_size=list(CROP))
    config["model"]["base_num_channels"] = 8
    config["data"]["num_chunks"] = chunks
    config["model"]["num_bins"] = chunk_bins(config)
    return config


# family -> (config, K1 and K2 sites of one forward)
FAMILIES = {
    "sew": (snn("SpikingformerFlowNet", "Spiking_PatchEmbed_Conv_sfn"),
            (0, 34)),
    "ms": (snn("MS_SpikingformerFlowNet", "MS_Spiking_PatchEmbed_Conv_sfn"),
           (3, 24)),
    "unet": (snn("SpikingMultiResUNet", "Spiking_PatchEmbed_Conv_sfn"),
             (0, 12)),
    "stt": (ann("STTFlowNet", [1, 1, 1], chunks=2), (0, 0)),
    "stt4": (ann("STTFlowNet_4en", [1, 1, 1, 1], chunks=1), (0, 0)),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request, tmp_path_factory):
    """One family on both sides from the same float64 variables, its
    programs exported and reloaded by ``export_model.verify``, and JAX's
    flow on one chunk."""
    config, sites = FAMILIES[request.param]
    bins = chunk_bins(config)
    jmodel = j_get_model(config["model"]["name"], *j_build_configs(config))
    chunk = np.random.default_rng(7).standard_normal(
        (1, bins) + CROP).astype(np.float32)
    polarity = "Spiking" in config["model"]["name"]
    with jax.enable_x64(True):
        shape = (1, bins) + ((2,) if polarity else ()) + CROP
        shapes = jax.eval_shape(lambda x: jmodel.init(
            jax.random.PRNGKey(0), x, False),
            jax.ShapeDtypeStruct(shape, jnp.float32))
        variables = randomize_tree(shapes, seed=11)
        state = TrainState(step=0, params=variables["params"],
                           batch_stats=variables.get("batch_stats", {}),
                           opt_state=(), apply_fn=jmodel.apply, tx=None)
        want = np.asarray(j_eval_fn(config, state, bf16=False,
                                    events=False)(jnp.asarray(chunk)))
    model = build_inference_state(config, device="cpu").double()
    model.load_state_dict(from_jax(variables, model))
    out = str(tmp_path_factory.mktemp(request.param))
    buckets = (BUCKET,) if request.param == "sew" else ()
    meta = export_flow_model(config, model, out, bf16=False, device="cpu",
                             event_buckets=buckets)
    errs, fns = export_model.verify(config, model, out, bf16=False)
    return dict(name=request.param, config=config, model=model, meta=meta,
                errs=errs, fns=fns, chunk=chunk, want=want, sites=sites)


def test_reloaded_programs_equal_the_live_step(family):
    """``export_model --verify``'s check: every artifact bit for bit."""
    names = {"voxel"} | ({f"events_{BUCKET}"} if family["name"] == "sew"
                         else set())
    assert family["errs"] == dict.fromkeys(names, 0.0)
    assert family["meta"]["artifacts"]["voxel"]["input"] == [
        1, chunk_bins(family["config"]), *CROP]


def test_reloaded_program_matches_jax_f64(family):
    got = family["fns"]["voxel"](torch.from_numpy(family["chunk"]))
    want = family["want"]
    # both steps return float32 flows of float64 forwards
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == want.shape == (1, 2) + CROP
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


def test_op_nodes_match_eager_kernel_calls(family, monkeypatch):
    """One K1 node a spiking-QK attention call, one K2 node a PSN site, one
    K3 node in the events program, as the eager step calls them."""
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
    inputs = {"voxel": torch.from_numpy(family["chunk"])}
    if family["name"] == "sew":
        inputs[f"events_{BUCKET}"] = event_window(3)
    for kind, x in inputs.items():
        calls.clear()
        events = kind != "voxel"
        step = train_step.make_eval_step(family["model"], **step_kwargs(
            family["config"], bf16=False, events=events))
        with torch.inference_mode():
            step(x)
        nodes = collections.Counter(
            str(n.target) for n in family["fns"][kind].program.graph.nodes)
        graph = {key: nodes[op] for key, op in OPS.items()}
        assert graph == {key: calls[key] for key in OPS}, (kind, graph)
        assert (graph["K1"], graph["K2"]) == family["sites"]
        assert graph["K3"] == int(events)


def test_two_chunk_config_refuses_event_buckets(tmp_path):
    config, _ = FAMILIES["stt"]
    model = build_inference_state(config, device="cpu")
    with pytest.raises(ValueError, match="num_chunks = 2"):
        export_flow_model(config, model, str(tmp_path), bf16=False,
                          device="cpu", event_buckets=(BUCKET,))
    assert not os.listdir(tmp_path)
