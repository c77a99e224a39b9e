"""PyTorch port vs the JAX package: the SNN zoo's train step, BN folding,
reference names and entry points, float64, on the tiny zoo geometry of
``torch_port_harness.zoo_pair`` (T = 4, base 8, 32x32, drop-path off).

- A 2-step SGD trajectory of the SEW SpikingformerFlowNet (PSN + BN, its
  PSN sites the fused site's plain twins on the CPU) through the port's
  train step against the JAX model's steps (the JAX package's loss and
  SGD): each loss to 1e-9, every parameter and running statistic after
  each step to 1e-10 (relative, and absolute: the swin-v1 bias tables
  with no softmax give activation variances to ~3e5); the parameters
  trained (every one with a gradient) are those JAX's AdamW decay mask
  decays.
- ``fold_model`` of a SEW model (TDBN, whose BN sites fold) against JAX's
  ``fold_model_and_variables`` forward (1e-9 of the largest flow), and
  ``from_jax`` of JAX's ``fold_bn_variables`` tree of a BNTT model (whose
  per-step norms stay) against ``fold_model``'s state_dict.
- The reference-name round trip of each new model (``to_reference_state_dict``
  then ``load_reference_state_dict``), the names also read by JAX's rules.
- ``train_dsec`` (2 steps), ``eval_dsec`` and ``FlowServer`` run the three
  new registry names with no other change.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from sdformerflow_tpu import losses as j_losses
from sdformerflow_tpu.ops.normalization import encode_input as j_encode
from sdformerflow_tpu.training import optim as j_optim
from sdformerflow_tpu.training import torch_interop as j_interop
from sdformerflow_tpu.training.bn_folding import (fold_bn_variables,
                                                  fold_model_and_variables)
from sdformerflow_tpu_torch import eval_dsec, train_dsec
from sdformerflow_tpu_torch.models.registry import randomize_
from sdformerflow_tpu_torch.models.spiking_layers import (FoldedNorm,
                                                          SpikingNorm)
from sdformerflow_tpu_torch.ops.normalization import encode_input
from sdformerflow_tpu_torch.serving import FlowServer
from sdformerflow_tpu_torch.training import optim
from sdformerflow_tpu_torch.training.bn_folding import fold_model
from sdformerflow_tpu_torch.training.from_jax import from_jax
from sdformerflow_tpu_torch.training.torch_interop import (
    load_reference_state_dict, to_reference_state_dict)
from sdformerflow_tpu_torch.training.train_step import make_train_step

from torch_port_harness import init_pair, to_torch, zoo_pair
from torch_port_zoo_cases import one_torch_thread, rel  # noqa: F401

GEO = dict(num_bins=4, size=(32, 32))
OPT = dict(name="SGD", lr=1e-2, scheduler="multistep", milestones=[1],
           steps_per_epoch=2, clip_grad=100.0)


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    shape = (1, GEO["num_bins"]) + GEO["size"]
    return [dict(chunk=rng.standard_normal(shape) * (rng.random(shape) < 0.4),
                 label=3.0 * rng.standard_normal((1, 2) + GEO["size"]),
                 mask=(rng.random((1, 1) + GEO["size"]) > 0.2) * 1.0)
            for _ in range(n)]


@pytest.fixture(scope="module")
def sew_jax():
    """Randomized variables of the tiny SEW pair and two JAX train steps
    (one compile): each step's loss and the state after it."""
    jmodel, tmodel = zoo_pair("SpikingformerFlowNet", depths=(2, 1, 1))
    batches = _batches(2, seed=51)
    tx = j_optim.build_optimizer(**OPT)
    encode = lambda c: j_encode(jnp.asarray(c))  # noqa: E731
    with jax.enable_x64(True):
        x0 = np.asarray(encode(batches[0]["chunk"]))
    variables = init_pair(jmodel, tmodel, x0, seed=53)
    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(jnp.asarray, variables)

        @jax.jit
        def step(params, stats, opt_state, x, label, mask):
            def loss_fn(p):
                out, mut = jmodel.apply(
                    {"params": p, "batch_stats": stats}, x, True,
                    mutable=["batch_stats"])
                return (j_losses.flow_loss_supervised(out["flow"], label,
                                                      mask),
                        mut["batch_stats"])

            (loss, stats), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            upd, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, upd), stats, opt_state, loss

        params, stats, opt_state = v["params"], v["batch_stats"], \
            tx.init(v["params"])
        steps = []
        for b in batches:
            params, stats, opt_state, loss = step(
                params, stats, opt_state, encode(b["chunk"]),
                jnp.asarray(b["label"]), jnp.asarray(b["mask"]))
            steps.append(dict(loss=float(loss), after=jax.tree_util.tree_map(
                np.asarray, {"params": params, "batch_stats": stats})))
    return dict(tmodel=tmodel, batches=batches, steps=steps)


def test_sew_train_trajectory_matches_jax_f64(sew_jax):
    model = sew_jax["tmodel"]
    opt = optim.build_optimizer(model.named_parameters(), **OPT)
    step = make_train_step(model, opt)
    for b, want in zip(sew_jax["batches"], sew_jax["steps"]):
        loss = step({k: to_torch(v) for k, v in b.items()})["loss"]
        np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-9)
        after = from_jax(want["after"], model)
        for k, val in model.state_dict().items():
            np.testing.assert_allclose(val.numpy(), after[k].numpy(),
                                       rtol=1e-10, atol=1e-10, err_msg=k)
    assert int(opt.count) == 2
    # JAX's AdamW decays every leaf outside attn_sn (the SEW model has
    # none): the port trains every parameter
    assert opt.names == [n for n, _ in model.named_parameters()]


def test_ms_flownet_trains_all_but_attn_sn():
    """The parameters the port trains (those with a gradient) are the ones
    JAX's AdamW decay mask decays: all but the attention-telemetry
    neuron's."""
    _, model = zoo_pair("MS_SpikingformerFlowNet")
    randomize_(model.double(), torch.Generator().manual_seed(1))
    opt = optim.build_optimizer(model.named_parameters(), lr=1e-3)
    b = _batches(1, seed=3)[0]
    make_train_step(model, opt)({k: to_torch(v) for k, v in b.items()})
    names = [n for n, _ in model.named_parameters()]
    assert opt.names == [n for n in names if ".attn_sn." not in n]
    assert len(opt.names) < len(names)


def _flows(model, chunk):
    with torch.no_grad():
        return model(encode_input(to_torch(chunk)))["flow"]


def test_fold_model_of_sew_matches_jax_f64():
    jmodel, tmodel = zoo_pair("SpikingformerFlowNet", spike_norm="TDBN",
                              depths=(2, 1, 1))
    chunk = np.random.default_rng(7).standard_normal((1, 4, 32, 32))
    with jax.enable_x64(True):
        x_enc = np.asarray(j_encode(jnp.asarray(chunk)))
    variables = init_pair(jmodel, tmodel, x_enc, seed=9)
    with jax.enable_x64(True):
        jfold, vfold = fold_model_and_variables(jmodel, variables)
        want = jax.jit(lambda v, z: jfold.apply(v, z, False)["flow"])(
            vfold, jnp.asarray(x_enc))
    folded = fold_model(tmodel.eval())
    assert folded.cfg.fold_bn
    sd = folded.state_dict()
    assert not any("running" in k for k in sd)
    for g, w in zip(_flows(folded, chunk), want):
        assert rel(g.numpy(), w) <= 1e-9
    for g, w in zip(_flows(folded, chunk), _flows(tmodel, chunk)):
        assert rel(g.numpy(), w.numpy()) <= 1e-9
    # the port model built folded loads JAX's folded tree: fold_model's
    _, built = zoo_pair("SpikingformerFlowNet", spike_norm="TDBN",
                        depths=(2, 1, 1), fold_bn=True)
    got = from_jax(jax.tree_util.tree_map(np.asarray, vfold), built)
    assert set(got) == set(sd)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=k)


def test_fold_model_keeps_bntt_as_jax_does():
    """BNTT is no running-statistics affine: its sites stay, the plain BN
    of the residual blocks and embedding layers fold; the state_dict is
    JAX's folded tree's."""
    jmodel, tmodel = zoo_pair("SpikingformerFlowNet", spike_norm="BNTT")
    variables = init_pair(jmodel, tmodel, np.zeros((1, 4, 2, 32, 32)),
                          seed=11)
    folded = fold_model(tmodel)
    kinds = {type(m).__name__ for m in folded.modules()}
    assert {"FoldedNorm", "SpikingNorm"} <= kinds
    assert all(m.norm == "BNTT" for m in folded.modules()
               if isinstance(m, SpikingNorm))
    assert any(isinstance(m, FoldedNorm) for m in folded.modules())
    _, built = zoo_pair("SpikingformerFlowNet", spike_norm="BNTT",
                        fold_bn=True)
    with jax.enable_x64(True):
        vfold = jax.tree_util.tree_map(np.asarray,
                                       fold_bn_variables(variables))
    got = from_jax(vfold, built)
    sd = folded.state_dict()
    assert set(got) == set(sd)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=k)


ROUND_TRIP = {
    "sew-plif": ("SpikingformerFlowNet", dict(neuron_type="plif"), {}),
    "sew-glif-upsample": ("SpikingformerFlowNet",
                          dict(neuron_type="glif"),
                          {"use_upsample_conv": True}),
    "ms": ("MS_SpikingformerFlowNet",
           dict(patch_embed_type="MS_PED_Spiking_PatchEmbed_Conv_sfn"), {}),
    "unet": ("SpikingMultiResUNet", {}, {}),
    "unet-ms-transpose": ("SpikingMultiResUNet", {},
                          {"ms": True, "use_upsample_conv": False}),
}


def _jax_rules(name, model_cfg, tmodel):
    if name == "SpikingMultiResUNet":
        return j_interop.build_unet_rules(
            num_encoders=4, use_upsample_conv=model_cfg.get(
                "use_upsample_conv", True))
    return j_interop.build_rules(num_stages=3, max_depth=1,
                                 num_encoders=3)


@pytest.mark.parametrize("case", sorted(ROUND_TRIP))
def test_reference_names_round_trip(case):
    """Port -> reference names -> port is the identity; JAX's rules read
    the same reference state_dict into the same tree (through
    ``from_jax``), where they cover the layout (JAX names a upsample-conv
    decoder's kernel as a transposed one)."""
    name, kw, model_cfg = ROUND_TRIP[case]
    _, model = zoo_pair(name, model_cfg=model_cfg, **kw)
    randomize_(model, torch.Generator().manual_seed(4))
    ref = to_reference_state_dict(model)
    assert len(ref) == len(model.state_dict())
    _, fresh = zoo_pair(name, model_cfg=model_cfg, **kw)
    state, unmatched = load_reference_state_dict(
        {k: v.numpy() for k, v in ref.items()}, fresh)
    assert not unmatched
    want = model.state_dict()
    assert set(state) == set(want)
    assert all(torch.equal(state[k], want[k]) for k in want)
    if model_cfg.get("use_upsample_conv") and name != "SpikingMultiResUNet":
        return
    params, stats, unmatched = j_interop.convert_with_rules(
        {k: v.numpy() for k, v in ref.items()},
        _jax_rules(name, model_cfg, model))
    assert not unmatched
    got = from_jax({"params": params, "batch_stats": stats}, fresh)
    assert all(torch.equal(got[k], want[k]) for k in want)


TINY = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                    "test_tiny_snn.yaml")


@pytest.mark.parametrize("name,extra", [
    ("SpikingformerFlowNet", dict(patch_embed="Spiking_PatchEmbed_Conv_sfn")),
    ("MS_SpikingformerFlowNet", {}),
    ("SpikingMultiResUNet", dict(neuron_type="lif")),
])
def test_entry_points_run_the_new_names(tmp_path, name, extra):
    """``train_dsec`` 2 steps, ``eval_dsec`` on its checkpoint and
    ``FlowServer`` on a config of the tiny one with ``model.name`` set
    (3 stages for the flownets): finite losses, metrics and flows."""
    with open(TINY) as f:
        config = yaml.safe_load(f)
    config["model"]["name"] = name
    config["model"]["base_num_channels"] = 8
    sw = config["swin_transformer"]
    sw["use_arc"][1] = extra.get("patch_embed", sw["use_arc"][1])
    for key in ("swin_depths", "swin_num_heads", "swin_out_indices"):
        sw[key] = sw[key][:3]
    config["spiking_neuron"]["neuron_type"] = extra.get("neuron_type", "psn")
    path = str(tmp_path / "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    run = str(tmp_path / "run")
    model, opt = train_dsec.main(["--config", path, "--synthetic",
                                  "--device", "cpu", "--max_steps", "2",
                                  "--run_dir", run])
    assert type(model).__name__ == ("SpikingMultiResUNetFlow"
                                    if name == "SpikingMultiResUNet"
                                    else "SpikingformerFlowNet")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert all(np.isfinite(r["value"]) for r in recs)
    out = str(tmp_path / "eval")
    eval_dsec.main(["--train_config", path, "--ckpt",
                    os.path.join(run, "ckpt"), "--synthetic", "--device",
                    "cpu", "--run_dir", out])
    with open(os.path.join(out, "results.json")) as f:
        assert np.isfinite(json.load(f)["AEE"])
    state = copy.deepcopy(model.state_dict())
    chunk = np.random.default_rng(0).standard_normal(
        (10, 48, 64)).astype(np.float32)
    with FlowServer(config, state, device="cpu", bf16=False) as srv:
        flow = srv.infer(chunk)
    assert flow.shape == (2, 48, 64) and np.isfinite(flow).all()
