"""PyTorch port vs the JAX package: the rest of the train slice and the
re-expressions.

- The rotation augmentation (``data/augmentation.py:rotate_flip``) against
  JAX ``rotation_flip`` at fixed angles and mirrors, float64: events and
  flow to 1e-12; the mask, which both sample in float32, to 1e-6.
- ``parallel/mesh.py``: the four cases of ``tests/test_prefetch.py`` on the
  port's ``host_prefetch``, and ``prefetch_to_device`` on the CPU.
- BN folding (``training/bn_folding.py``), float64, on the tiny en4 of
  ``configs/test_tiny_snn.yaml`` (base 32, depths (1, 1, 1, 1), MLP ratio
  2, T = 10) at 32x48: the port's folded eval forward against JAX's
  ``fold_model_and_variables`` forward (rtol 1e-9 of the largest flow),
  the port folded against the port unfolded, ``from_jax`` of JAX's folded
  tree against ``fold_model``'s weights, and a BN with no partner raising.
- ``cfg.s2d_train`` against JAX ``s2d_train`` on the tiny geometry of
  ``test_torch_port_model.py`` (T = 4, drop-path off), float64: the
  train-mode forward, the running statistics and every gradient (each to
  rtol 1e-9, or 1e-9 of the largest gradient: some leaves' true gradients
  are float64 noise), the eval forward, a 3-step SGD trajectory of the
  port's train step against the JAX model's steps (its loss and SGD, one
  compile for the forward, the gradients and the trajectory), the state_dict
  of the base model, and ``s2d_embed`` refused.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdformerflow_tpu import losses as j_losses
from sdformerflow_tpu.data import augmentation as j_aug
from sdformerflow_tpu.ops.normalization import encode_input as j_encode
from sdformerflow_tpu.training import optim as j_optim
from sdformerflow_tpu.training.bn_folding import fold_model_and_variables
from sdformerflow_tpu_torch.data import augmentation as aug
from sdformerflow_tpu_torch.losses import flow_loss_supervised
from sdformerflow_tpu_torch.models.spiking_layers import FoldedNorm
from sdformerflow_tpu_torch.ops.normalization import encode_input
from sdformerflow_tpu_torch.parallel.mesh import (host_prefetch,
                                                  prefetch_to_device)
from sdformerflow_tpu_torch.training import optim
from sdformerflow_tpu_torch.training.bn_folding import fold_model
from sdformerflow_tpu_torch.training.from_jax import from_jax
from sdformerflow_tpu_torch.training.train_step import (make_eval_step,
                                                        make_train_step)

from test_torch_port_model import GEOMETRIES
from test_torch_port_train import _voxel_batches
from torch_port_harness import flownet_pair, init_pair, to_torch
from torch_port_harness import one_torch_thread  # noqa: F401

TINY_CONFIG = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                           "test_tiny_snn.yaml")
# configs/test_tiny_snn.yaml's model at 32x48
TINY_EN4 = dict(size=(32, 48), depths=(1, 1, 1, 1), heads=(2, 2, 4, 4),
                window=(2, 3, 3), num_steps=10, num_bins=10, base=32,
                mlp_ratio=2.0)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# ------------------------------------------------------------- rotation

@pytest.mark.parametrize("angle,hflip,vflip", [(17.0, False, False),
                                               (-33.5, True, False),
                                               (90.0, True, True),
                                               (5.0, False, True)])
def test_rotate_flip_matches_jax_f64(angle, hflip, vflip):
    rng = np.random.default_rng(int(angle) + 100)
    ev = rng.standard_normal((2, 3, 10, 14))
    fl = rng.standard_normal((2, 2, 10, 14))
    mk = (rng.random((2, 1, 10, 14)) > 0.3) * 1.0
    with jax.enable_x64(True):
        # degrees (a, a) and p 1 or 0 fix JAX's draws
        want = j_aug.rotation_flip(
            jax.random.PRNGKey(0), jnp.asarray(ev), jnp.asarray(fl),
            jnp.asarray(mk), degrees=(angle, angle), p_hflip=float(hflip),
            p_vflip=float(vflip))
    got = aug.rotate_flip(to_torch(ev), to_torch(fl), to_torch(mk), angle,
                          hflip, vflip)
    for g, w, tol in zip(got, want, (1e-12, 1e-12, 1e-6)):
        assert g.shape == w.shape and str(g.dtype)[6:] == str(w.dtype)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol)
    assert np.abs(np.asarray(want[0])).max() > 0.5


def test_rotation_runs_first_with_its_draws():
    """``Rotation`` in the config draws (angle, h, v) from the generator
    before the crop's draws, and rotates the uncropped frame."""
    rng = np.random.default_rng(9)
    ev, fl = (to_torch(rng.standard_normal(s))
              for s in ((1, 2, 12, 16), (1, 2, 12, 16)))
    mk = torch.ones(1, 1, 12, 16)
    apply = aug.build_train_augmentation(["Rotation"], [0.5], crop=(8, 8),
                                         rotation_degrees=(-20.0, 20.0))
    gen = torch.Generator().manual_seed(4)
    got = apply(gen, ev, fl, mk)
    gen = torch.Generator().manual_seed(4)
    u = torch.rand(3, generator=gen, dtype=torch.float64).tolist()
    i = int(torch.randint(0, 12 - 8 + 1, (), generator=gen))
    j = int(torch.randint(0, 16 - 8 + 1, (), generator=gen))
    want = aug.crop_at(*aug.rotate_flip(ev, fl, mk, -20.0 + 40.0 * u[0],
                                        u[1] < 0.5, u[2] < 0.5),
                       i, j, (8, 8))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------------- prefetch

def test_prefetch_yields_all_items_in_order():
    items = list(range(57))
    assert list(host_prefetch(iter(items), size=2)) == items


def test_prefetch_producer_exception_reraises_in_consumer():
    def gen():
        yield 1
        yield 2
        raise ValueError("producer broke")

    out = []
    with pytest.raises(ValueError, match="producer broke"):
        for x in host_prefetch(gen(), size=2):
            out.append(x)
    assert out == [1, 2]


def test_prefetch_early_break_stops_producer_promptly():
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = host_prefetch(gen(), size=2)
    for x in it:
        if x == 3:
            break
    it.close()  # sets the stop flag
    time.sleep(0.3)
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n
    assert n < 20  # the bounded queue kept it from running ahead


def test_prefetch_overlaps_producer_and_consumer():
    n, d = 8, 0.05

    def gen():
        for i in range(n):
            time.sleep(d)
            yield np.full((4,), i)

    t0 = time.time()
    for _ in host_prefetch(gen(), size=2):
        time.sleep(d)
    elapsed = time.time() - t0
    assert elapsed < 1.6 * n * d, elapsed   # serial: ~2 n d


def test_prefetch_to_device_keeps_batches_and_order():
    batches = [{"chunk": np.full((2, 3), i, np.float32),
                "events": {"x": np.arange(4) + i}} for i in range(5)]
    it = prefetch_to_device(iter(batches), "cpu")
    got = list(it)
    assert len(got) == 5
    for i, b in enumerate(got):
        assert torch.equal(b["chunk"], torch.full((2, 3), float(i)))
        assert torch.equal(b["events"]["x"], torch.arange(4) + i)
    it = prefetch_to_device(iter(batches), "cpu")
    assert int(next(it)["chunk"][0, 0]) == 0
    it.close()


# -------------------------------------------------------------- folding

@pytest.fixture(scope="module")
def folded_pair():
    """The tiny en4 pair, randomized float64 variables, JAX's folded
    variables and the JAX folded forward's flows on one chunk."""
    jmodel, tmodel = flownet_pair(**TINY_EN4)
    rng = np.random.default_rng(3)
    chunk = rng.standard_normal((1, 10) + TINY_EN4["size"])
    with jax.enable_x64(True):
        x_enc = np.asarray(j_encode(jnp.asarray(chunk)))
        variables = init_pair(jmodel, tmodel, x_enc, seed=5)
        jfold, vfold = fold_model_and_variables(jmodel, variables)
        want = jax.jit(lambda v, z: jfold.apply(v, z, False)["flow"])(
            vfold, jnp.asarray(x_enc))
    return dict(tmodel=tmodel, chunk=chunk,
                vfold=jax.tree_util.tree_map(np.asarray, vfold),
                want=[np.asarray(w) for w in want])


def _flows(model, chunk):
    with torch.no_grad():
        return model(encode_input(to_torch(chunk)))["flow"]


def test_folded_forward_matches_jax_f64(folded_pair):
    folded = fold_model(folded_pair["tmodel"])
    assert folded.cfg.fold_bn and not folded_pair["tmodel"].cfg.fold_bn
    got = _flows(folded, folded_pair["chunk"])
    assert len(got) == len(folded_pair["want"]) == 4
    for g, w in zip(got, folded_pair["want"]):
        assert g.dtype == torch.float64 and np.abs(w).max() > 0
        assert _rel(g.numpy(), w) <= 1e-9


def test_fold_model_matches_unfolded_f64(folded_pair):
    model = folded_pair["tmodel"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    folded = fold_model(model)
    # the original is untouched; no BN entry is left in the copy
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in before.items())
    sd = folded.state_dict()
    assert not any("running" in k or "BatchNorm_0" in k for k in sd)
    norms = [m for m in folded.modules() if isinstance(m, FoldedNorm)]
    # per block: q, k, proj_bn, bn1, bn2; per merge 1; embed: head, conv,
    # 2 x 2 resblock norms, proj; 2 x 2 resblock; 4 decoders
    assert len(norms) == 4 * 5 + 3 + 7 + 4 + 4
    want = _flows(model.eval(), folded_pair["chunk"])
    for g, w in zip(_flows(folded.eval(), folded_pair["chunk"]), want):
        assert _rel(g.numpy(), w.numpy()) <= 1e-9
    # the fused embed (K4 / K4a's twins) takes the folded convs' biases
    chunk = to_torch(folded_pair["chunk"])
    fused = make_eval_step(folded, fused_embed=True, num_steps=10)(chunk)
    for g, w in zip(fused, make_eval_step(folded)(chunk)):
        assert _rel(g.numpy(), w.numpy()) <= 1e-9


def test_from_jax_carries_a_folded_tree(folded_pair):
    _, built = flownet_pair(**TINY_EN4, fold_bn=True)
    built.double().load_state_dict(from_jax(folded_pair["vfold"], built))
    want = fold_model(folded_pair["tmodel"]).state_dict()
    got = built.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    for g, w in zip(_flows(built, folded_pair["chunk"]), folded_pair["want"]):
        assert _rel(g.numpy(), w) <= 1e-9


def test_foldable_bn_without_partner_raises():
    from sdformerflow_tpu_torch.models.spiking_layers import SpikingNorm
    lone = torch.nn.Module()
    lone.norm = SpikingNorm(4)
    lone.sn = torch.nn.Identity()
    with pytest.raises(ValueError, match="no partner"):
        fold_model(lone)
    with_partner = torch.nn.Module()
    with_partner.conv = torch.nn.Conv2d(3, 4, 3, bias=False)
    with_partner.norm = SpikingNorm(4)
    folded = fold_model(with_partner)
    assert isinstance(folded.norm, FoldedNorm)
    assert folded.conv.bias is not None and with_partner.conv.bias is None


def test_flow_server_serves_a_folded_model():
    """``FlowServer(model=fold_model(...))`` serves the folded model as
    ``make_eval_step`` runs it; a model together with weights raises."""
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.serving import FlowServer
    from sdformerflow_tpu_torch.training.config import (build_configs,
                                                        load_config)
    config = load_config(TINY_CONFIG)
    model = get_model(config["model"]["name"], *build_configs(config))
    folded = fold_model(randomize_(model, torch.Generator().manual_seed(2)))
    chunk = np.random.default_rng(5).standard_normal(
        (10, 48, 64)).astype(np.float32)
    want = make_eval_step(folded, norm_input="minmax")(
        torch.from_numpy(chunk)[None])[-1][0]
    with FlowServer(config, model=folded, device="cpu", bf16=False) as srv:
        got = srv.infer(chunk)
    np.testing.assert_array_equal(got, want.numpy())
    with pytest.raises(ValueError, match="not both"):
        FlowServer(config, model.state_dict(), model=folded, device="cpu")


# ------------------------------------------------------------ s2d_train

S2D_GEO = GEOMETRIES["tiny"]
S2D_OPT = dict(name="SGD", lr=1e-2, scheduler="multistep", milestones=[1],
               steps_per_epoch=2, clip_grad=100.0)


@pytest.fixture(scope="module")
def s2d_jax():
    """Randomized float64 variables of the tiny s2d_train pair and three
    train steps of the JAX model (flax apply in train mode, the JAX
    package's loss and SGD), one compile: each step's loss, flows, running
    statistics, gradients and parameters after it; then the eval forward
    of the first batch."""
    jmodel, tmodel = flownet_pair(**S2D_GEO, s2d_train=True,
                                  drop_path_rate=0.0)
    batches = _voxel_batches(S2D_GEO, 3, 2, seed=41)
    tx = j_optim.build_optimizer(**S2D_OPT)
    with jax.enable_x64(True):
        encode = lambda c: j_encode(jnp.asarray(c))  # noqa: E731
        variables = init_pair(jmodel, tmodel, np.asarray(encode(
            batches[0]["chunk"])), seed=43)
        v = jax.tree_util.tree_map(jnp.asarray, variables)

        @jax.jit
        def step(params, stats, opt_state, x, label, mask):
            def loss_fn(p):
                out, mut = jmodel.apply(
                    {"params": p, "batch_stats": stats}, x, True,
                    mutable=["batch_stats"],
                    rngs={"droppath": jax.random.PRNGKey(0)})
                return (j_losses.flow_loss_supervised(out["flow"], label,
                                                      mask),
                        (out["flow"], mut["batch_stats"]))

            (loss, (flows, stats)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            upd, opt_state = tx.update(grads, opt_state, params)
            return (optax.apply_updates(params, upd), stats, opt_state, loss,
                    flows, grads)

        params, stats, opt_state = v["params"], v["batch_stats"], \
            tx.init(v["params"])
        steps = []
        for b in batches:
            params, stats, opt_state, loss, flows, grads = step(
                params, stats, opt_state, encode(b["chunk"]),
                jnp.asarray(b["label"]), jnp.asarray(b["mask"]))
            as_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
                np.asarray, t)
            steps.append(dict(loss=float(loss), flows=as_np(flows),
                              grads=as_np(grads), after=as_np(
                                  {"params": params, "batch_stats": stats})))
        eval_flows = jax.jit(lambda z: jmodel.apply(v, z, False)["flow"])(
            encode(batches[0]["chunk"]))
    return dict(variables=variables, batches=batches, steps=steps,
                eval_flows=[np.asarray(f) for f in eval_flows])


def _s2d_model(variables, **cfg):
    _, model = flownet_pair(**S2D_GEO, drop_path_rate=0.0, **cfg)
    model.double().load_state_dict(from_jax(variables, model))
    return model


def test_s2d_train_mode_matches_jax_f64(s2d_jax):
    """Train mode on the first batch: the flows, the running statistics
    after it and the gradient of every parameter."""
    model = _s2d_model(s2d_jax["variables"], s2d_train=True).train()
    first, b = s2d_jax["steps"][0], s2d_jax["batches"][0]
    start = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    flows = model(encode_input(to_torch(b["chunk"])))["flow"]
    loss = flow_loss_supervised(flows, to_torch(b["label"]),
                                to_torch(b["mask"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), first["loss"], rtol=1e-12)
    for f, w in zip(flows, first["flows"]):
        assert _rel(f.detach().numpy(), w) <= 1e-9
    after = from_jax(first["after"], model)
    for k in start:
        np.testing.assert_allclose(model.state_dict()[k].numpy(),
                                   after[k].numpy(), rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    # the block-space head's statistics moved, over its 4 blocks
    key = "sttmultires_unet.encoders.patch_embed.head.norm.BatchNorm_0."
    for stat in ("running_mean", "running_var"):
        assert not torch.equal(start[key + stat],
                               model.state_dict()[key + stat])
    grads = from_jax({"params": first["grads"],
                      "batch_stats": s2d_jax["variables"]["batch_stats"]},
                     model)
    scale = max(v.abs().max().item() for k, v in grads.items()
                if "running" not in k)
    head = "sttmultires_unet.encoders.patch_embed.head."
    assert model.get_parameter(head + "conv.weight").shape[1:] == (2, 3, 3)
    for name, p in model.named_parameters():
        if ".attn_sn." in name:
            assert p.grad is None
            continue
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=1e-9, atol=1e-9 * scale,
                                   err_msg=name)
    assert model.get_parameter(head + "norm.BatchNorm_0.weight").grad \
        .abs().max() > 0


def test_s2d_train_eval_forward_matches_jax_and_base_f64(s2d_jax):
    chunk = s2d_jax["batches"][0]["chunk"]
    s2d = _s2d_model(s2d_jax["variables"], s2d_train=True).eval()
    base = _s2d_model(s2d_jax["variables"]).eval()   # the same entries
    for g, b, w in zip(_flows(s2d, chunk), _flows(base, chunk),
                       s2d_jax["eval_flows"]):
        assert _rel(g.numpy(), w) <= 1e-9
        assert _rel(b.numpy(), w) <= 1e-9


def test_s2d_train_trajectory_matches_jax_f64(s2d_jax):
    """Three steps of the port's train step (SGD, clip 100, the lr halved
    at the second update) against the JAX steps: each loss to 1e-9, every
    parameter and running statistic after each step to 1e-10."""
    model = _s2d_model(s2d_jax["variables"], s2d_train=True)
    opt = optim.build_optimizer(model.named_parameters(), **S2D_OPT)
    step = make_train_step(model, opt)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    for b, want in zip(s2d_jax["batches"], s2d_jax["steps"]):
        loss = step({k: to_torch(v) for k, v in b.items()})["loss"]
        np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-9)
        after = from_jax(want["after"], model)
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), after[k].numpy(), rtol=0,
                                       atol=1e-10, err_msg=k)
    assert int(opt.count) == 3
    head = "sttmultires_unet.encoders.patch_embed.head.conv.weight"
    assert not torch.equal(start[head], model.state_dict()[head])


def test_s2d_train_state_dict_is_the_base_models_and_excludes_s2d_embed():
    _, s2d = flownet_pair(**S2D_GEO, s2d_train=True)
    _, base = flownet_pair(**S2D_GEO)
    got, want = s2d.state_dict(), base.state_dict()
    assert list(got) == list(want)
    assert all(got[k].shape == want[k].shape for k in got)
    s2d.load_state_dict(want)                 # a base checkpoint loads
    with pytest.raises(ValueError, match="mutually exclusive"):
        flownet_pair(**S2D_GEO, s2d_train=True, s2d_embed=True)
