"""PyTorch port vs the JAX package: the pieces of the train step.

Inputs and parameters are drawn with numpy from fixed seeds and fed to both
frameworks. Float64 comparisons hold to 1e-12 (summation order only); the
fused PSN site against the Pallas kernel (interpret mode, whose dots are
float32) runs in float32 and holds to 1e-5 of the largest magnitude.
Spikes are 0/1, so a wrong pairing shows as an O(1) difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from sdformerflow_tpu import losses as j_losses
from sdformerflow_tpu.data import augmentation as j_aug
from sdformerflow_tpu.models import spiking_layers as j_layers
from sdformerflow_tpu.models.common import SpikingConfig as JSpikingConfig
from sdformerflow_tpu.models.spiking_swin import (
    SpikingQKWindowAttention3D as JAttention)
from sdformerflow_tpu.ops import neurons as j_neurons
from sdformerflow_tpu.ops import pallas_psn as j_psn
from sdformerflow_tpu.ops import surrogate as j_surrogate
from sdformerflow_tpu.training import optim as j_optim
from sdformerflow_tpu_torch import losses
from sdformerflow_tpu_torch.data import augmentation as aug
from sdformerflow_tpu_torch.models.common import SpikingConfig
from sdformerflow_tpu_torch.models.spiking_layers import (TorchBatchNorm,
                                                          drop_path)
from sdformerflow_tpu_torch.models.spiking_swin import (
    SpikingQKWindowAttention3D)
from sdformerflow_tpu_torch.ops import hopper_psn, neurons, surrogate
from sdformerflow_tpu_torch.training import optim
from sdformerflow_tpu_torch.training.from_jax import from_jax

from torch_port_harness import randomize_tree, to_torch
from torch_port_harness import one_torch_thread  # noqa: F401


def _rand(shape, seed, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


@pytest.fixture
def pallas_outputs(monkeypatch):
    """Run every pallas_call in interpret mode and record its outputs."""
    outputs = []
    orig = pl.pallas_call

    def interpreted(*args, **kwargs):
        call = orig(*args, interpret=True, **kwargs)

        def run(*operands):
            out = call(*operands)
            outputs.append(out)
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    return outputs


@pytest.mark.parametrize("name,alpha", [("atan", 2.0), ("sigmoid", 4.0),
                                        ("surrogate.ATan()", 3.0)])
def test_surrogate_backward_matches_jax_f64(name, alpha):
    x, proj = _rand((7, 33), 0), _rand((7, 33), 1)
    with jax.enable_x64(True):
        jfn = j_surrogate.get_surrogate(name, alpha)
        want_y = np.asarray(jfn(jnp.asarray(x)))
        want_g = np.asarray(jax.grad(
            lambda z: (jfn(z) * proj).sum())(jnp.asarray(x)))
    xt = to_torch(x).requires_grad_()
    y = surrogate.get_surrogate(name, alpha)(xt)
    (y * to_torch(proj)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    _close(xt.grad, want_g)
    with pytest.raises(ValueError):
        surrogate.get_surrogate("relu")


@pytest.mark.parametrize("name", ["atan", "sigmoid"])
def test_psn_neuron_grads_match_jax_f64(name):
    T = 6
    x, proj = _rand((T, 2, 5, 7), 2), _rand((T, 2, 5, 7), 3)
    w, b = _rand((T, T), 4, 0.4), _rand((T, 1), 5, 0.4)
    with jax.enable_x64(True):
        sg = j_surrogate.get_surrogate(name)

        def loss(x_, w_, b_):
            return (j_neurons.psn_neuron(x_, w_, b_, surrogate_fn=sg)
                    * proj).sum()
        want = jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (x, w, b)))
    leaves = [to_torch(a).requires_grad_() for a in (x, w, b)]
    y = neurons.psn_neuron(*leaves, surrogate_fn=surrogate.get_surrogate(name))
    (y * to_torch(proj)).sum().backward()
    for got, w_ in zip(leaves, want):
        _close(got.grad, w_)


@pytest.mark.parametrize("affine", [False, True])
def test_fused_affine_psn_grads_match_pallas_kernel(pallas_outputs, affine):
    """The Function (CPU: plain twins) vs JAX ``fused_affine_psn`` (Pallas
    forward and backward kernels in interpret mode), float32, the scale and
    shift tiled to [1, N] on the JAX side and their gradients summed back
    per channel."""
    T, C = 10, 12
    shape = (T, 2, 3, 5, C)
    x = _rand(shape, 6).astype(np.float32)
    proj = _rand(shape, 7).astype(np.float32)
    w = _rand((T, T), 8, 0.3).astype(np.float32)
    b = _rand((T, 1), 9, 0.4).astype(np.float32)
    sc = (np.random.default_rng(10).uniform(0.5, 2.0, C)).astype(np.float32)
    sh = _rand((C,), 11).astype(np.float32)
    N = x.size // T
    with jax.enable_x64(False):
        jsc = np.tile(sc, N // C)[None] if affine else np.ones((1, 1),
                                                               np.float32)
        jsh = np.tile(sh, N // C)[None] if affine else np.zeros((1, 1),
                                                                np.float32)

        def loss(x_, w_, b_, s_, f_):
            y = j_psn.fused_affine_psn(x_.reshape(T, N), w_, b_, s_, f_, 2.0)
            return (y.reshape(shape) * proj).sum(), y

        (_, want_y), want = jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *(jnp.asarray(a) for a in (x, w, b, jsc, jsh)))
    assert len(pallas_outputs) == 2          # the forward and backward kernels
    leaves = [to_torch(a).requires_grad_() for a in (x, w, b, sc, sh)]
    kw = dict(scale=leaves[3], shift=leaves[4]) if affine else {}
    y = hopper_psn.affine_psn(*leaves[:3], **kw)
    (y * to_torch(proj)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy().reshape(T, N),
                                  np.asarray(want_y))
    with torch.no_grad():  # the forward alone, no Function in between
        y0 = hopper_psn.affine_psn(*leaves[:3], **kw)
    assert y0.grad_fn is None and torch.equal(y0, y.detach())
    for got, w_ in zip(leaves[:3], want[:3]):
        _close(got.grad, np.asarray(w_).reshape(got.shape), 1e-5)
    if affine:
        for got, w_ in zip(leaves[3:], want[3:]):
            _close(got.grad, np.asarray(w_).reshape(-1, C).sum(0), 1e-5)
    else:
        assert leaves[3].grad is None


def _psn_site_case(T, C, shape, seed, dtype=np.float32):
    x = _rand(shape, seed).astype(dtype)
    g = _rand(shape, seed + 1).astype(dtype)
    w = _rand((T, T), seed + 2, 0.3).astype(dtype)
    b = _rand((T, 1), seed + 3, 0.4).astype(dtype)
    sc = np.random.default_rng(seed + 4).uniform(0.5, 2.0, C).astype(dtype)
    sh = _rand((C,), seed + 5).astype(dtype)
    return x, g, w, b, sc, sh


@pytest.mark.parametrize("affine", [True, False])
def test_psn_backward_plain_matches_fused_bwd(pallas_outputs, affine):
    """The plain twin's five outputs (dx, dW, db, dscale, dshift) vs what
    ``_fused_bwd`` returns (its Pallas kernel in interpret mode, the
    reductions in XLA), float32, within 1e-5 of the largest magnitude; and
    the twin's gh vs the gh the Pallas kernel writes."""
    T, C = 10, 8
    shape = (T, 1, 4, 9, C)
    x, g, w, b, sc, sh = _psn_site_case(T, C, shape, 12)
    N = x.size // T
    with jax.enable_x64(False):
        jsc = np.tile(sc, N // C)[None] if affine else np.ones((1, 1),
                                                               np.float32)
        jsh = np.tile(sh, N // C)[None] if affine else np.zeros((1, 1),
                                                                np.float32)
        res = tuple(jnp.asarray(a) for a in (x.reshape(T, N), w, b, jsc,
                                             jsh))
        want = j_psn._fused_bwd(
            2.0, res, jnp.asarray(g.reshape(T, N)))
        kdx, kgh = (np.asarray(a)[:, :N] for a in pallas_outputs[-1])
    kw = dict(scale=to_torch(sc), shift=to_torch(sh)) if affine else {}
    args = (to_torch(x), to_torch(g), to_torch(w), to_torch(b))
    dx, dw, db, dscale, dshift = hopper_psn.psn_backward_plain(*args, **kw)
    gh = hopper_psn.psn_backward_gh(*args, **kw)
    assert dx.dtype == torch.float32 and dx.shape == shape
    assert gh.dtype == torch.float32 and gh.shape == (T, N)
    np.testing.assert_array_equal(kdx, np.asarray(want[0]))
    _close(gh, kgh, 1e-5)
    _close(dx.reshape(T, N), want[0], 1e-5)
    assert dw.shape == (T, T) and db.shape == (T, 1)
    _close(dw, want[1], 1e-5)
    _close(db, want[2], 1e-5)
    if affine:
        assert dscale.shape == dshift.shape == (C,)
        _close(dscale, np.asarray(want[3]).reshape(-1, C).sum(0), 1e-5)
        _close(dshift, np.asarray(want[4]).reshape(-1, C).sum(0), 1e-5)
    else:
        assert dscale is None and dshift is None


@pytest.mark.parametrize("T,affine", [(10, True), (5, True), (2, False)])
def test_psn_backward_plain_matches_jax_vjp_f64(T, affine):
    """The twin's five outputs vs ``jax.vjp`` of the plain PSN site
    ``psn_neuron(x * scale + shift)`` with the ATan surrogate, float64."""
    C = 6
    shape = (T, 2, 3, C)
    x, g, w, b, sc, sh = _psn_site_case(T, C, shape, 40 + T, np.float64)
    with jax.enable_x64(True):
        sg = j_surrogate.get_surrogate("atan", 2.0)

        def site(x_, w_, b_, s_, f_):
            xa = x_ * s_ + f_ if affine else x_
            return j_neurons.psn_neuron(xa, w_, b_, surrogate_fn=sg)

        _, vjp = jax.vjp(site, *(jnp.asarray(a) for a in (x, w, b, sc, sh)))
        want = vjp(jnp.asarray(g))
    kw = dict(scale=to_torch(sc), shift=to_torch(sh)) if affine else {}
    got = hopper_psn.psn_backward_plain(to_torch(x), to_torch(g),
                                        to_torch(w), to_torch(b), **kw)
    assert all(t.dtype == torch.float64 for t in got if t is not None)
    for name, gt, wt in zip(("dx", "dW", "db", "dscale", "dshift"), got,
                            want):
        if gt is None:
            assert not affine
            continue
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=0,
                                   atol=1e-12 * np.abs(wt).max(),
                                   err_msg=name)


def test_train_batchnorm_matches_flax_f64():
    C = 6
    x, proj = _rand((4, 2, 5, 3, C), 20), _rand((4, 2, 5, 3, C), 21)
    bn = j_layers.TorchBatchNorm()
    with jax.enable_x64(True):
        variables = randomize_tree(bn.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x, jnp.float32)), 22)
        variables = jax.tree_util.tree_map(jnp.asarray, variables)

        def loss(params, x_):
            y, mutated = bn.apply({"params": params,
                                   "batch_stats": variables["batch_stats"]},
                                  x_, mutable=["batch_stats"])
            return (y * proj).sum(), (y, mutated["batch_stats"])

        (_, (want_y, want_stats)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                                jnp.asarray(x))
    tbn = TorchBatchNorm(C).double().train()
    tbn.load_state_dict({
        "weight": to_torch(variables["params"]["scale"]),
        "bias": to_torch(variables["params"]["bias"]),
        "running_mean": to_torch(variables["batch_stats"]["mean"]),
        "running_var": to_torch(variables["batch_stats"]["var"])})
    xt = to_torch(x).requires_grad_()
    y = tbn(xt)
    (y * to_torch(proj)).sum().backward()
    _close(y.detach(), want_y)
    _close(tbn.running_mean, want_stats["mean"])
    _close(tbn.running_var, want_stats["var"])
    _close(xt.grad, gx)
    _close(tbn.weight.grad, gp["scale"])
    _close(tbn.bias.grad, gp["bias"])
    # the fused form: a * x + c from the batch statistics, same gradients
    tbn2 = TorchBatchNorm(C).double().train()
    tbn2.load_state_dict(tbn.state_dict())
    tbn2.running_mean.copy_(to_torch(variables["batch_stats"]["mean"]))
    tbn2.running_var.copy_(to_torch(variables["batch_stats"]["var"]))
    xt2 = to_torch(x).requires_grad_()
    a, c = tbn2.affine(xt2)
    ((a * xt2 + c) * to_torch(proj)).sum().backward()
    _close(tbn2.running_var, want_stats["var"])
    _close(xt2.grad, gx, 1e-10)
    _close(tbn2.weight.grad, gp["scale"], 1e-10)
    _close(tbn2.bias.grad, gp["bias"], 1e-10)


def test_drop_path_matches_jax_on_a_given_mask(monkeypatch):
    """The port's mask replayed from its generator, handed to JAX through
    its ``bernoulli`` draw: the same samples kept, scaled by 1 / keep."""
    x = _rand((3, 4, 2, 2, 5), 30)
    rate, keep = 0.3, 0.7
    got = drop_path(to_torch(x), rate,
                    generator=torch.Generator().manual_seed(9))
    mask = (torch.rand((1, 4, 1, 1, 1),
                       generator=torch.Generator().manual_seed(9)) < keep)
    assert 0 < int(mask.sum()) < 4
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda rng, p, shape: jnp.asarray(mask.numpy()))
    with jax.enable_x64(True):
        want = j_layers.drop_path(jnp.asarray(x), rate, deterministic=False,
                                  rng=jax.random.PRNGKey(0))
    _close(got, want)
    assert drop_path(to_torch(x), 0.0) is not None


@pytest.mark.parametrize("gamma", [None, 0.8])
def test_flow_losses_match_jax_f64(gamma):
    preds = [_rand((2, 2, 6, 8), 40 + i, 3.0) for i in range(3)]
    gt = _rand((2, 2, 6, 8), 50, 3.0)
    mask = (np.random.default_rng(51).random((2, 1, 6, 8)) > 0.3) * 1.0
    with jax.enable_x64(True):
        want = j_losses.flow_loss_supervised(
            [jnp.asarray(p) for p in preds], jnp.asarray(gt),
            jnp.asarray(mask), flow_scaling=1.5, gamma=gamma)
        want_epe = j_losses.masked_epe(*(jnp.asarray(a) for a in (
            preds[0], gt, mask)), mask.sum())
    got = losses.flow_loss_supervised([to_torch(p) for p in preds],
                                      to_torch(gt), to_torch(mask),
                                      flow_scaling=1.5, gamma=gamma)
    _close(got, want)
    _close(losses.masked_epe(to_torch(preds[0]), to_torch(gt),
                             to_torch(mask), to_torch(mask).sum()), want_epe)


def _opt_case():
    """Parameters, one telemetry neuron with no gradient, and 4 steps of
    gradients: plain, clipped (norm > 100), non-finite, plain."""
    rng = np.random.default_rng(60)
    params = {"a": rng.standard_normal((3, 4)), "b": rng.standard_normal(5),
              "attn_sn": rng.standard_normal((2, 2))}
    grads = []
    for scale in (1.0, 80.0, None, 0.5):
        g = {k: rng.standard_normal(v.shape) * (scale or 1.0)
             for k, v in params.items() if k != "attn_sn"}
        if scale is None:
            g["a"][1, 2] = np.nan
        grads.append(g)
    return params, grads


def test_adamw_clip_and_skip_match_optax_f64():
    params, grads = _opt_case()
    assert np.sqrt(sum((g ** 2).sum() for g in grads[1].values())) > 100
    kw = dict(name="AdamW", lr=1e-2, weight_decay=0.05, scheduler="multistep",
              milestones=[2], steps_per_epoch=1, clip_grad=100.0)
    with jax.enable_x64(True):
        tx = j_optim.build_optimizer(**kw)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        state = tx.init(jp)
        want = []
        for g in grads:
            jg = {k: jnp.asarray(v) for k, v in g.items()}
            jg["attn_sn"] = jnp.zeros_like(jp["attn_sn"])
            upd, state = tx.update(jg, state, jp)
            jp = optax.apply_updates(jp, upd)
            want.append(({k: np.asarray(v) for k, v in jp.items()},
                         float(state.grad_norm), int(state.notfinite_count)))
    tp = {k: torch.nn.Parameter(to_torch(v)) for k, v in params.items()}
    opt = optim.build_optimizer(tp.items(), **kw)
    for i, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = to_torch(g[k]) if k in g else None
        norm = opt.step()
        want_p, want_norm, want_skips = want[i]
        for k, p in tp.items():
            _close(p.detach(), want_p[k])
        if i == 2:
            assert not np.isfinite(float(norm))
            np.testing.assert_array_equal(tp["a"].detach().numpy(),
                                          want[1][0]["a"])
        else:
            np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        assert int(opt.notfinite_count) == want_skips
    assert int(opt.count) == 3 and int(opt.notfinite_count) == 1
    np.testing.assert_array_equal(tp["attn_sn"].detach().numpy(),
                                  params["attn_sn"])
    state = opt.state_dict()
    opt2 = optim.build_optimizer(tp.items(), **kw)
    opt2.load_state_dict(state)
    assert int(opt2.count) == 3 and torch.equal(opt2.m, opt.m)


def test_multistep_boundaries_match_optax():
    lr, upe = 1e-4, 7
    milestones = [10, 20, 30, 40, 50, 70, 90, 120]
    j_sched = j_optim.multistep_schedule(lr, milestones, upe)
    sched = optim.multistep_schedule(lr, milestones, upe)
    for count in (0, 69, 70, 71, 139, 140, 349, 350, 839, 840, 5000):
        got = float(sched(torch.tensor(count)))
        np.testing.assert_allclose(got, float(j_sched(count)), rtol=1e-6)
        assert got == lr * 0.5 ** sum(count >= m * upe for m in milestones)
    # only an unknown scheduler raises (JAX falls back to a constant lr);
    # SGD, Adam, OneCycle and num_acc are held in test_torch_port_optim.py
    for bad, exc in ((dict(scheduler="cosine"), NotImplementedError),
                     (dict(name="RMSprop"), ValueError),
                     (dict(num_acc=0), ValueError)):
        with pytest.raises(exc):
            optim.build_optimizer([("w", torch.nn.Parameter(
                torch.zeros(2)))], **bad)


def test_augmentation_transforms_match_jax_at_fixed_decisions():
    ev, fl = _rand((2, 3, 10, 12), 70), _rand((2, 2, 10, 12), 71)
    mk = (np.random.default_rng(72).random((2, 1, 10, 12)) > 0.5) * 1.0
    te, tf, tm = (to_torch(a) for a in (ev, fl, mk))
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        je, jf, jm = (jnp.asarray(a) for a in (ev, fl, mk))
        ri, rj = jax.random.split(key)
        i = int(jax.random.randint(ri, (), 0, 10 - 6 + 1))
        j = int(jax.random.randint(rj, (), 0, 12 - 8 + 1))
        cases = {
            "crop": (j_aug.random_crop(key, je, jf, jm, (6, 8)),
                     aug.crop_at(te, tf, tm, i, j, (6, 8))),
            "center": (j_aug.center_crop(je, jf, jm, (6, 8)),
                       aug.center_crop(te, tf, tm, (6, 8))),
            "hflip": (j_aug.random_hflip(key, je, jf, jm, p=1.0),
                      aug.hflip(te, tf, tm)),
            "vflip": (j_aug.random_vflip(key, je, jf, jm, p=1.0),
                      aug.vflip(te, tf, tm)),
            "no_flip": (j_aug.random_hflip(key, je, jf, jm, p=0.0),
                        (te, tf, tm)),
        }
        _, r_rate, r_mask = jax.random.split(key, 3)
        q = (0.0 - 0.6) * jax.random.uniform(r_rate, ()) + 0.6
        keep = np.asarray(jax.random.uniform(r_mask, ev.shape) > q)
        want_drop = j_aug.random_event_drop(key, je, max_rate=0.6, p=1.0)
    for name, (want, got) in cases.items():
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    np.testing.assert_array_equal(
        aug.event_drop(te, torch.from_numpy(keep.copy())).numpy(),
        np.asarray(want_drop))
    # the composition: the crop window, flips with the flow's sign
    apply = aug.build_train_augmentation(["Horizontal", "Vertical",
                                          "Polarity", "Drop"],
                                         [1.0, 0.0, 1.0, 0.0], crop=(6, 8))
    e2, f2, m2 = apply(torch.Generator().manual_seed(1), te, tf, tm)
    assert e2.shape == (2, 3, 6, 8) and f2.shape == (2, 2, 6, 8)
    # Rotation is ported (held against JAX in
    # test_torch_port_train_slice.py): it keeps the shapes
    e3, f3, m3 = aug.build_train_augmentation(["Rotation"], [0.5],
                                              rotation_degrees=(-30, 30))(
        torch.Generator().manual_seed(1), te, tf, tm)
    assert e3.shape == te.shape and f3.shape == tf.shape == (2, 2, 10, 12)


def test_train_attention_matches_flax_f64():
    """The pair-local train form (train BN on q, k and proj_bn, fused PSN
    sites) vs the flax module in train mode (raw-refold path): output,
    BN statistics and every parameter gradient."""
    M, wh, ww, C, nh = 10, 2, 5, 48, 6
    jmod = JAttention(dim=C, window_size=(2, wh, ww), num_heads=nh,
                      cfg=JSpikingConfig(num_steps=2, v_th=0.1,
                                         neuron_type="psn", spike_norm="BN"),
                      norm="BN")
    x = _rand((2, M, wh, ww, C), 80)
    proj = _rand((2, M, wh, ww, C), 81)
    variables = randomize_tree(
        jmod.init({"params": jax.random.PRNGKey(0)},
                  jnp.asarray(x, jnp.float32), None, False), 82)
    with jax.enable_x64(True):
        jv = jax.tree_util.tree_map(jnp.asarray, variables)

        def loss(params):
            (y, _), mutated = jmod.apply(
                {"params": params, "batch_stats": jv["batch_stats"]},
                jnp.asarray(x), None, True, mutable=["batch_stats"])
            return (y * proj).sum(), (y, mutated["batch_stats"])

        (_, (want_y, want_bs)), want_g = jax.value_and_grad(
            loss, has_aux=True)(jv["params"])
    tmod = SpikingQKWindowAttention3D(
        C, (2, wh, ww), nh, SpikingConfig(num_steps=10, v_th=0.1,
                                          neuron_type="psn"))
    tmod.double().load_state_dict(from_jax(variables, tmod))
    tmod.train()
    y = tmod(to_torch(x))
    (y * to_torch(proj)).sum().backward()
    _close(y.detach(), want_y)
    assert 0.0 < float(torch.as_tensor(np.asarray(want_y)).abs().mean())
    after = from_jax({"params": variables["params"],
                      "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                            want_bs)}, tmod)
    for k, v in after.items():
        if "running" in k:
            _close(tmod.state_dict()[k], v)
    grads = from_jax({"params": jax.tree_util.tree_map(np.asarray, want_g),
                      "batch_stats": variables["batch_stats"]}, tmod)
    # some leaves' true gradients are ~0 (rounding noise of 1e-15): hold
    # every leaf to 1e-10 of the largest gradient
    scale = max(np.abs(v.numpy()).max() for k, v in grads.items()
                if "running" not in k)
    for name, p in tmod.named_parameters():
        if name.startswith("attn_sn."):
            assert p.grad is None       # never fired in the train form
            continue
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=0, atol=1e-10 * scale, err_msg=name)
