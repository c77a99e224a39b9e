"""PyTorch port vs the JAX package: every spiking neuron and every norm of
the SNN zoo, float64.

- ``ops/neurons.py``: IF, LIF (both ``decay_input`` forms), SLTT-LIF,
  PLIF, GLIF and PSN, forward and VJP (a random cotangent), soft and hard
  reset, ``detach_reset`` both ways, and the membrane of ``return_v``;
  ``glif_init`` from a generator against the logits JAX's init gives.
- ``models/spiking_layers.py:SpikingNorm``: BN, BN_notrack, TDBN, BNTT, GN,
  IN and LN on one [T, B, H, W, C] input, in eval and in train mode, the
  running statistics after a train call included, and each one's gradient.

The spikes are exact 0/1 on both sides; the tolerance (1e-12 relative)
absorbs float64 summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu.models import spiking_layers as j_layers
from sdformerflow_tpu.ops import neurons as j_neurons
from sdformerflow_tpu.ops.surrogate import get_surrogate as j_surrogate
from sdformerflow_tpu_torch.models.spiking_layers import SpikingNorm
from sdformerflow_tpu_torch.ops import neurons
from sdformerflow_tpu_torch.ops.surrogate import get_surrogate
from sdformerflow_tpu_torch.training.from_jax import from_jax

from torch_port_harness import randomize_tree, to_torch
from torch_port_zoo_cases import one_torch_thread  # noqa: F401

TOL = 1e-12
T, SHAPE = 6, (6, 2, 5, 7)


def _rand(shape, seed, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL * max(np.abs(want).max(), 1.0))


def _cases():
    for kind in ("if", "lif", "lif_nodecay", "slttlif", "plif",
                 "plif_nodecay"):
        for v_reset in (None, -0.2):
            for detach in (True, False):
                yield kind, v_reset, detach
    yield "glif", None, True
    yield "psn", None, True


def _pair(kind, v_reset, detach):
    """(JAX fn, port fn) of ``(x, param) -> (spikes, v)``."""
    kw = dict(v_th=0.3, v_reset=v_reset, detach_reset=detach, return_v=True)
    jkw = dict(kw, surrogate_fn=j_surrogate("atan"))
    tkw = dict(kw, surrogate_fn=get_surrogate("atan"))
    decay = not kind.endswith("_nodecay")
    base = kind.split("_")[0]
    if base == "if":
        return (lambda x, p: j_neurons.if_neuron(x, **jkw),
                lambda x, p: neurons.if_neuron(x, **tkw))
    if base in ("lif", "slttlif"):
        jf = j_neurons.lif_neuron if base == "lif" else \
            j_neurons.sltt_lif_neuron
        tf = neurons.lif_neuron if base == "lif" else neurons.sltt_lif_neuron
        return (lambda x, p: jf(x, tau=1.7, decay_input=decay, **jkw),
                lambda x, p: tf(x, tau=1.7, decay_input=decay, **tkw))
    if base == "plif":
        return (lambda x, p: j_neurons.plif_neuron(x, p, decay_input=decay,
                                                   **jkw),
                lambda x, p: neurons.plif_neuron(x, p, decay_input=decay,
                                                 **tkw))
    if base == "glif":
        return (lambda x, p: j_neurons.glif_neuron(
                    x, j_neurons.GLIFParams(*p),
                    surrogate_fn=jkw["surrogate_fn"], return_v=True),
                lambda x, p: neurons.glif_neuron(
                    x, neurons.GLIFParams(*p),
                    surrogate_fn=tkw["surrogate_fn"], return_v=True))
    return (lambda x, p: j_neurons.psn_neuron(
                x, *p, surrogate_fn=jkw["surrogate_fn"], return_v=True),
            lambda x, p: neurons.psn_neuron(
                x, *p, surrogate_fn=tkw["surrogate_fn"], return_v=True))


def _params(kind, seed):
    base = kind.split("_")[0]
    if base == "plif":
        return np.asarray(0.4)
    if base == "glif":
        return tuple(_rand((T,) if i == 7 else (), seed + i, 0.5)
                     for i in range(8))
    if base == "psn":
        return (_rand((T, T), seed, 0.5), _rand((T, 1), seed + 1, 0.5))
    return None


@pytest.mark.parametrize("kind,v_reset,detach", list(_cases()))
def test_neuron_forward_and_vjp_match_jax_f64(kind, v_reset, detach):
    x = _rand(SHAPE, 1, 0.6)
    gs, gv = _rand(SHAPE, 2), _rand(SHAPE, 3)
    p = _params(kind, 4)
    jfn, tfn = _pair(kind, v_reset, detach)
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(jnp.asarray, p)

        def loss(x_, p_):
            s, v = jfn(x_, p_)
            return (s * gs).sum() + (v * gv).sum(), (s, v)

        (_, (s_want, v_want)), (gx_want, gp_want) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jp)
    xt = to_torch(x).requires_grad_()
    pt = None if p is None else jax.tree_util.tree_map(
        lambda a: to_torch(a).requires_grad_(), p)
    s, v = tfn(xt, pt)
    ((s * to_torch(gs)).sum() + (v * to_torch(gv)).sum()).backward()
    np.testing.assert_array_equal(s.detach().numpy(), np.asarray(s_want))
    rate = float(np.asarray(s_want).mean())
    assert 0.0 < rate < 1.0, rate
    _close(v, v_want)
    _close(xt.grad, gx_want)
    if pt is not None:
        for got, want in zip(jax.tree_util.tree_leaves(pt),
                             jax.tree_util.tree_leaves(gp_want)):
            _close(got.grad, want)


def test_glif_init_takes_a_generator():
    """The seeded draw fills the three gate mixes in [-0.1, 0.1); the other
    logits are JAX's, exactly."""
    with jax.enable_x64(False):
        want = j_neurons.glif_init(jax.random.PRNGKey(0), 5)
    a = neurons.glif_init(torch.Generator().manual_seed(3), 5)
    b = neurons.glif_init(torch.Generator().manual_seed(3), 5)
    for f in neurons.GLIFParams._fields:
        got = getattr(a, f)
        assert torch.equal(got, getattr(b, f)) and got.dtype == torch.float32
        if f in ("alpha", "beta", "gamma"):
            assert -0.1 <= got.item() < 0.1
        else:
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(want, f)))
    assert neurons.plif_init_w(2.0) == j_neurons.plif_init_w(2.0)


NORMS = ("BN", "BN_notrack", "TDBN", "BNTT", "GN", "IN", "LN")


@pytest.mark.parametrize("norm", NORMS)
def test_spiking_norm_matches_jax_f64(norm):
    """Eval and train mode, the running statistics after the train call,
    and the gradient of the input and every parameter."""
    C, x = 32, _rand((4, 2, 5, 6, 32), 7, 1.5) + 0.3
    g = _rand(x.shape, 8)
    jnorm = j_layers.SpikingNorm(C, 4, norm, 0.7)
    tnorm = SpikingNorm(C, norm, 4, 0.7).double()
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda z: jnorm.init(
            jax.random.PRNGKey(0), z, True), x)
        variables = randomize_tree(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape), shapes), 9)
        tnorm.load_state_dict(from_jax(variables, tnorm))
        v = jax.tree_util.tree_map(jnp.asarray, variables)
        want_eval = jnorm.apply(v, jnp.asarray(x), False)

        def loss(params, x_):
            y, mut = jnorm.apply(dict(v, params=params), x_, True,
                                 mutable=["batch_stats"])
            return (y * g).sum(), (y, mut)

        (_, (want_train, mut)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    with torch.no_grad():
        _close(tnorm.eval()(to_torch(x)), want_eval)
    xt = to_torch(x).requires_grad_()
    y = tnorm.train()(xt)
    (y * to_torch(g)).sum().backward()
    _close(y, want_train)
    _close(xt.grad, gx)
    after = from_jax(dict(variables, **jax.tree_util.tree_map(
        np.asarray, dict(mut))), tnorm)
    sd = tnorm.state_dict()
    for k, want in after.items():
        _close(sd[k], want.numpy())
    gsd = from_jax(dict(variables, params=jax.tree_util.tree_map(
        np.asarray, gp)), tnorm)
    for name, p in tnorm.named_parameters():
        _close(p.grad, gsd[name].numpy())
    if norm == "TDBN":
        fresh = SpikingNorm(C, norm, 4, 0.7)
        assert torch.equal(fresh.BatchNorm_0.weight, torch.full((C,), 0.7))
