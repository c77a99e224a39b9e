"""PyTorch port vs the JAX package: the MS Sep-conv layers
(``models/spiking_layers.py``: ``MSSepConv``,
``MSSpikingSepConvEncoderBlock``, ``MSSpikingSepTransposeDecoderLayer``,
``MSSpikingSepPredLayer``), float64 on the CPU.

Each layer on both sides from the same randomized variables (crossed
through ``from_jax``): the eval and the train forward within 1e-9 of the
largest output, the running statistics after the train forward within
1e-9, the telemetry's keys and firing rates against JAX's sown
``intermediates``, and the folded eval forward (``fold_model`` against
JAX's ``fold_model_and_variables``, and a ``fold_bn`` layer loading JAX's
folded variables). PSN + BN makes every norm -> neuron pair one fused site
(K2's twin); LIF + TDBN runs the norm as its own pass and the neuron's loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu.models import spiking_layers as JL
from sdformerflow_tpu.training.bn_folding import fold_model_and_variables
from sdformerflow_tpu_torch.models import spiking_layers as TL
from sdformerflow_tpu_torch.models.common import SpikingConfig
from sdformerflow_tpu_torch.training.bn_folding import fold_model
from sdformerflow_tpu_torch.training.from_jax import from_jax

from torch_port_harness import JSpikingConfig, randomize_tree, to_torch
from torch_port_harness import one_torch_thread  # noqa: F401

TOL = 1e-9
RATE_TOL = 1e-6   # a float32 mean of exact 0/1 spikes


def cfgs(**kw):
    kw = dict(dict(num_steps=4, v_th=0.3, neuron_type="psn",
                   spike_norm="BN"), **kw)
    return JSpikingConfig(**kw), SpikingConfig(**kw)


def jax_keyed(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def variables_for(jmod, x, seed, *args):
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda z: jmod.init(
            jax.random.PRNGKey(0), z, *args), x)
    return randomize_tree(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape), shapes), seed)


def close(got, want, what):
    want = np.asarray(want)
    assert got.dtype == torch.float64 and got.shape == want.shape, what
    assert np.abs(want).max() > 0, what
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=what)


def run_jax(jmod, variables, x, *args, pick=lambda o: o):
    """JAX's eval forward with its sown telemetry, and its train forward
    with the mutated batch statistics."""
    with jax.enable_x64(True):
        @jax.jit
        def both(v, z):
            ev, sown = jmod.apply(v, z, *args, train=False,
                                  mutable=["intermediates"])
            tr, mut = jmod.apply(v, z, *args, train=True,
                                 mutable=["batch_stats"])
            return pick(ev), sown["intermediates"], pick(tr), mut
        ev, sown, tr, mut = both(variables, jnp.asarray(x))
    return (np.asarray(ev), jax_keyed(sown), np.asarray(tr),
            jax.tree_util.tree_map(np.asarray, mut))


def hold(jmod, tmod, x, *args, seed=1, pick=lambda o: o):
    """Hold ``tmod`` against ``jmod`` on ``x`` in eval (with the
    telemetry) and train mode, and the running statistics after the
    train forward; returns the JAX variables."""
    variables = variables_for(jmod, x, seed, *args)
    tmod.double().load_state_dict(from_jax(variables, tmod))
    want_ev, sown, want_tr, mut = run_jax(jmod, variables, x, *args,
                                          pick=pick)
    targs = [to_torch(a) for a in args]
    with torch.no_grad():
        with TL.collect_sites(tmod.eval()) as sites:
            got_ev = pick(tmod(to_torch(x), *targs))
        got_tr = pick(tmod.train()(to_torch(x), *targs))
    close(got_ev, want_ev, "eval")
    close(got_tr, want_tr, "train")
    assert list(sites) and set(sites) == set(sown)
    for key, rate in sown.items():
        assert 0.0 < float(rate) < 1.0 or "spike_rate" not in key, key
        assert abs(float(sites[key]) - float(rate)) <= RATE_TOL, key
    if "batch_stats" in mut:
        after = from_jax(dict(variables, batch_stats=mut["batch_stats"]),
                         tmod)
        stats = [k for k in after if "running" in k]
        assert stats
        for k in stats:
            np.testing.assert_allclose(
                tmod.state_dict()[k].numpy(), after[k].numpy(), rtol=TOL,
                atol=TOL * float(after[k].abs().max()), err_msg=k)
    return variables


def hold_folded(jmod, tmod, make_folded, x, *args, seed=1,
                pick=lambda o: o):
    """The folded eval forward: JAX's ``fold_model_and_variables`` against
    the port's ``fold_model`` and against a ``fold_bn`` module loading
    JAX's folded variables; returns the port's folded module."""
    variables = variables_for(jmod, x, seed, *args)
    tmod.double().load_state_dict(from_jax(variables, tmod))
    with jax.enable_x64(True):
        jfold, vfold = fold_model_and_variables(jmod, variables)
        want = np.asarray(pick(jax.jit(lambda v, z: jfold.apply(
            v, z, *args, train=False))(vfold, jnp.asarray(x))))
    targs = [to_torch(a) for a in args]
    folded = fold_model(tmod.eval())
    rebuilt = make_folded().double()
    rebuilt.load_state_dict(from_jax(
        jax.tree_util.tree_map(np.asarray, vfold), rebuilt))
    with torch.no_grad():
        close(pick(folded(to_torch(x), *targs)), want, "fold_model")
        close(pick(rebuilt.eval()(to_torch(x), *targs)), want, "fold_bn")
    assert set(folded.state_dict()) == set(rebuilt.state_dict())
    return folded


# (JAX layer, port layer, input [T, B, H, W, C], output shape) of a config
def layer_cases(jcfg, tcfg):
    return {
        "sep": (JL.MSSepConv(6, jcfg), TL.MSSepConv(6, tcfg),
                (4, 2, 7, 7, 6), (4, 2, 7, 7, 6)),
        "encoder": (JL.MSSpikingSepConvEncoderBlock(6, 10, jcfg),
                    TL.MSSpikingSepConvEncoderBlock(6, 10, tcfg),
                    (4, 2, 7, 7, 6), (4, 2, 7, 7, 6)),
        "decoder": (JL.MSSpikingSepTransposeDecoderLayer(5, jcfg),
                    TL.MSSpikingSepTransposeDecoderLayer(6, 5, tcfg),
                    (4, 1, 3, 4, 6), (4, 1, 12, 16, 5)),
        "pred": (JL.MSSpikingSepPredLayer(3, jcfg, kernel_size=3),
                 TL.MSSpikingSepPredLayer(6, 3, tcfg, kernel_size=3),
                 (4, 2, 5, 5, 6), (4, 2, 5, 5, 3)),
    }


LAYERS = ("sep", "encoder", "decoder", "pred")


@pytest.mark.parametrize("neuron,norm", [("psn", "BN"), ("lif", "TDBN")])
@pytest.mark.parametrize("layer", LAYERS)
def test_sep_layer_matches_jax_f64(layer, neuron, norm):
    jcfg, tcfg = cfgs(neuron_type=neuron, spike_norm=norm)
    jmod, tmod, shape, out_shape = layer_cases(jcfg, tcfg)[layer]
    x = 1.5 * np.random.default_rng(3).standard_normal(shape)
    hold(jmod, tmod, x)
    with torch.no_grad():
        assert tmod.eval()(to_torch(x)).shape == out_shape


@pytest.mark.parametrize("layer", LAYERS)
def test_folded_sep_layer_matches_jax_f64(layer):
    jcfg, tcfg = cfgs()
    _, fcfg = cfgs(fold_bn=True)
    jmod, tmod, shape, _ = layer_cases(jcfg, tcfg)[layer]
    x = 1.5 * np.random.default_rng(4).standard_normal(shape)
    folded = hold_folded(jmod, tmod,
                         lambda: layer_cases(jcfg, fcfg)[layer][1], x)
    norms = [m for m in folded.modules()
             if isinstance(m, (TL.SpikingNorm, TL.TorchBatchNorm))]
    assert norms == []
    folds = sum(isinstance(m, TL.FoldedNorm) for m in folded.modules())
    assert folds == {"sep": 2, "encoder": 4, "decoder": 2, "pred": 0}[layer]


def test_sep_layers_psn_sites_are_fused():
    """Under PSN + BN each norm -> neuron pair is one site: the neuron
    gets the BN's affine, and the un-normed neurons none."""
    _, tcfg = cfgs()
    affines = {}

    def spy(name):
        def hook(mod, args, kwargs):
            affines[name] = kwargs.get("affine") is not None
        return hook

    block = TL.MSSpikingSepConvEncoderBlock(6, 10, tcfg).eval()
    for name, m in block.named_modules():
        if isinstance(m, TL.SpikingNeuron):
            m.register_forward_pre_hook(spy(name), with_kwargs=True)
    with torch.no_grad():
        block(torch.randn(4, 1, 5, 5, 6))
    assert affines == {"sep.sn1": False, "sep.sn2": True, "sn1": False,
                       "sn2": True}
    assert block.sep.dwconv.bias is None and block.sep.dwconv.groups == 12
