"""PyTorch port vs the JAX package: SNN-zoo layers no registry model
reaches with its defaults, float64, eval and train mode:

- the SEW window attention (swin-v1 and swin-v2; PSN, LIF and GLIF) on
  shifted windows with the shift mask, which must move the output;
- the SEW swin block with the ``cnf`` joins AND and IAND (JAX's stages
  take ADD);
- the SEW and MS transposed-conv decoders at scale 4 (k 7, stride 4,
  padding 2, output_padding 1);
- the SEW and MS residual blocks with each ``connect_function`` (ADD,
  MUL, AND, OR, NMUL).

Spikes are exact 0/1 on both sides; 1e-9 of the largest output absorbs
float64 summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu.models import spiking_layers as JL
from sdformerflow_tpu.models import spiking_swin as JS
from sdformerflow_tpu_torch.models import spiking_layers as TL
from sdformerflow_tpu_torch.models import spiking_swin as TS
from sdformerflow_tpu_torch.models.common import SpikingConfig
from sdformerflow_tpu_torch.ops import windows as W
from sdformerflow_tpu_torch.training.from_jax import from_jax

from torch_port_harness import JSpikingConfig, randomize_tree, to_torch
from torch_port_zoo_cases import one_torch_thread  # noqa: F401

TOL = 1e-9


def _cfgs(**kw):
    kw = dict(dict(num_steps=4, v_th=0.3, neuron_type="psn",
                   spike_norm="BN"), **kw)
    return JSpikingConfig(**kw), SpikingConfig(**kw)


def _match(jmod, tmod, x, *args, seed=1, first=True, pass_args=True):
    """Hold ``tmod`` against ``jmod`` on ``x`` (``args`` after it, to the
    port module too if ``pass_args``) in eval and train mode (output
    ``[0]`` of a tuple if ``first``); returns the eval output."""
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda z: jmod.init(
            jax.random.PRNGKey(0), z, *args), x)
    variables = randomize_tree(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape), shapes), seed)
    tmod.double().load_state_dict(from_jax(variables, tmod))

    def pick(out):
        return out[0] if first and isinstance(out, tuple) else out

    with jax.enable_x64(True):
        @jax.jit
        def both(v, z):
            ev = jmod.apply(v, z, *args, train=False)
            tr, _ = jmod.apply(v, z, *args, train=True,
                               mutable=["batch_stats"])
            return pick(ev), pick(tr)
        want = [np.asarray(w) for w in both(variables, jnp.asarray(x))]
    targs = [to_torch(a) if isinstance(a, np.ndarray) else a
             for a in args] if pass_args else []
    outs = []
    with torch.no_grad():
        for train, w in zip((False, True), want):
            got = tmod.train(train)(to_torch(x), *targs)
            assert np.abs(w).max() > 0
            np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                       atol=TOL * np.abs(w).max())
            outs.append(got)
    return outs[0]


@pytest.mark.parametrize("version,neuron", [
    ("swinv1", "psn"), ("swinv1", "lif"), ("swinv2", "psn"),
    ("swinv2", "glif")])
def test_sew_attention_with_shift_mask_matches_jax_f64(version, neuron):
    ws, ss, C, B = (2, 3, 3), (1, 1, 1), 8, 1
    D, H, Wd = 4, 6, 6
    mask = W.compute_mask(D, H, Wd, ws, ss)               # [nW, N, N]
    nW = mask.shape[0]
    jcfg, tcfg = _cfgs(neuron_type=neuron)
    x = np.random.default_rng(2).standard_normal((2, B * nW, 3, 3, C))
    kw = dict(version=version, qk_scale=0.125, norm="BN")
    jmod = JS.SpikingBNWindowAttention3D(C, ws, 2, jcfg, **kw)
    tmod = TS.SpikingBNWindowAttention3D(C, ws, 2, tcfg, **kw)
    masked = _match(jmod, tmod, x, mask)
    with torch.no_grad():
        unmasked = tmod.eval()(to_torch(x))
    assert not torch.equal(masked, unmasked)


@pytest.mark.parametrize("cnf", ["AND", "IAND"])
def test_sew_block_joins_match_jax_f64(cnf):
    """A shifted SEW block (the mask from its own geometry, as JAX's stage
    computes it) with a non-ADD join, on spikes."""
    jcfg, tcfg = _cfgs(neuron_type="lif")
    ws, ss, res = (2, 3, 3), (1, 1, 1), (4, 6, 6)
    kw = dict(window_size=ws, shift_size=ss, mlp_ratio=2.0,
              qk_scale=0.125, cnf=cnf)
    jmod = JS.SpikingSwinBlock3D(8, 2, jcfg, ms=False, **kw)
    tmod = TS.SpikingSwinBlock3D(8, 2, tcfg, res, ms=False, **kw)
    x = (np.random.default_rng(5).standard_normal((4, 1, 6, 6, 8)) > 0.3)
    _match(jmod, tmod, x.astype(np.float64), W.compute_mask(*res, ws, ss),
           pass_args=False)


@pytest.mark.parametrize("ms", [False, True])
def test_scale4_transpose_decoder_matches_jax_f64(ms):
    jcfg, tcfg = _cfgs(neuron_type="plif")
    jcls = JL.MSSpikingTransposeDecoderLayer if ms \
        else JL.SpikingTransposeDecoderLayer
    tcls = TL.MSSpikingTransposeDecoderLayer if ms \
        else TL.SpikingTransposeDecoderLayer
    x = np.random.default_rng(3).standard_normal((4, 1, 5, 6, 6))
    tmod = tcls(6, 4, tcfg, 3, scale=4)
    assert tmod.deconv.kernel_size == (7, 7) and tmod.deconv.padding == (2, 2)
    out = _match(jcls(4, jcfg, 3, scale=4), tmod, x)
    assert out.shape == (4, 1, 20, 24, 4)


@pytest.mark.parametrize("ms", [False, True])
@pytest.mark.parametrize("cnf", ["ADD", "MUL", "AND", "OR", "NMUL"])
def test_resblock_connect_functions_match_jax_f64(ms, cnf):
    jcfg, tcfg = _cfgs(neuron_type="if")
    jcls = JL.MSResBlock if ms else JL.SEWResBlock
    tcls = TL.MSResBlock if ms else TL.SEWResBlock
    x = np.random.default_rng(4).standard_normal((4, 1, 5, 5, 6))
    if not ms:   # SEW blocks join spikes
        x = (x > 0).astype(np.float64)
    _match(jcls(6, jcfg, cnf), tcls(6, tcfg, cnf), x)
