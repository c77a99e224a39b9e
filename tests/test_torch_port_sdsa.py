"""PyTorch port vs the JAX package, float64 on the CPU: the SEW window
attention's SDSA switches, the plain-conv projection of the "Local" patch
embed, and the last helpers.

- ``SpikingBNWindowAttention3D`` under each combination of
  ``spike_input`` / ``spike_output`` (and with the shift mask): the output
  and the attention map in eval and train mode within 1e-9 of the largest,
  the running statistics after the train forward, the telemetry's sites,
  and the folded forward (``proj_bn`` folded into ``proj`` whether or not
  the output spikes);
- ``SpikingPatchEmbedLocal(spiking_proj=False)``: one 3x3 conv at the
  patch stride applied to every time step, the same checks;
- ``data/augmentation.downsample_data`` (JAX's antialiased bilinear
  downscale), ``ops/windows.window_partition_v2`` (bit for bit, and the
  same elements as the time-major form), ``utils/logging.print_parameters``.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu.data.augmentation import (
    downsample_data as j_downsample_data)
from sdformerflow_tpu.models import spiking_patch_embed as JE
from sdformerflow_tpu.models import spiking_swin as JS
from sdformerflow_tpu.ops import windows as JW
from sdformerflow_tpu.utils.logging import (
    print_parameters as j_print_parameters)
from sdformerflow_tpu_torch.data.augmentation import downsample_data
from sdformerflow_tpu_torch.models import spiking_layers as TL
from sdformerflow_tpu_torch.models import spiking_patch_embed as TE
from sdformerflow_tpu_torch.models import spiking_swin as TS
from sdformerflow_tpu_torch.ops import windows as W
from sdformerflow_tpu_torch.training.from_jax import from_jax
from sdformerflow_tpu_torch.utils.logging import print_parameters

from test_torch_port_sepconv import cfgs, hold, hold_folded, variables_for
from torch_port_harness import to_torch
from torch_port_harness import one_torch_thread  # noqa: F401

WS = (2, 3, 3)
SWITCHES = [(False, True), (True, True), (False, False), (True, False)]


def attention_pair(spike_input, spike_output, **cfg):
    jcfg, tcfg = cfgs(**cfg)
    kw = dict(version="swinv1", qk_scale=0.125, norm="BN",
              spike_input=spike_input, spike_output=spike_output)
    return (JS.SpikingBNWindowAttention3D(8, WS, 2, jcfg, **kw),
            lambda c=tcfg: TS.SpikingBNWindowAttention3D(8, WS, 2, c, **kw))


def first(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("spike_input,spike_output", SWITCHES)
def test_sdsa_switches_match_jax_f64(spike_input, spike_output):
    jmod, make = attention_pair(spike_input, spike_output)
    tmod = make()
    assert hasattr(tmod, "proj_sn_in") == spike_input
    assert hasattr(tmod, "proj_sn") == spike_output
    x = 1.5 * np.random.default_rng(2).standard_normal((2, 4, 3, 3, 8))
    variables = hold(jmod, tmod, x, pick=first)
    # the attention map JAX returns beside the output, from the variables
    # before the train forward moved the running statistics
    tmod.load_state_dict(from_jax(variables, tmod))
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(lambda v, z: jmod.apply(v, z)[1])(
            variables, jnp.asarray(x)))
    with torch.no_grad():
        out, attn = tmod.eval()(to_torch(x), return_attention=True)
    np.testing.assert_allclose(attn.numpy(), want, rtol=0,
                               atol=1e-9 * np.abs(want).max())
    spikes = set(np.unique(out.numpy()).tolist()) <= {0.0, 1.0}
    assert spikes == spike_output


@pytest.mark.parametrize("spike_input,spike_output", [(True, False),
                                                      (True, True)])
def test_sdsa_with_shift_mask_matches_jax_f64(spike_input, spike_output):
    mask = W.compute_mask(4, 6, 6, WS, (1, 1, 1))          # [4, 18, 18]
    jmod, make = attention_pair(spike_input, spike_output,
                                neuron_type="lif")
    x = 1.5 * np.random.default_rng(5).standard_normal((2, 8, 3, 3, 8))
    hold(jmod, make(), x, mask, pick=first)


@pytest.mark.parametrize("spike_input,spike_output", SWITCHES)
def test_folded_sdsa_matches_jax_f64(spike_input, spike_output):
    jmod, make = attention_pair(spike_input, spike_output)
    _, fcfg = cfgs(fold_bn=True)
    x = 1.5 * np.random.default_rng(6).standard_normal((2, 4, 3, 3, 8))
    folded = hold_folded(jmod, make(), lambda: make(fcfg), x, pick=first)
    assert isinstance(folded.proj_bn, TL.FoldedNorm)
    assert folded.proj.bias is not None


def local_pair(**cfg):
    jcfg, tcfg = cfgs(**cfg)
    kw = dict(img_size=(12, 12), patch_size=(1, 1, 2, 2), in_chans=4,
              embed_dim=8, num_res=2, spiking_proj=False)
    return (JE.SpikingPatchEmbedLocal(cfg=jcfg, **kw),
            lambda c=tcfg: TE.SpikingPatchEmbedLocal(cfg=c, **kw))


@pytest.mark.parametrize("use_ms", [False, True])
def test_local_embed_plain_conv_proj_matches_jax_f64(use_ms):
    jmod, make = local_pair()
    jmod = jmod.clone(use_ms=use_ms)
    tmod = TE.SpikingPatchEmbedLocal(
        (12, 12), (1, 1, 2, 2), 4, 8, cfgs()[1], use_ms=use_ms, num_res=2,
        spiking_proj=False)
    assert isinstance(tmod.proj, TL.Conv2d)
    assert tmod.proj.stride == (2, 2) and tmod.proj.bias is not None
    x = np.random.default_rng(7).standard_normal((2, 4, 2, 12, 12))
    variables = hold(jmod, tmod, x)
    assert set(variables["params"]["proj"]) == {"kernel", "bias"}
    with torch.no_grad():
        out = tmod.eval()(to_torch(x))
    assert out.shape == (4, 2, 6, 6, 8)
    # not spikes: the projection is a plain conv
    assert not set(np.unique(out.numpy()).tolist()) <= {0.0, 1.0}


def test_folded_local_embed_plain_conv_proj_matches_jax_f64():
    jmod, make = local_pair()
    _, fcfg = cfgs(fold_bn=True)
    x = np.random.default_rng(8).standard_normal((1, 4, 2, 12, 12))
    hold_folded(jmod, make(), lambda: make(fcfg), x)


@pytest.mark.parametrize("shape,scale", [
    ((2, 3, 20, 30), 0.5), ((1, 2, 17, 23), 0.37), ((2, 1, 16, 16), 2.0),
    ((2, 2, 9, 12), 0.75), ((3, 10, 2, 24, 32), 0.25)])
def test_downsample_data_matches_jax_f64(shape, scale):
    rng = np.random.default_rng(9)
    arrays = (rng.standard_normal(shape), rng.standard_normal(shape[:-3]
                                                            + (2,)
                                                            + shape[-2:]))
    with jax.enable_x64(True):
        want = j_downsample_data(tuple(jnp.asarray(a) for a in arrays),
                                 scale)
    got = downsample_data(tuple(to_torch(a) for a in arrays), scale)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float64 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-9 * np.abs(w).max())


@pytest.mark.parametrize("window", [(2, 3, 3), (2, 2, 4), (1, 3, 2)])
def test_window_partition_v2_is_jax_bit_for_bit(window):
    x = np.random.default_rng(10).standard_normal((2, 4, 6, 12, 5))
    with jax.enable_x64(True):
        want = np.asarray(JW.window_partition_v2(jnp.asarray(x), window))
    got = W.window_partition_v2(to_torch(x), window)
    np.testing.assert_array_equal(got.numpy(), want)
    tm = W.window_partition_v2_tm(to_torch(x).transpose(0, 1), window)
    assert torch.equal(tm, got)


def test_print_parameters_lists_every_leaf_as_jax_does():
    jmod, make = attention_pair(True, False)
    tmod = make()
    x = np.zeros((2, 4, 3, 3, 8))
    params = variables_for(jmod, x, 1)["params"]
    outs = []
    for fn, tree in ((j_print_parameters, params),
                     (print_parameters, tmod)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(tree, prefix="> ")
        outs.append(buf.getvalue().splitlines())
    jlines, tlines = outs
    assert len(tlines) == len(jlines) == len(list(tmod.parameters()))
    assert all(line.startswith("> ") for line in tlines)
    size = lambda lines: sum(int(ln.rsplit("= ", 1)[1])  # noqa: E731
                             for ln in lines)
    assert size(tlines) == size(jlines) == sum(
        p.numel() for p in tmod.parameters())
    assert "> proj_sn_in.weight: (2, 2) = 4" in tlines
