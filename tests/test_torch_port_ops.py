"""PyTorch port vs the JAX package: tensor ops and the PSN kernel's twin.

Inputs are drawn with numpy from fixed seeds and fed to both frameworks.
Layout ops must agree exactly (float32); encode_input agrees in float64 to
1e-15 (one division each side); spikes must be identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sdformerflow_tpu.ops import interpolate as j_interp
from sdformerflow_tpu.ops import neurons as j_neurons
from sdformerflow_tpu.ops import normalization as j_norm
from sdformerflow_tpu.ops import pad as j_pad
from sdformerflow_tpu.ops import pallas_psn as j_psn
from sdformerflow_tpu.ops import windows as j_win
from sdformerflow_tpu.models.spiking_patch_embed import (
    sfn_regroup as j_sfn_regroup)
from sdformerflow_tpu_torch.models.spiking_patch_embed import sfn_regroup
from sdformerflow_tpu_torch.ops import hopper_psn, interpolate, neurons
from sdformerflow_tpu_torch.ops import normalization, pad, windows

from torch_port_harness import to_torch
from torch_port_harness import one_torch_thread  # noqa: F401


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("shape,window,shift", [
    ((10, 1, 12, 16, 8), (2, 3, 3), (1, 1, 1)),
    ((4, 2, 7, 10, 6), (2, 3, 4), (0, 0, 0)),
    ((10, 1, 3, 4, 5), (2, 3, 3), (1, 1, 1)),   # clamped window
])
def test_windows_match_jax(shape, window, shift):
    x = _rand(shape, 0)
    D, B, H, W, _ = shape
    ws, ss = windows.get_window_size((D, H, W), window, shift)
    assert (ws, ss) == j_win.get_window_size((D, H, W), window, shift)
    padded, orig = windows.pad_to_windows_tm(to_torch(x), ws)
    j_padded, j_orig = j_win.pad_to_windows_tm(jnp.asarray(x), ws)
    assert orig == j_orig
    np.testing.assert_array_equal(padded.numpy(), np.asarray(j_padded))
    part = windows.window_partition_v2_tm(padded, ws)
    j_part = j_win.window_partition_v2_tm(j_padded, ws)
    np.testing.assert_array_equal(part.numpy(), np.asarray(j_part))
    Dp, _, Hp, Wp, _ = padded.shape
    back = windows.window_reverse_tm(part, ws, B, Dp, Hp, Wp)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_win.window_reverse_tm(j_part, ws, B, Dp,
                                                         Hp, Wp)))
    np.testing.assert_array_equal(back.numpy(), padded.numpy())


def test_encode_input_matches_jax_f64():
    rng = np.random.default_rng(1)
    chunk = rng.standard_normal((2, 10, 6, 8)) * (rng.random((2, 10, 6, 8))
                                                  < 0.4)
    with jax.enable_x64(True):
        want = np.asarray(j_norm.encode_input(jnp.asarray(chunk)))
        want_th = np.asarray(j_norm.encode_input(jnp.asarray(chunk),
                                                 spike_th=0.5))
        want_zero = np.asarray(j_norm.encode_input(jnp.zeros((1, 2, 3, 3))))
        want_std = np.asarray(j_norm.encode_input(jnp.asarray(chunk),
                                                  norm_input="std"))
        one = np.zeros((1, 1, 3, 3))
        one[0, 0, 1, 1] = 0.5
        want_one = np.asarray(j_norm.encode_input(jnp.asarray(one),
                                                  norm_input="std"))
        want_l2 = np.asarray(j_norm.encode_input(jnp.asarray(chunk),
                                                 norm_input="l2"))
    got = normalization.encode_input(to_torch(chunk)).numpy()
    assert got.shape == (2, 10, 2, 6, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(
        normalization.encode_input(to_torch(chunk), spike_th=0.5).numpy(),
        want_th)
    np.testing.assert_array_equal(
        normalization.encode_input(torch.zeros(1, 2, 3, 3,
                                               dtype=torch.float64)).numpy(),
        want_zero)
    np.testing.assert_allclose(
        normalization.encode_input(to_torch(chunk), norm_input="std").numpy(),
        want_std, rtol=0, atol=1e-14)
    np.testing.assert_array_equal(    # one nonzero value: its std is nan
        normalization.encode_input(to_torch(one), norm_input="std").numpy(),
        want_one)
    # any other norm_input leaves the chunk as it is, as in JAX
    np.testing.assert_array_equal(
        normalization.encode_input(to_torch(chunk), norm_input="l2").numpy(),
        want_l2)


@pytest.mark.parametrize("src,dst", [((72, 96), (288, 384)), ((5, 7), (12, 15)),
                                     ((9, 12), (4, 5))])
def test_resize_nearest_matches_jax(src, dst):
    x = _rand((2, *src, 3), 2)
    np.testing.assert_array_equal(
        interpolate.resize_nearest(to_torch(x), dst).numpy(),
        np.asarray(j_interp.resize_nearest(jnp.asarray(x), dst)))


@pytest.mark.parametrize("a,b", [((3, 4), (3, 4)), ((3, 4), (6, 9)),
                                 ((7, 8), (4, 5))])
def test_skip_concat_matches_jax(a, b):
    x1, x2 = _rand((2, 1, *a, 3), 3), _rand((2, 1, *b, 5), 4)
    np.testing.assert_array_equal(
        pad.skip_concat(to_torch(x1), to_torch(x2)).numpy(),
        np.asarray(j_pad.skip_concat(jnp.asarray(x1), jnp.asarray(x2))))


def test_sfn_regroup_matches_jax():
    x = _rand((2, 10, 2, 4, 5), 5)
    np.testing.assert_array_equal(
        sfn_regroup(to_torch(x), 10).numpy(),
        np.asarray(j_sfn_regroup(jnp.asarray(x), 10)))


def test_psn_neuron_matches_jax_f64():
    x, w, b = (_rand(s, i, np.float64)
               for i, s in enumerate([(10, 3, 5, 7), (10, 10), (10, 1)]))
    with jax.enable_x64(True):
        want = np.asarray(j_neurons.psn_neuron(jnp.asarray(x), jnp.asarray(w),
                                               jnp.asarray(b)))
    got = neurons.psn_neuron(to_torch(x), to_torch(w), to_torch(b))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1


@pytest.fixture
def _pallas_interpret(monkeypatch):
    # the JAX package's own CPU recipe (tests/test_pallas_psn.py)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("affine", [False, True])
def test_psn_kernel_twin_matches_jax_pallas(_pallas_interpret, affine):
    """K2's twin (and its CPU dispatch) vs the JAX Pallas PSN kernel, f32.
    Inputs on power-of-two grids make every f32 sum exact, so the spikes
    must be identical whatever the summation order."""
    rng = np.random.default_rng(9)
    T, M, C = 10, 37, 6
    x = (rng.integers(0, 17, (T, M, C)) * 0.25 - 2).astype(np.float32)
    w = (rng.integers(0, 17, (T, T)) * 0.125 - 1).astype(np.float32)
    b = (rng.integers(0, 9, (T, 1)) * 0.25 - 1).astype(np.float32)
    sc = (rng.integers(0, 8, C) * 0.25 + 0.25).astype(np.float32)
    sh = (rng.integers(0, 9, C) * 0.25 - 1).astype(np.float32)
    if affine:
        flat = x.reshape(T, -1)
        want = j_psn.fused_affine_psn(
            jnp.asarray(flat), jnp.asarray(w), jnp.asarray(b),
            jnp.asarray(np.tile(sc, M)[None]), jnp.asarray(np.tile(sh, M)[None]))
        kw = dict(scale=to_torch(sc), shift=to_torch(sh))
    else:
        want = j_psn.psn_spike(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        kw = {}
    want = np.asarray(want).reshape(T, M, C)
    args = (to_torch(x), to_torch(w), to_torch(b))
    for fire in (hopper_psn.psn_spike, hopper_psn.fused_affine_psn):
        got = fire(*args, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert 0.1 < want.mean() < 0.9


def test_psn_kernel_wrapper_cpu_dispatch_counts_nothing():
    before = hopper_psn.fused_affine_psn.launches
    x = torch.randn(10, 4, 3)
    out = hopper_psn.fused_affine_psn(x, torch.randn(10, 10), torch.randn(10))
    assert out.shape == x.shape
    assert hopper_psn.fused_affine_psn.launches == before
