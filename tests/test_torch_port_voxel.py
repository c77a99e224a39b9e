"""PyTorch port vs the JAX package: the voxelizer's plain forms and K3's
CPU dispatch.

The port's ``ops/voxel.py`` must match the JAX ``ops/voxel.py`` to float32
rounding of the sums (atol 1e-5), and exactly on dyadic events (coordinates
on a 1/4 grid, where every weight and sum is exact). The four K3 entries of
``ops/hopper_voxel.py`` on CPU tensors (their plain twins) must match the
JAX Pallas entries, run in interpret mode as ``tests/test_pallas_voxel.py``
runs them, to 1e-4 (that file's tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu.ops import pallas_voxel as j_pallas
from sdformerflow_tpu.ops import voxel as j_voxel
from sdformerflow_tpu_torch import native
from sdformerflow_tpu_torch.ops import hopper_voxel, voxel

from torch_port_harness import to_torch
from torch_port_harness import one_torch_thread  # noqa: F401

KINDS = {
    # name: (port plain, JAX plain, JAX Pallas, port K3 entry, bins kwarg)
    "signed": (voxel.voxel_grid_signed, j_voxel.voxel_grid_signed,
               j_pallas.voxel_grid_signed_pallas,
               hopper_voxel.voxel_grid_signed_k3, "num_bins"),
    "polarities": (voxel.voxel_grid_polarities, j_voxel.voxel_grid_polarities,
                   j_pallas.voxel_grid_polarities_pallas,
                   hopper_voxel.voxel_grid_polarities_k3, "num_bins"),
    "v2": (voxel.events_to_voxel_grid_v2, j_voxel.events_to_voxel_grid_v2,
           j_pallas.events_to_voxel_grid_v2_pallas,
           hopper_voxel.events_to_voxel_grid_v2_k3, "num_bins"),
    "frames": (voxel.events_to_frames, j_voxel.events_to_frames,
               j_pallas.events_to_frames_pallas,
               hopper_voxel.events_to_frames_k3, "num_frames"),
}


@pytest.fixture
def interpret_mode(monkeypatch):
    real_call = j_pallas.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return real_call(*args, **kwargs)

    monkeypatch.setattr(j_pallas.pl, "pallas_call", interp_call)


def _events(n, h, w, seed, *, margin=1.5, dyadic=False, valid_frac=0.8):
    """x/y up to ``margin`` outside the frame, t in [0, 1], p in {0, 1}.
    Dyadic: x/y/t on a 1/4 grid (t_range (0, 1) then gives t_n on a 1/4
    grid for bins - 1 a power of two, or any bins with t_range (0, bins-1)
    and t on the grid)."""
    rng = np.random.default_rng(seed)
    if dyadic:
        x = rng.integers(int(-4 * margin), int(4 * (w + margin)), n) * 0.25
        y = rng.integers(int(-4 * margin), int(4 * (h + margin)), n) * 0.25
        t = rng.integers(0, 5, n) * 0.25
    else:
        x = rng.uniform(-margin, w - 1 + margin, n)
        y = rng.uniform(-margin, h - 1 + margin, n)
        t = np.sort(rng.uniform(0, 1, n))
    p = rng.integers(0, 2, n)
    valid = rng.uniform(size=n) < valid_frac
    return [a.astype(np.float32) for a in (x, y, t, p)] + [valid]


def _both(kind, ev, h, w, bins, t_range, **extra):
    port, jax_plain = KINDS[kind][0], KINDS[kind][1]
    kw = {KINDS[kind][4]: bins, "height": h, "width": w,
          "t_range": t_range, **extra}
    got = port(*(to_torch(a) for a in ev[:4]), valid=to_torch(ev[4]), **kw)
    want = jax_plain(*(jnp.asarray(a) for a in ev[:4]),
                     valid=jnp.asarray(ev[4]), **kw)
    return got, np.asarray(want)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_voxel_matches_jax(kind):
    h, w, bins = 17, 23, 5
    # the JAX v2 form wraps out-of-frame indices; compare it in the frame
    ev = _events(3000, h, w, seed=1, margin=0.0 if kind == "v2" else 1.5)
    extra = {"normalize": False} if kind == "v2" else {}
    for t_range in ((0.0, 1.0), (0.1, 0.9) if kind != "frames" else None):
        got, want = _both(kind, ev, h, w, bins, t_range, **extra)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert np.abs(want).sum() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if kind == "v2":
        got, want = _both(kind, ev, h, w, bins, (0.0, 1.0))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_voxel_exact_on_dyadic_events(kind):
    h, w, bins = 12, 16, 5
    ev = _events(2000, h, w, seed=2, dyadic=True,
                 margin=0.0 if kind == "v2" else 1.0)
    extra = {"normalize": False} if kind == "v2" else {}
    got, want = _both(kind, ev, h, w, bins, (0.0, 1.0), **extra)
    assert np.abs(want).sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_frames_relu_and_valid():
    """Border events in (-1, 0) keep their in-frame corner with a relu'd
    weight; invalid events count for nothing."""
    h, w, frames = 8, 12, 3
    ev = _events(500, h, w, seed=3, margin=0.99, valid_frac=0.5)
    got, want = _both("frames", ev, h, w, frames, (0.0, 1.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    none = voxel.events_to_frames(*(to_torch(a) for a in ev[:4]),
                                  num_frames=frames, height=h, width=w,
                                  valid=torch.zeros(500, dtype=torch.bool))
    assert not none.any()


def test_normalize_and_pad_match_jax():
    rng = np.random.default_rng(4)
    grid = (rng.standard_normal((4, 6, 7)) * (rng.random((4, 6, 7)) < 0.3)
            ).astype(np.float32)
    np.testing.assert_allclose(
        voxel.normalize_nonzero_std(to_torch(grid)).numpy(),
        np.asarray(j_voxel.normalize_nonzero_std(jnp.asarray(grid))),
        rtol=0, atol=1e-6)
    zero = np.zeros((2, 3, 3), np.float32)
    np.testing.assert_array_equal(
        voxel.normalize_nonzero_std(to_torch(zero)).numpy(), zero)
    ev = [a[:7] for a in _events(7, 4, 4, seed=5)[:4]]
    for got, want in zip(voxel.pad_events(*ev, 16),
                         j_voxel.pad_events(*ev, 16)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        voxel.pad_events(*ev, 4)


def _k3_vs_pallas(kind, ev, h, w, bins, *, presorted=False, **extra):
    kw = {KINDS[kind][4]: bins, "height": h, "width": w,
          "t_range": (0.0, 1.0), **extra}
    valid = ev[4]
    want = KINDS[kind][2](*(jnp.asarray(a) for a in ev[:4]),
                          valid=jnp.asarray(valid), chunk=128,
                          presorted=presorted, **kw)
    before = hopper_voxel.voxel_k3.launches
    got = KINDS[kind][3](*(to_torch(a) for a in ev[:4]),
                         valid=to_torch(valid), presorted=presorted, **kw)
    assert hopper_voxel.voxel_k3.launches == before   # CPU: the twin
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    return np.asarray(want)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_k3_entries_cpu_match_jax_pallas(interpret_mode, kind):
    h, w, bins = 14, 20, 4
    ev = _events(1200, h, w, seed=6, margin=0.0 if kind == "v2" else 1.5)
    extra = {"normalize": True} if kind == "v2" else {}
    want = _k3_vs_pallas(kind, ev, h, w, bins, **extra)
    assert np.abs(want).sum() > 0


def test_k3_presorted_buffers_match_jax_pallas(interpret_mode):
    """presorted=True on pack_window_sorted buffers (the JAX contract); K3
    is order-free, so the flag changes nothing on the port's side."""
    h, w, bins, cap = 16, 24, 5, 2048
    x, y, t, p, _ = _events(1700, h, w, seed=7)
    packed = native.pack_window_sorted(x, y, t, p, cap, h, t0=0.0)
    want = _k3_vs_pallas("signed", packed, h, w, bins, presorted=True)
    assert np.abs(want).sum() > 0
    unsorted = native.pack_window(x, y, t, p, cap, t0=0.0)
    again = hopper_voxel.voxel_grid_signed_k3(
        *(to_torch(a) for a in unsorted[:4]), valid=to_torch(unsorted[4]),
        num_bins=bins, height=h, width=w, t_range=(0.0, 1.0))
    np.testing.assert_allclose(again.numpy(), want, rtol=1e-4, atol=1e-4)


def test_k3_single_row_and_fully_invalid(interpret_mode):
    h, w, bins, n = 12, 16, 3, 700
    x, y, t, p, _ = _events(n, h, w, seed=9, margin=0.0)
    y[:] = 5.25                                         # one row
    ones = np.ones(n, bool)
    want = _k3_vs_pallas("signed", [x, y, t, p, ones], h, w, bins)
    assert np.abs(want[:, 5:7]).sum() > 0
    assert np.abs(want).sum() == np.abs(want[:, 5:7]).sum()
    zero = _k3_vs_pallas("signed", [x, y, t, p, ~ones], h, w, bins)
    assert not zero.any()


def test_k3_kernel_entry_refuses_cpu_tensors():
    ev = [torch.zeros(8) for _ in range(4)]
    with pytest.raises(ValueError, match="CUDA"):
        hopper_voxel.voxel_k3(*ev, mode="signed", num_bins=2, height=4,
                              width=4)
