"""PyTorch port vs the JAX package: the raw-events path on the CPU.

The event packer (the port's own copy of ``native/event_ops.cpp``, built
here with g++) must give the JAX package's arrays exactly; ``voxelize_batch``
agrees with the JAX one to float32 rounding (1e-5); and the events eval step
(voxelize at sensor resolution -> center crop -> encode -> forward) matches
JAX ``make_eval_step(voxelize=..., crop=...)`` in float64 on events whose
voxel grids are exact (coordinates on a 1/4 grid), to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu import native as j_native
from sdformerflow_tpu.ops.normalization import encode_input as j_encode
from sdformerflow_tpu.training.train_step import TrainState
from sdformerflow_tpu.training.train_step import make_eval_step as j_eval_step
from sdformerflow_tpu.training.train_step import (
    voxelize_batch as j_voxelize_batch)
from sdformerflow_tpu_torch import native
from sdformerflow_tpu_torch.ops.voxel import pad_events
from sdformerflow_tpu_torch.training.train_step import (make_eval_step,
                                                        voxelize_batch)

from torch_port_harness import flownet_pair, init_pair, to_torch
from torch_port_harness import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(0)
    n = 20_000
    t = np.sort(rng.integers(0, 2_000_000, n)).astype(np.int64)
    x = rng.integers(0, 640, n).astype(np.uint16)
    y = rng.integers(0, 480, n).astype(np.uint16)
    p = rng.integers(0, 2, n).astype(np.uint8)
    return x, y, t, p


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["storage", "f32", "absolute_i64"])
@pytest.mark.parametrize("cap", [32_768, 4_096])   # cap < n truncates
@pytest.mark.parametrize("sort", [False, True])
def test_packer_matches_jax(stream, kind, cap, sort):
    x, y, t, p = (a[:10_000] for a in stream)
    t0 = None
    if kind == "f32":
        x, y, p = (a.astype(np.float32) for a in (x, y, p))
        t, t0 = t.astype(np.float32), 0.0
    elif kind == "absolute_i64":   # float x -> the f32 entry, t rebased
        x = x.astype(np.float32) + 0.25
        t = t + 1_700_000_000_000
    if sort:
        got = native.pack_window_sorted(x, y, t, p, cap, 480, t0=t0)
        want = j_native.pack_window_sorted(x, y, t, p, cap, height=480,
                                           t0=t0)
        plain = native.pack_window_sorted_plain(x, y, t, p, cap, 480, t0=t0)
    else:
        got = native.pack_window(x, y, t, p, cap, t0=t0)
        want = j_native.pack_window(x, y, t, p, cap, t0=t0)
        plain = native.pack_window_plain(x, y, t, p, cap, t0=t0)
    _same(got, want)
    _same(plain, want)
    assert got[4].sum() == min(cap, 10_000)


def test_packer_writes_into_out(stream):
    x, y, t, p = (a[:3000] for a in stream)
    out = np.full((5, 4096), np.nan, np.float32)
    got = native.pack_window(x, y, t, p, 4096, t0=0, out=out)
    want = j_native.pack_window(x, y, t, p, 4096, t0=0)
    _same(got, want)
    for i in range(4):
        assert np.shares_memory(got[i], out)
        np.testing.assert_array_equal(out[i], want[i])
    np.testing.assert_array_equal(out[4], want[4].astype(np.float32))
    with pytest.raises(ValueError):
        native.pack_window(x, y, t, p, 4096, out=np.zeros((5, 4096)))


def test_stream_indexing_matches_jax(stream):
    _, _, t, _ = stream
    np.testing.assert_array_equal(native.compute_ms_to_idx(t, 2001),
                                  j_native.compute_ms_to_idx(t, 2001))
    bounds = np.arange(0, 2_000_001, 100_000, dtype=np.int64)
    for got, want in zip(native.slice_windows(t, bounds),
                         j_native.slice_windows(t, bounds)):
        np.testing.assert_array_equal(got, want)


def _padded_batch(n_max, h, w, t_hi, seed, dyadic):
    """Two padded event buffers of different fill, [2, n_max] each."""
    rng = np.random.default_rng(seed)
    rows = []
    for n in (n_max - 37, n_max // 2):
        if dyadic:
            # 1/4 grid incl. (-1, 0) and beyond the frame; integer t with
            # both ends present, so t_n lands on a 1/4 grid too
            x = rng.integers(-4, 4 * w + 4, n) * 0.25
            y = rng.integers(-4, 4 * h + 4, n) * 0.25
            t = rng.integers(0, t_hi + 1, n).astype(np.float64)
            t[:2] = 0, t_hi
        else:
            x = rng.uniform(-1.5, w + 0.5, n)
            y = rng.uniform(-1.5, h + 0.5, n)
            t = np.sort(rng.uniform(0, t_hi, n))
        p = rng.integers(0, 2, n)
        rows.append(pad_events(*(a.astype(np.float32) for a in (x, y, t, p)),
                               n_max))
    return {k: np.stack([r[i] for r in rows])
            for i, k in enumerate(("x", "y", "t", "p", "valid"))}


def test_voxelize_batch_matches_jax():
    ev = _padded_batch(1500, 20, 28, 1.0, seed=1, dyadic=False)
    want = np.asarray(j_voxelize_batch({k: jnp.asarray(v)
                                        for k, v in ev.items()},
                                       num_bins=5, height=20, width=28))
    got = voxelize_batch({k: to_torch(v) for k, v in ev.items()},
                         num_bins=5, height=20, width=28, presorted=True)
    assert got.shape == want.shape == (2, 5, 20, 28)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(want[1]).sum() > 0


def test_events_eval_step_matches_jax_f64():
    geo = dict(size=(24, 32), depths=(1, 1), heads=(2, 2), window=(2, 3, 3),
               num_steps=4, num_bins=4, base=16)
    sensor, bins = (30, 40), geo["num_bins"]
    jmodel, tmodel = flownet_pair(**geo)
    ev = _padded_batch(900, *sensor, t_hi=4 * (bins - 1), seed=2,
                       dyadic=True)
    voxelize = dict(num_bins=bins, height=sensor[0], width=sensor[1])
    with jax.enable_x64(True):
        sample = np.zeros((1, bins) + geo["size"])
        x_enc = np.asarray(j_encode(jnp.asarray(sample)))
        variables = init_pair(jmodel, tmodel, x_enc, seed=7)
        state = TrainState(step=0, params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=(), apply_fn=jmodel.apply, tx=None)
        want = j_eval_step(voxelize=voxelize, crop=geo["size"])(
            state, {k: jnp.asarray(v) for k, v in ev.items()})
        want = [np.asarray(w) for w in want]
    step = make_eval_step(tmodel, compute_dtype=torch.float64,
                          voxelize=voxelize, crop=geo["size"])
    got = step({k: to_torch(v) for k, v in ev.items()})
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] == 2
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0, atol=1e-12)
    # the two windows differ, and the crop is the centre one
    assert not np.array_equal(want[-1][0], want[-1][1])
