"""The host event packer: ctypes bindings of ``csrc/event_ops.cpp``.

A port of ``sdformerflow_tpu/native`` with the same entry points and the
same results. The C++ source is the port's own copy; it is built with g++
at first use (``kernel_build.build_host_library``, into the package's
``_build/``), and a failed build raises: there is no silent fallback. The
numpy forms of the packers stay beside the bindings as plain twins
(:func:`pack_window_plain`, :func:`pack_window_sorted_plain`) for the
tests.

Each packer takes one window's events - DSEC storage dtypes (uint16 x/y,
int64 microsecond t, uint8 p) or anything else, which goes through the
float32 entry after rebasing t in float64 - and writes fixed-capacity
float32 buffers plus a valid mask, the layout the device voxelizer reads.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .kernel_build import load_host_library

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F32 = ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_host_library("event_ops.cpp")
    signatures = {
        "compute_ms_to_idx": [_P, _I64, _I64, _P],
        "slice_windows": [_P, _I64, _P, _I64, _P, _P],
        "pack_window": [_P] * 4 + [_I64] * 3 + [_P] * 5,
        "pack_window_f32": [_P] * 4 + [_I64, _F32, _I64] + [_P] * 5,
        "pack_window_sorted": [_P] * 4 + [_I64] * 4 + [_P] * 5,
        "pack_window_sorted_f32": [_P] * 4 + [_I64, _F32, _I64, _I64]
        + [_P] * 5,
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def _addr(a: np.ndarray) -> int:
    return a.ctypes.data


def compute_ms_to_idx(t_us, n_ms: int) -> np.ndarray:
    """ms_to_idx[ms] = first index with t_us >= ms * 1000 over a sorted
    microsecond stream (the reference's ``compute_ms_to_idx``)."""
    t_us = np.ascontiguousarray(t_us, np.int64)
    out = np.empty(n_ms, np.int64)
    _lib().compute_ms_to_idx(_addr(t_us), t_us.size, n_ms, _addr(out))
    return out


def slice_windows(t_us, bounds_us):
    """(lo, hi) index pairs of the W windows cut from a sorted stream by
    W + 1 boundaries (microseconds): one O(n + W) pass."""
    t_us = np.ascontiguousarray(t_us, np.int64)
    bounds_us = np.ascontiguousarray(bounds_us, np.int64)
    w = bounds_us.size - 1
    lo = np.empty(w, np.int64)
    hi = np.empty(w, np.int64)
    _lib().slice_windows(_addr(t_us), t_us.size, _addr(bounds_us), w,
                         _addr(lo), _addr(hi))
    return lo, hi


def _is_storage(x, y, t, p) -> bool:
    return (x.dtype == np.uint16 and y.dtype == np.uint16
            and t.dtype == np.int64 and p.dtype in (np.uint8, np.bool_))


def _t_offset(t, t0, n) -> float:
    return float(t[0]) if (t0 is None and n) else float(t0 or 0.0)


def _pack(storage_entry, f32_entry, x, y, t, p, cap, t0, out, *extra):
    x, y, t, p = (np.asarray(a) for a in (x, y, t, p))
    n = len(x)
    if any(a.ndim != 1 or len(a) != n for a in (x, y, t, p)):
        # the C entries read n values of each array
        raise ValueError(f"x/y/t/p must be 1-D of one length, got shapes "
                         f"{[a.shape for a in (x, y, t, p)]}")
    if out is None:
        rows = [np.empty(cap, np.float32) for _ in range(4)]
    else:
        if (out.shape != (5, cap) or out.dtype != np.float32
                or not out.flags.c_contiguous):
            raise ValueError(f"out must be a C-contiguous float32 array of "
                             f"shape (5, {cap}), got {out.dtype} "
                             f"{out.shape}")
        rows = [out[i] for i in range(4)]
    valid = np.empty(cap, np.uint8)
    outs = [_addr(r) for r in rows] + [_addr(valid)]
    if _is_storage(x, y, t, p):
        t0i = int(t[0]) if (t0 is None and n) else int(t0 or 0)
        xs, ys, ts = (np.ascontiguousarray(a) for a in (x, y, t))
        ps = np.ascontiguousarray(p, np.uint8)
        storage_entry(_addr(xs), _addr(ys), _addr(ts), _addr(ps), n, t0i,
                      cap, *extra, *outs)
    else:
        xs, ys, ps = (np.ascontiguousarray(a, np.float32) for a in (x, y, p))
        # rebase t in float64 BEFORE narrowing: absolute microsecond stamps
        # (~1e9) lose their resolution in float32
        ts = np.ascontiguousarray(
            np.asarray(t, np.float64) - _t_offset(t, t0, n), np.float32)
        f32_entry(_addr(xs), _addr(ys), _addr(ts), _addr(ps), n, 0.0, cap,
                  *extra, *outs)
    if out is not None:
        out[4] = valid
    return (*rows, valid.astype(bool))


def pack_window(x, y, t, p, cap: int, t0=None, out=None):
    """Pad or truncate one window's events into float32 buffers of length
    ``cap`` plus a bool valid mask: (x, y, t, p, valid), t relative to
    ``t0`` (default: the first event). With ``out``, a C-contiguous float32
    [5, cap] array, x/y/t/p/valid are written into its rows (valid as
    0/1) and the first four returned arrays are views of it."""
    lib = _lib()
    return _pack(lib.pack_window, lib.pack_window_f32, x, y, t, p, cap, t0,
                 out)


def pack_window_sorted(x, y, t, p, cap: int, height: int, t0=None,
                       out=None):
    """:func:`pack_window`, with the events grouped by the row key
    g = clip(trunc(y), -1, height - 1) + 1 (stable counting sort) and the
    padded tail at y = height: the layout a row-banded voxelizer takes
    with ``presorted=True``."""
    lib = _lib()
    return _pack(lib.pack_window_sorted, lib.pack_window_sorted_f32, x, y,
                 t, p, cap, t0, out, height)


def pack_window_plain(x, y, t, p, cap: int, t0=None):
    """Plain numpy twin of :func:`pack_window`."""
    x, y, t, p = (np.asarray(a) for a in (x, y, t, p))
    n = len(x)
    m = min(n, cap)
    ox, oy, ot, op = (np.zeros(cap, np.float32) for _ in range(4))
    for buf, src in ((ox, x), (oy, y), (op, p)):
        buf[:m] = np.asarray(src[:m], np.float32)
    ot[:m] = (np.asarray(t[:m], np.float64)
              - _t_offset(t, t0, n)).astype(np.float32)
    valid = np.zeros(cap, bool)
    valid[:m] = True
    return ox, oy, ot, op, valid


def pack_window_sorted_plain(x, y, t, p, cap: int, height: int, t0=None):
    """Plain numpy twin of :func:`pack_window_sorted`: pack, then
    stable-sort the valid prefix by the row key."""
    ox, oy, ot, op, valid = pack_window_plain(x, y, t, p, cap, t0=t0)
    m = int(valid.sum())
    key = np.clip(np.trunc(oy[:m].astype(np.float64)), -1, height - 1)
    order = np.argsort(key, kind="stable")
    for buf in (ox, oy, ot, op):
        buf[:m] = buf[:m][order]
    oy[m:] = float(height)
    return ox, oy, ot, op, valid
