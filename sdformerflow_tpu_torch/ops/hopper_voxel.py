"""K3: event -> voxel-grid scatter-add, CUDA C++ on Hopper.

Replaces the Pallas TPU kernel ``sdformerflow_tpu/ops/pallas_voxel.py``
(``_voxel_kernel`` via ``_accumulate_core``). The four entries have the
signatures of the JAX package's Pallas entries and reach the one kernel
``csrc/voxel.cu``, in the mode of their grid. What bounds it and what the
design does about that is in the source note of ``csrc/voxel.cu``.

The kernel is order-free (one thread per event, float atomics into the
final grid), so ``presorted`` is accepted for the JAX signature and has no
effect: the server packs events unsorted (``native.pack_window``).

Dispatch: a CUDA tensor launches the kernel (or the call raises), a CPU
tensor runs the plain twin of ``ops/voxel.py``. Events carry no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernel_build import load_cuda_library
from . import voxel

_MODES = {"signed": 0, "polarities": 1, "v2": 2, "frames": 3}


@functools.cache
def _kernel_fn():
    fn = load_cuda_library("voxel.cu").voxel_scatter
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def voxel_k3(x, y, t, p, *, mode, num_bins, height, width, valid=None,
             t_range=None):
    """Launch K3 on CUDA tensors: float32 [N] events and an optional bool
    [N] ``valid`` -> the float32 grid of ``mode`` ("signed", "polarities",
    "v2" before normalization, or "frames" with ``num_bins`` frames)."""
    events = (x, y, t, p)
    if not all(isinstance(e, torch.Tensor) and e.is_cuda for e in events):
        raise ValueError("K3 runs on CUDA tensors only")
    dev = x.device
    n = x.shape[0] if x.dim() == 1 else -1
    for name, e in zip("xytp", events):
        if e.dtype != torch.float32:
            raise TypeError(f"K3 takes float32 events, got {name} {e.dtype}")
        if e.dim() != 1 or e.shape[0] != n:
            raise ValueError(f"K3 takes [N] events, got {name} "
                             f"{tuple(e.shape)} beside x {tuple(x.shape)}")
        if not e.is_contiguous():
            raise ValueError(f"K3 takes contiguous events, {name} is not")
        if e.device != dev:
            raise ValueError("K3 events must share one device")
    if valid is not None:
        if (valid.dtype != torch.bool or valid.shape != x.shape
                or not valid.is_contiguous() or valid.device != dev):
            raise ValueError("K3 valid must be a contiguous bool [N] tensor "
                             "on the events' device")
    if n == 0:
        raise ValueError("K3 needs at least one event slot")
    tr = torch.stack(voxel._t_range(t, t_range))  # [2] on the device
    if mode in ("polarities", "frames"):
        shape = (num_bins, 2, height, width)
    else:
        shape = (num_bins, height, width)
    out = torch.zeros(shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _kernel_fn()(
            x.data_ptr(), y.data_ptr(), t.data_ptr(), p.data_ptr(),
            None if valid is None else valid.data_ptr(), tr.data_ptr(),
            out.data_ptr(), n, _MODES[mode], num_bins, height, width,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 (voxel_scatter) launch failed: CUDA error "
                           f"{err}")
    voxel_k3.launches += 1
    return out


voxel_k3.launches = 0


def voxel_grid_signed_k3(x, y, t, p, *, num_bins, height, width, valid=None,
                         t_range=None, presorted=False):
    """Signed trilinear voxel grid [num_bins, H, W]: K3 for CUDA tensors,
    :func:`ops.voxel.voxel_grid_signed` for CPU tensors."""
    del presorted  # order-free kernel
    if x.device.type == "cpu":
        return voxel.voxel_grid_signed(
            x, y, t, p, num_bins=num_bins, height=height, width=width,
            valid=valid, t_range=t_range)
    return voxel_k3(x, y, t, p, mode="signed", num_bins=num_bins,
                    height=height, width=width, valid=valid, t_range=t_range)


def voxel_grid_polarities_k3(x, y, t, p, *, num_bins, height, width,
                             valid=None, t_range=None, presorted=False):
    """Per-polarity trilinear voxel grid [num_bins, 2, H, W]."""
    del presorted
    if x.device.type == "cpu":
        return voxel.voxel_grid_polarities(
            x, y, t, p, num_bins=num_bins, height=height, width=width,
            valid=valid, t_range=t_range)
    return voxel_k3(x, y, t, p, mode="polarities", num_bins=num_bins,
                    height=height, width=width, valid=valid, t_range=t_range)


def events_to_voxel_grid_v2_k3(x, y, t, p, *, num_bins, height, width,
                               valid=None, t_range=None, normalize=True,
                               presorted=False):
    """e2vid-style voxel grid [num_bins, H, W], normalized over its nonzero
    entries unless ``normalize`` is False."""
    del presorted
    if x.device.type == "cpu":
        return voxel.events_to_voxel_grid_v2(
            x, y, t, p, num_bins=num_bins, height=height, width=width,
            valid=valid, t_range=t_range, normalize=normalize)
    grid = voxel_k3(x, y, t, p, mode="v2", num_bins=num_bins, height=height,
                    width=width, valid=valid, t_range=t_range)
    return voxel.normalize_nonzero_std(grid) if normalize else grid


def events_to_frames_k3(x, y, t, p, *, num_frames, height, width,
                        valid=None, t_range=None, presorted=False):
    """Per-frame bilinear ON/OFF count frames [num_frames, 2, H, W]."""
    del presorted
    if x.device.type == "cpu":
        return voxel.events_to_frames(
            x, y, t, p, num_frames=num_frames, height=height, width=width,
            valid=valid, t_range=t_range)
    return voxel_k3(x, y, t, p, mode="frames", num_bins=num_frames,
                    height=height, width=width, valid=valid, t_range=t_range)
