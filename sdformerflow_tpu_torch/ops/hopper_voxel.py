"""K3: event -> voxel-grid scatter-add, CUDA C++ on Hopper.

Replaces the Pallas TPU kernel ``sdformerflow_tpu/ops/pallas_voxel.py``
(``_voxel_kernel`` via ``_accumulate_core``). The four entries have the
signatures of the JAX package's Pallas entries and reach the one kernel
chain of ``csrc/voxel.cu``, in the mode of their grid.

The design (the source note of ``csrc/voxel.cu`` has the details): the
events are sorted by row on the card (a histogram of the H + 1 row keys,
a scan, a scatter of float4 records), then one CTA a tile of the grid sums
its rows' records in shared memory and writes its cells once, so the grid
needs no zero fill and may be a row of the caller's batch
(``training.train_step.voxelize_batch``). :func:`k3_tiles` is the static
tile geometry the launch uses: a band of rows x a slab of planes (bins, or
(bin, channel) pairs) x a slab of columns, sized for at least 2 CTAs an SM.
For windows whose events bunch on a few rows, the card splits a band with
at least twice the mean a band's records into up to 8 shares, each summed
by its own CTA; the last to finish adds up the shares (the split's
constants are ``kMaxSplit`` and ``kMinItem`` in the source).
The sort is done on the card, so ``presorted`` is accepted for the JAX
signature and has no effect: the server packs events unsorted
(``native.pack_window``).

Dispatch: a CUDA tensor launches the kernel (or the call raises), a CPU
tensor runs the plain twin of ``ops/voxel.py``. Events carry no gradient.

A batch of padded event rows is voxelized by :func:`voxel_batch_signed`,
also the custom op ``sdformerflow_torch::voxelize_batch``
(:data:`voxel_batch_signed_op`): it returns a fresh grid, with a fake form
that gives its shape. While ``torch.export`` traces, the batch goes through
the op, so an exported events program carries one op node; the eager call
goes straight to the launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import numbers

import torch

from ..kernel_build import load_cuda_library
from . import voxel

_MODES = {"signed": 0, "polarities": 1, "v2": 2, "frames": 3}
_SPAN_POINTER, _SPAN_ENDS, _SPAN_VALID, _SPAN_VALUES = range(4)

# shared memory a tile may take: 2 CTAs an SM fit the H100's 228 KB (each
# block also holds 1 KB of the system's)
K3_SMEM_BUDGET = 113 * 1024
# rows a band when whole rows fit
K3_ROWS = 2
# the count pass holds the H + 1 row keys' counts in the 48 KB of shared
# memory a block takes without opting in, the scatter pass three arrays of
# them beside its 80 KB of staged events
K3_MAX_ROWS = 6000


@dataclasses.dataclass(frozen=True)
class K3Tiles:
    """The static tiles of one K3 launch: ``rows`` x ``planes`` x ``cols``
    cells of a grid of ``n_planes`` planes of ``height`` x ``width``."""
    rows: int
    planes: int
    cols: int
    n_planes: int
    height: int
    width: int

    @property
    def bands(self) -> int:
        return -(-self.height // self.rows)

    @property
    def plane_slabs(self) -> int:
        return -(-self.n_planes // self.planes)

    @property
    def col_slabs(self) -> int:
        return -(-self.width // self.cols)

    @property
    def n_tiles(self) -> int:
        return self.bands * self.plane_slabs * self.col_slabs

    @property
    def smem_bytes(self) -> int:
        return -(-self.rows * self.planes * self.cols // 4) * 16

    def describe(self) -> str:
        return (f"{self.n_tiles} tiles of {self.rows} rows x {self.planes}/"
                f"{self.n_planes} planes x {self.cols}/{self.width} cols "
                f"({self.smem_bytes / 1024:.1f} KB)")


def grid_planes(mode: str, num_bins: int) -> int:
    """The planes of ``mode``'s grid: one a bin, or two (the polarity
    channels)."""
    if mode not in _MODES:
        raise ValueError(f"K3 mode {mode!r} is not one of {sorted(_MODES)}")
    return num_bins * (2 if mode in ("polarities", "frames") else 1)


def k3_tiles(mode: str, num_bins: int, height: int, width: int, *,
             smem_budget: int = K3_SMEM_BUDGET) -> K3Tiles:
    """The tile geometry of a K3 launch. :data:`K3_ROWS` whole rows of
    every plane (fewer if they do not fit ``smem_budget``); else one row of
    a slab of planes; else one row of one plane, a slab of columns (a
    multiple of 4). Slabs are evened out. A smaller ``smem_budget`` forces
    the plane and column slabs at small shapes (the tests). Raises where no
    tile fits or the frame is taller than the bin pass takes."""
    n_planes = grid_planes(mode, num_bins)
    if min(num_bins, height, width) < 1:
        raise ValueError(f"K3 needs a grid of at least one cell, got "
                         f"{num_bins} x {height} x {width}")
    if height > K3_MAX_ROWS:
        raise ValueError(f"K3 bins events by row in shared memory: at most "
                         f"{K3_MAX_ROWS} rows, got {height}")
    budget = smem_budget // 16 * 16
    tiles = functools.partial(K3Tiles, n_planes=n_planes, height=height,
                              width=width)
    fit = budget // (n_planes * width * 4)
    if fit >= 1:
        return tiles(rows=min(K3_ROWS, fit, height), planes=n_planes,
                     cols=width)
    planes = budget // (width * 4)
    if planes >= 1:
        slabs = -(-n_planes // planes)
        return tiles(rows=1, planes=-(-n_planes // slabs), cols=width)
    cols = budget // 16 * 4
    if cols < 4:
        raise ValueError(f"K3: no tile fits {smem_budget} bytes of shared "
                         f"memory")
    per_slab = -(-width // -(-width // cols))
    return tiles(rows=1, planes=1, cols=(per_slab + 3) // 4 * 4)


@functools.cache
def _lib():
    lib = load_cuda_library("voxel.cu")
    lib.voxel_scatter.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int]
        + [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_int] * 7
        + [ctypes.c_void_p] * 2)
    lib.voxel_scatter.restype = ctypes.c_int
    lib.voxel_workspace_bytes.argtypes = [ctypes.c_int64] + [ctypes.c_int] * 7
    lib.voxel_workspace_bytes.restype = ctypes.c_int64
    return lib


def _check_events(x, y, t, p, valid):
    """The device and length of float32 [N] CUDA events; raises on what
    the kernel does not take."""
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
    if n >= 2 ** 31:
        raise ValueError(f"K3 takes fewer than 2^31 event slots, got {n}")
    return dev, n


def _span_args(t, t_range, valid_span):
    """(span mode, device [2] or None, t0, t1): where the kernel takes the
    time span from."""
    if valid_span:
        if t_range is not None:
            raise ValueError("K3: valid_span replaces t_range")
        return _SPAN_VALID, None, 0.0, 0.0
    if t_range is None:
        return _SPAN_ENDS, None, 0.0, 0.0
    if all(isinstance(v, numbers.Real) for v in t_range):
        return _SPAN_VALUES, None, float(t_range[0]), float(t_range[1])
    tr = torch.stack(voxel._t_range(t, t_range)).contiguous()
    return _SPAN_POINTER, tr, 0.0, 0.0


def prepare_k3(x, y, t, p, *, mode, num_bins, height, width, valid=None,
               t_range=None, valid_span=False, out=None,
               smem_budget=K3_SMEM_BUDGET):
    """Check one K3 launch on CUDA tensors and return ``(launch, out)``:
    each call of ``launch()`` writes the grid of ``mode`` into ``out`` (a
    new tensor unless given: float32, contiguous, the grid's shape) and
    raises if the launch fails; it counts nothing. The time span is
    ``t_range``, else with ``valid_span`` the min and max ``t`` of the
    valid events, else the first and last slot's ``t``. The tiles are
    :func:`k3_tiles` of ``smem_budget``. ``chip_smoke.py`` times
    ``launch``, the kernel alone."""
    dev, n = _check_events(x, y, t, p, valid)
    tiles = k3_tiles(mode, num_bins, height, width, smem_budget=smem_budget)
    shape = ((num_bins, 2, height, width)
             if mode in ("polarities", "frames")
             else (num_bins, height, width))
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    elif (out.dtype != torch.float32 or tuple(out.shape) != shape
          or not out.is_contiguous() or out.device != dev):
        raise ValueError(f"K3 out must be a contiguous float32 {shape} "
                         f"tensor on the events' device")
    span_mode, tr, t0, t1 = _span_args(t, t_range, valid_span)
    lib = _lib()
    plan = (_MODES[mode], num_bins, height, width, tiles.rows, tiles.planes,
            tiles.cols)
    n_bytes = lib.voxel_workspace_bytes(n, *plan)
    if n_bytes < 0:
        raise ValueError(f"K3 refuses the tiles {tiles}")
    ws = torch.empty(n_bytes, dtype=torch.uint8, device=dev)
    args = (x.data_ptr(), y.data_ptr(), t.data_ptr(), p.data_ptr(),
            None if valid is None else valid.data_ptr(),
            None if tr is None else tr.data_ptr(), t0, t1, span_mode,
            out.data_ptr(), n, *plan, ws.data_ptr())
    keep = (x, y, t, p, valid, tr, out, ws)

    def launch():
        with torch.cuda.device(dev):
            err = lib.voxel_scatter(*args,
                                    torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"K3 (voxel_scatter) launch failed: CUDA "
                               f"error {err}")
        return keep   # alive as long as the closure

    return launch, out


def voxel_k3(x, y, t, p, *, mode, num_bins, height, width, valid=None,
             t_range=None, valid_span=False, out=None):
    """Launch K3 on CUDA tensors: float32 [N] events and an optional bool
    [N] ``valid`` -> the float32 grid of ``mode`` ("signed", "polarities",
    "v2" before normalization, or "frames" with ``num_bins`` frames),
    written into ``out`` if given (:func:`prepare_k3`)."""
    launch, out = prepare_k3(x, y, t, p, mode=mode, num_bins=num_bins,
                             height=height, width=width, valid=valid,
                             t_range=t_range, valid_span=valid_span, out=out)
    launch()
    voxel_k3.launches += 1
    return out


voxel_k3.launches = 0


def voxel_grid_signed_k3(x, y, t, p, *, num_bins, height, width, valid=None,
                         t_range=None, presorted=False):
    """Signed trilinear voxel grid [num_bins, H, W]: K3 for CUDA tensors,
    :func:`ops.voxel.voxel_grid_signed` for CPU tensors."""
    del presorted  # the kernel sorts on the card
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


def _voxel_rows(x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                p: torch.Tensor, valid: torch.Tensor, num_bins: int,
                height: int, width: int) -> torch.Tensor:
    """The real implementation of :data:`voxel_batch_signed_op`: K3 once a
    row for CUDA tensors, each launch writing straight into its row of the
    grid; the plain twin for CPU tensors."""
    if t.device.type == "cpu":
        span = torch.stack(
            [torch.where(valid, t, float("inf")).amin(dim=-1),
             torch.where(valid, t, float("-inf")).amax(dim=-1)], dim=-1)
        return torch.stack([
            voxel.voxel_grid_signed(x[b], y[b], t[b], p[b],
                                    num_bins=num_bins, height=height,
                                    width=width, valid=valid[b],
                                    t_range=span[b])
            for b in range(t.shape[0])])
    out = torch.empty((t.shape[0], num_bins, height, width),
                      dtype=torch.float32, device=t.device)
    for b in range(t.shape[0]):
        voxel_k3(x[b], y[b], t[b], p[b], mode="signed", num_bins=num_bins,
                 height=height, width=width, valid=valid[b], valid_span=True,
                 out=out[b])
    return out


voxel_batch_signed_op = torch.library.custom_op(
    "sdformerflow_torch::voxelize_batch", _voxel_rows, mutates_args=())


@voxel_batch_signed_op.register_fake
def _(x, y, t, p, valid, num_bins, height, width):
    return x.new_empty((x.shape[0], num_bins, height, width),
                       dtype=torch.float32)


def voxel_batch_signed(x, y, t, p, valid, *, num_bins, height, width):
    """Padded event rows -> signed voxel grids: x/y/t/p float32 and valid
    bool, [B, N] -> [B, num_bins, H, W] float32, each row's ``t_range`` the
    span of its valid events, so padding slots never stretch it. K3 once a
    row for CUDA tensors, the plain twin for CPU tensors; while traced,
    :data:`voxel_batch_signed_op`."""
    if torch.compiler.is_compiling():
        return voxel_batch_signed_op(x, y, t, p, valid, num_bins, height,
                                     width)
    return _voxel_rows(x, y, t, p, valid, num_bins, height, width)
