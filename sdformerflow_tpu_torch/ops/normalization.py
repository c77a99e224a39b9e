"""Input encoding: polarity split and nonzero min-max or std normalization.

Mirror of ``sdformerflow_tpu/ops/normalization.py``. Masked reductions keep
the encode on the device with no host synchronisation.

The normalizations take their statistics over the whole batch, as the
reference and JAX do. Under data parallelism (a ``group`` of ranks, each
holding some rows of the global batch) they are those of every rank's rows,
as JAX's over its sharded batch; ``per_row=True`` takes each row's own
(a served request is normalized on its own, whatever it was batched with).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.multihost import active, all_reduce_sum


def polarity_split(chunk: torch.Tensor) -> torch.Tensor:
    """[B, bins, H, W] signed voxels -> [B, bins, 2, H, W] as
    (relu(x), relu(-x))."""
    return torch.stack((chunk.clamp(min=0), (-chunk).clamp(min=0)), dim=2)


def _sum(t: torch.Tensor, per_row: bool) -> torch.Tensor:
    """The sum over the whole tensor, or over each row (keeping its axes)."""
    if not per_row:
        return t.sum()
    return t.sum(dim=tuple(range(1, t.dim())), keepdim=True)


def normalize_nonzero_minmax(x: torch.Tensor, *, group=None,
                             per_row: bool = False) -> torch.Tensor:
    """Min-max normalize over the nonzero entries only (zeros stay zero);
    with a data-parallel ``group`` over every rank's entries (one
    all-reduce), with ``per_row`` over each row's."""
    mask = x != 0
    big = torch.finfo(x.dtype).max
    if per_row:
        dims = tuple(range(1, x.dim()))
        mn = torch.where(mask, x, big).amin(dim=dims, keepdim=True)
        mx = torch.where(mask, x, -big).amax(dim=dims, keepdim=True)
        any_nonzero = mask.flatten(1).any(dim=1).view(mn.shape)
    else:
        mn = torch.where(mask, x, big).amin()
        mx = torch.where(mask, x, -big).amax()
        any_nonzero = mask.any()
    if active(group):
        ext = torch.stack([-mn, mx, any_nonzero.to(x.dtype)])
        dist.all_reduce(ext, op=dist.ReduceOp.MAX, group=group)
        mn, mx, any_nonzero = -ext[0], ext[1], ext[2] > 0
    scale = mx - mn
    ok = any_nonzero & (scale != 0)
    normed = torch.where(mask, (x - mn) / torch.where(ok, scale, 1.0), x)
    return torch.where(ok, normed, x)


def normalize_nonzero_std(x: torch.Tensor, *, group=None,
                          per_row: bool = False) -> torch.Tensor:
    """Standardize over the nonzero entries only (zeros stay zero), with
    torch's unbiased ``.std()``; a count of 0 or 1 leaves ``x`` as it is
    (its std is not > 0). With a data-parallel ``group`` the count, mean
    and variance are every rank's (two all-reduces), with ``per_row``
    each row's."""
    mask = x != 0
    count = _sum(mask, per_row)
    total = _sum(torch.where(mask, x, 0.0), per_row)
    if active(group):
        both = all_reduce_sum(torch.stack([count.to(x.dtype), total]), group)
        count, total = both[0], both[1]
    mean = total / count.clamp(min=1)
    dev2 = _sum(torch.where(mask, (x - mean) ** 2, 0.0), per_row)
    var = all_reduce_sum(dev2, group) / (count - 1)
    std = torch.sqrt(var)
    ok = std > 0
    normed = torch.where(mask, (x - mean) / torch.where(ok, std, 1.0), x)
    return torch.where(ok, normed, x)


def spike_binarize(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """Above threshold -> 1, below -> 0; values equal to it pass through
    (reference quirk kept by the JAX package)."""
    x = torch.where(x > threshold, 1.0, x)
    return torch.where(x < threshold, 0.0, x)


def _per_window(norm, chunk: torch.Tensor, windows: int, group,
                per_row: bool) -> torch.Tensor:
    """``norm`` applied to each of ``windows`` equal groups of the bin
    axis (axis 1) on its own: over each row's group with ``per_row``, else
    over the group's entries in every row (and rank)."""
    if windows == 1:
        return norm(chunk, group=group, per_row=per_row)
    B, C = chunk.shape[:2]
    parts = chunk.reshape(B, windows, C // windows, *chunk.shape[2:])
    if per_row:
        out = norm(parts.flatten(0, 1), group=group, per_row=True)
    else:
        out = torch.stack([norm(parts[:, w], group=group)
                           for w in range(windows)], dim=1)
    return out.reshape(chunk.shape)


def encode_input(chunk: torch.Tensor, *, encoding: str = "voxel",
                 polarity: bool = True, norm_input="minmax",
                 spike_th: float | None = None, group=None,
                 per_row: bool = False, windows: int = 1) -> torch.Tensor:
    """polarity split -> nonzero normalize -> optional binarize.

    ``norm_input`` ``"minmax"`` or ``"std"`` normalizes, over the whole
    batch (every rank's rows with a data-parallel ``group``; each row's with
    ``per_row``); any other value (``None``, ``True`` as the STT configs
    set it, ...) leaves the chunk as it is, as JAX's ``encode_input`` does.
    With ``windows`` > 1 the bins are that many consecutive windows (the
    model's ``event_windows``), each normalized on its own, as E-RAFT's
    ``VoxelGrid(normalize=True)`` normalizes each window's grid. Where a
    window's nonzero entries have no spread (std 0, or a single entry),
    E-RAFT subtracts their mean; ``normalize_nonzero_std`` leaves the
    window as it is.

    ``chunk``: [B, bins, H, W] signed voxels (``polarity=True``) or
    [B, bins, 2, H, W]. Returns [B, bins, 2, H, W] (with ``polarity``
    false, a voxel chunk keeps its [B, bins, H, W]: the ANN's input).
    """
    if encoding not in ("voxel", "cnt"):
        raise ValueError(f"unsupported encoding {encoding!r}")
    if encoding == "voxel" and polarity:
        chunk = polarity_split(chunk)
    if norm_input == "minmax":
        chunk = _per_window(normalize_nonzero_minmax, chunk, windows, group,
                            per_row)
    elif norm_input == "std":
        chunk = _per_window(normalize_nonzero_std, chunk, windows, group,
                            per_row)
    if spike_th is not None:
        chunk = spike_binarize(chunk, spike_th)
    return chunk
