"""Input encoding: polarity split and nonzero min-max or std normalization.

Mirror of ``sdformerflow_tpu/ops/normalization.py``. Masked reductions keep
the encode on the device with no host synchronisation.
"""

from __future__ import annotations

import torch


def polarity_split(chunk: torch.Tensor) -> torch.Tensor:
    """[B, bins, H, W] signed voxels -> [B, bins, 2, H, W] as
    (relu(x), relu(-x))."""
    return torch.stack((chunk.clamp(min=0), (-chunk).clamp(min=0)), dim=2)


def normalize_nonzero_minmax(x: torch.Tensor) -> torch.Tensor:
    """Min-max normalize over the nonzero entries only (zeros stay zero)."""
    mask = x != 0
    big = torch.finfo(x.dtype).max
    mn = torch.where(mask, x, big).amin()
    mx = torch.where(mask, x, -big).amax()
    scale = mx - mn
    ok = mask.any() & (scale != 0)
    normed = torch.where(mask, (x - mn) / torch.where(ok, scale, 1.0), x)
    return torch.where(ok, normed, x)


def normalize_nonzero_std(x: torch.Tensor) -> torch.Tensor:
    """Standardize over the nonzero entries only (zeros stay zero), with
    torch's unbiased ``.std()``; a count of 0 or 1 leaves ``x`` as it is
    (its std is not > 0)."""
    mask = x != 0
    count = mask.sum()
    mean = torch.where(mask, x, 0.0).sum() / count.clamp(min=1)
    var = torch.where(mask, (x - mean) ** 2, 0.0).sum() / (count - 1)
    std = torch.sqrt(var)
    ok = std > 0
    normed = torch.where(mask, (x - mean) / torch.where(ok, std, 1.0), x)
    return torch.where(ok, normed, x)


def spike_binarize(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """Above threshold -> 1, below -> 0; values equal to it pass through
    (reference quirk kept by the JAX package)."""
    x = torch.where(x > threshold, 1.0, x)
    return torch.where(x < threshold, 0.0, x)


def encode_input(chunk: torch.Tensor, *, encoding: str = "voxel",
                 polarity: bool = True, norm_input="minmax",
                 spike_th: float | None = None) -> torch.Tensor:
    """polarity split -> nonzero normalize -> optional binarize.

    ``norm_input`` ``"minmax"`` or ``"std"`` normalizes; any other value
    (``None``, ``True`` as the STT configs set it, ...) leaves the chunk as
    it is, as JAX's ``encode_input`` does.

    ``chunk``: [B, bins, H, W] signed voxels (``polarity=True``) or
    [B, bins, 2, H, W]. Returns [B, bins, 2, H, W] (with ``polarity``
    false, a voxel chunk keeps its [B, bins, H, W]: the ANN's input).
    """
    if encoding not in ("voxel", "cnt"):
        raise ValueError(f"unsupported encoding {encoding!r}")
    if encoding == "voxel" and polarity:
        chunk = polarity_split(chunk)
    if norm_input == "minmax":
        chunk = normalize_nonzero_minmax(chunk)
    elif norm_input == "std":
        chunk = normalize_nonzero_std(chunk)
    if spike_th is not None:
        chunk = spike_binarize(chunk, spike_th)
    return chunk
