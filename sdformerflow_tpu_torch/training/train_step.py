"""The eval step, a mirror of ``sdformerflow_tpu/training/train_step.py:
make_eval_step`` (voxel chunks or raw events, running-stats BN), and
``voxelize_batch``. The train step arrives with the train slice.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from ..ops.hopper_voxel import voxel_grid_signed_k3
from ..ops.normalization import encode_input


def cast_params(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every parameter to ``dtype`` in place; buffers (the BN running
    statistics) keep their float32, as ``make_eval_step`` keeps
    ``batch_stats``."""
    for p in model.parameters():
        p.data = p.data.to(dtype)
    return model


def voxelize_batch(events, *, num_bins, height, width, presorted=False):
    """Padded event buffers -> signed voxel chunks on the events' device:
    dict(x, y, t, p, valid) of [B, N] tensors (x/y/t/p float32, valid
    bool) -> [B, num_bins, H, W] float32, through K3 on the card.

    Each row's ``t_range`` is the span of its valid events, so padding
    slots never stretch it. ``presorted`` is accepted for the JAX signature;
    K3 is order-free and ignores it.
    """
    valid = events["valid"]
    t = events["t"]
    span = torch.stack([torch.where(valid, t, float("inf")).amin(dim=-1),
                        torch.where(valid, t, float("-inf")).amax(dim=-1)],
                       dim=-1)                             # [B, 2]
    return torch.stack([
        voxel_grid_signed_k3(
            events["x"][b], events["y"][b], t[b], events["p"][b],
            num_bins=num_bins, height=height, width=width, valid=valid[b],
            t_range=span[b], presorted=presorted)
        for b in range(t.shape[0])])


def center_crop(chunk: torch.Tensor, crop) -> torch.Tensor:
    """The DSEC eval protocol's center crop of the last two axes (a view)."""
    ch, cw = crop
    H, W = chunk.shape[-2:]
    y0, x0 = (H - ch) // 2, (W - cw) // 2
    return chunk[..., y0:y0 + ch, x0:x0 + cw]


def make_eval_step(model: nn.Module, *, encoding="voxel", polarity=True,
                   norm_input="minmax", spike_th=None, compute_dtype=None,
                   voxelize=None, crop=None):
    """Return ``eval_step(chunk) -> [flow]`` (coarse -> fine, float32).

    ``chunk``: [B, bins, H, W] signed voxels (or [B, bins, 2, H, W]) on the
    model's device. The input is encoded in its own dtype, then params and
    activations run in ``compute_dtype`` (bf16 is the serving path), BN
    statistics in float32. The params are cast on a copy of ``model``,
    unless they have that dtype already.

    With ``voxelize=dict(num_bins, height, width[, presorted])`` the step
    also takes a dict of padded event buffers (x/y/t/p/valid, [B, N]) and
    voxelizes them on their device (:func:`voxelize_batch`). With
    ``crop=(h, w)`` every chunk is center-cropped before encoding: raw
    events arrive at sensor resolution, the model runs on the crop.
    """
    if compute_dtype is not None and any(
            p.dtype != compute_dtype for p in model.parameters()):
        model = cast_params(copy.deepcopy(model), compute_dtype)
    model.eval()

    def eval_step(chunk):
        with torch.inference_mode():
            if voxelize is not None and isinstance(chunk, dict):
                chunk = voxelize_batch(chunk, **voxelize)
            if crop is not None:
                chunk = center_crop(chunk, crop)
            x = encode_input(chunk, encoding=encoding, polarity=polarity,
                             norm_input=norm_input, spike_th=spike_th)
            if compute_dtype is not None:
                x = x.to(compute_dtype)
            return [f.float() for f in model(x)["flow"]]

    eval_step.model = model
    return eval_step
