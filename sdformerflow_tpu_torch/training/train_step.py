"""The eval step, a mirror of ``sdformerflow_tpu/training/train_step.py:
make_eval_step`` (voxel chunks, running-stats BN). The train step arrives
with the train slice.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from ..ops.normalization import encode_input


def cast_params(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every parameter to ``dtype`` in place; buffers (the BN running
    statistics) keep their float32, as ``make_eval_step`` keeps
    ``batch_stats``."""
    for p in model.parameters():
        p.data = p.data.to(dtype)
    return model


def make_eval_step(model: nn.Module, *, encoding="voxel", polarity=True,
                   norm_input="minmax", spike_th=None, compute_dtype=None):
    """Return ``eval_step(chunk) -> [flow]`` (coarse -> fine, float32).

    ``chunk``: [B, bins, H, W] signed voxels (or [B, bins, 2, H, W]) on the
    model's device. The input is encoded in its own dtype, then params and
    activations run in ``compute_dtype`` (bf16 is the serving path) on a
    copy of ``model``, BN statistics in float32.
    """
    if compute_dtype is not None:
        model = cast_params(copy.deepcopy(model), compute_dtype)
    model.eval()

    def eval_step(chunk: torch.Tensor):
        with torch.inference_mode():
            x = encode_input(chunk, encoding=encoding, polarity=polarity,
                             norm_input=norm_input, spike_th=spike_th)
            if compute_dtype is not None:
                x = x.to(compute_dtype)
            return [f.float() for f in model(x)["flow"]]

    eval_step.model = model
    return eval_step
