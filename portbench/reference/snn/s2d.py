"""Space-to-depth (block 2) re-expression of the full-resolution embed head,
a mirror of ``sdformerflow_tpu/ops/s2d.py`` on PyTorch's OIHW kernels.

Space-to-depth relabels 2x2 pixel blocks into channels,
``[..., H, W, C] -> [..., H/2, W/2, 4C]``, channel index
``(bi * 2 + bj) * C + c``. Exactly (a rearrangement of weights):

- a stride-1 3x3 SAME conv becomes a 3x3 SAME conv in block space with the
  kernel ``[4co, 4ci, 3, 3]`` of :func:`s2d_kernel_s1` (original tap row
  r = di + ki - 1 lands in block offset Ki = floor(r / 2) + 1, row bi =
  r mod 2);
- a stride-2 3x3 conv (padding 1) becomes a stride-1 2x2 conv on the s2d
  tensor with asymmetric padding (1, 0), kernel ``[co, 4ci, 2, 2]`` of
  :func:`s2d_kernel_s2`, emitting the half-resolution output in the normal
  layout;
- a per-channel BN affine or bias is tiled by 4 (:func:`tile4`); PSN and
  every per-element op are unchanged (pixels are relabelled, not mixed).
"""

from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [..., H/2, W/2, 4C], channel order (bi, bj, c)."""
    *lead, H, W, C = x.shape
    x = x.reshape(*lead, H // 2, 2, W // 2, 2, C)
    return x.movedim(-4, -3).reshape(*lead, H // 2, W // 2, 4 * C)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    *lead, H, W, C4 = x.shape
    x = x.reshape(*lead, H, W, 2, 2, C4 // 4)
    return x.movedim(-3, -4).reshape(*lead, 2 * H, 2 * W, C4 // 4)


def s2d_kernel_s1(w: torch.Tensor) -> torch.Tensor:
    """OIHW [co, ci, 3, 3] stride-1 SAME kernel -> [4co, 4ci, 3, 3] block
    space kernel: conv then space_to_depth equals space_to_depth then the
    conv with this kernel."""
    co, ci, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"s2d_kernel_s1 takes a 3x3 kernel, got {kh}x{kw}")
    wp = w.new_zeros((4 * co, 4 * ci, 3, 3))
    for di in (0, 1):
        for dj in (0, 1):
            for ki in range(3):
                for kj in range(3):
                    ri, rj = di + ki - 1, dj + kj - 1
                    Ki, bi = ri // 2 + 1, ri % 2
                    Kj, bj = rj // 2 + 1, rj % 2
                    ic, oc = (bi * 2 + bj) * ci, (di * 2 + dj) * co
                    wp[oc:oc + co, ic:ic + ci, Ki, Kj] = w[:, :, ki, kj]
    return wp


def s2d_kernel_s2(w: torch.Tensor) -> torch.Tensor:
    """OIHW [co, ci, 3, 3] stride-2 padding-1 kernel -> [co, 4ci, 2, 2]: the
    conv equals the stride-1 2x2 conv of space_to_depth(x) with padding
    (1, 0) on both axes, output in the normal half-resolution layout."""
    co, ci, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"s2d_kernel_s2 takes a 3x3 kernel, got {kh}x{kw}")
    wp = w.new_zeros((co, 4 * ci, 2, 2))
    for Ki in (0, 1):
        for Kj in (0, 1):
            for bi in (0, 1):
                for bj in (0, 1):
                    ki, kj = 2 * Ki + bi - 1, 2 * Kj + bj - 1
                    if 0 <= ki < 3 and 0 <= kj < 3:
                        ic = (bi * 2 + bj) * ci
                        wp[:, ic:ic + ci, Ki, Kj] = w[:, :, ki, kj]
    return wp


def tile4(v: torch.Tensor) -> torch.Tensor:
    """Per-channel vector [C] -> [4C] in the (block, c) channel order."""
    return v.repeat(4)
