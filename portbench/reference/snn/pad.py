"""Skip-connection joins with centered zero padding and the pad-to-
divisible helper (channels-last).

Mirror of ``sdformerflow_tpu/ops/pad.py``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _pad_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Zero-pad (or crop, for negative deltas) x1's H/W to x2's, centered."""
    dy = x2.shape[-3] - x1.shape[-3]
    dx = x2.shape[-2] - x1.shape[-2]
    if dy == 0 and dx == 0:
        return x1
    lo_y, hi_y = dy // 2, dy - dy // 2
    lo_x, hi_x = dx // 2, dx - dx // 2
    h, w = x1.shape[-3], x1.shape[-2]
    x1 = x1[..., max(0, -lo_y):h - max(0, -hi_y),
            max(0, -lo_x):w - max(0, -hi_x), :]
    return F.pad(x1, (0, 0, max(0, lo_x), max(0, hi_x),
                      max(0, lo_y), max(0, hi_y)))


def skip_concat(x1: torch.Tensor, x2: torch.Tensor, dim: int = -1
                ) -> torch.Tensor:
    """Pad x1 to x2's spatial size, then concatenate along ``dim``."""
    return torch.cat([_pad_match(x1, x2), x2], dim=dim)


def skip_sum(x1: torch.Tensor, x2: torch.Tensor, dim=None) -> torch.Tensor:
    """Pad x1 to x2's spatial size, then add."""
    del dim
    return _pad_match(x1, x2) + x2


def optimal_crop_size(max_size: int, factor: int, safety_margin: int = 0
                      ) -> int:
    """Smallest multiple of ``factor`` that is >= max_size."""
    crop = int(factor * math.ceil(max_size / factor))
    return crop + safety_margin * factor


class CropSize:
    """Pad [..., H, W, C] up to sizes divisible by ``factor`` (centered) and
    crop back after the network."""

    def __init__(self, width, height, factor):
        self.height, self.width = height, width
        self.height_crop = optimal_crop_size(height, factor["h"])
        self.width_crop = optimal_crop_size(width, factor["w"])
        self.padding_top = math.ceil(0.5 * (self.height_crop - height))
        self.padding_bottom = math.floor(0.5 * (self.height_crop - height))
        self.padding_left = math.ceil(0.5 * (self.width_crop - width))
        self.padding_right = math.floor(0.5 * (self.width_crop - width))
        cx = math.floor(self.width_crop / 2)
        cy = math.floor(self.height_crop / 2)
        self.ix0 = cx - math.floor(width / 2)
        self.ix1 = cx + math.ceil(width / 2)
        self.iy0 = cy - math.floor(height / 2)
        self.iy1 = cy + math.ceil(height / 2)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        return F.pad(x, (0, 0, self.padding_left, self.padding_right,
                         self.padding_top, self.padding_bottom))

    def crop(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., self.iy0:self.iy1, self.ix0:self.ix1, :]
