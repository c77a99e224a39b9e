"""Skip-connection join with centered zero padding (channels-last).

Mirror of ``sdformerflow_tpu/ops/pad.py:skip_concat``.
"""

from __future__ import annotations

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
