"""Resizes on channels-last [..., H, W, C], mirrors of
``sdformerflow_tpu/ops/interpolate.py``.

``resize_nearest``: the source index is ``floor(dst * (in / out))``
computed in float32, clipped to the input extent (torch's legacy
'nearest'). ``resize_bilinear``: half-pixel centers, edge clamp
(``F.interpolate(mode="bilinear", align_corners=False)``, the definition
``jax.image.resize`` also has when it upsamples; with ``antialias`` its
definition when it downsamples too, a triangle filter widened by the
scale).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _src_index(n_in: int, n_out: int, device) -> torch.Tensor:
    ratio = torch.tensor(n_in / n_out, dtype=torch.float32, device=device)
    pos = torch.arange(n_out, dtype=torch.float32, device=device) * ratio
    return torch.floor(pos).long().clamp(0, n_in - 1)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of [..., H, W, C] to [..., out_h, out_w, C]."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    x = x.index_select(-3, _src_index(h, oh, x.device))
    return x.index_select(-2, _src_index(w, ow, x.device))


def resize_bilinear(x: torch.Tensor, out_hw,
                    antialias: bool = False) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C] to [..., out_h, out_w, C]."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = F.interpolate(x.reshape(-1, h, w, c).permute(0, 3, 1, 2),
                      size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=antialias)
    return y.permute(0, 2, 3, 1).reshape(*lead, *out_hw, c)
