"""3D window partition/reverse on time-major features.

Mirror of ``sdformerflow_tpu/ops/windows.py``. The raw row-major refolds
are load-bearing: ``window_partition_v2_tm`` regroups the ravel of
(B, nD, nH, nW, wd, wh, ww, C) into a leading ``wd`` axis exactly as the
reference's ``view(wd, -1, ...)`` does, so the attention's "time" axis is
not the clean window-time axis. ``torch.reshape`` has the same row-major
semantics. The QK attention ignores the shift mask, so ``compute_mask`` is
not needed on this path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def get_window_size(x_size, window_size, shift_size=None):
    """Clamp window/shift to the actual extent when the input is smaller."""
    use_window = list(window_size)
    use_shift = list(shift_size) if shift_size is not None else None
    for i, s in enumerate(x_size):
        if s <= window_size[i]:
            use_window[i] = s
            if use_shift is not None:
                use_shift[i] = 0
    if use_shift is None:
        return tuple(use_window)
    return tuple(use_window), tuple(use_shift)


def window_partition_v2_tm(x: torch.Tensor, window_size) -> torch.Tensor:
    """[D, B, H, W, C] -> [wd, B*nW, wh, ww, C] (raw refold)."""
    D, B, H, W, C = x.shape
    wd, wh, ww = window_size
    x = x.reshape(D // wd, wd, B, H // wh, wh, W // ww, ww, C)
    x = x.permute(2, 0, 3, 5, 1, 4, 6, 7)  # B, nD, nH, nW, wd, wh, ww, C
    return x.reshape(wd, -1, wh, ww, C)


def window_reverse_tm(windows: torch.Tensor, window_size, B, D, H, W
                      ) -> torch.Tensor:
    """Inverse of :func:`window_partition_v2_tm`:
    [wd, B*nW, wh, ww, C] -> [D, B, H, W, C]."""
    wd, wh, ww = window_size
    x = windows.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, -1)
    x = x.permute(1, 4, 0, 2, 5, 3, 6, 7)  # nD, wd, B, nH, wh, nW, ww, C
    return x.reshape(D, B, H, W, -1)


def pad_to_windows_tm(x: torch.Tensor, window_size):
    """Zero-pad [D, B, H, W, C] so D/H/W are window multiples."""
    D, B, H, W, C = x.shape
    wd, wh, ww = window_size
    pad_d = (wd - D % wd) % wd
    pad_h = (wh - H % wh) % wh
    pad_w = (ww - W % ww) % ww
    if pad_d or pad_h or pad_w:
        # F.pad lists (before, after) pairs from the last axis backwards
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h, 0, 0, 0, pad_d))
    return x, (D, H, W)
