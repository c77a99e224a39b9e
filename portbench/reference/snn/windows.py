"""3D window partition/reverse, shift masks and relative positions.

Mirror of ``sdformerflow_tpu/ops/windows.py``. The time-major ``_tm``
forms serve the spiking attention; there the raw row-major refolds are
load-bearing: ``window_partition_v2_tm`` regroups the ravel of
(B, nD, nH, nW, wd, wh, ww, C) into a leading ``wd`` axis exactly as the
reference's ``view(wd, -1, ...)`` does, so the attention's "time" axis is
not the clean window-time axis. ``torch.reshape`` has the same row-major
semantics. The spiking QK attention ignores the shift mask. The
channels-last ``[B, D, H, W, C]`` forms, the shift mask and the relative
positions serve the ANN's Swin-3D (``models/ann_swin.py``); the mask and
the positions are numpy constants of the window geometry.
"""

from __future__ import annotations

import numpy as np
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


def window_partition_v2(x: torch.Tensor, window_size) -> torch.Tensor:
    """The reference layout's partition: [B, D, H, W, C] -> [wd, B*nW, wh,
    ww, C] (raw refold); :func:`window_partition_v2_tm` gives the same
    elements from time-major [D, B, H, W, C]."""
    wd, wh, ww = window_size
    return window_partition(x, window_size).reshape(wd, -1, wh, ww,
                                                    x.shape[-1])


def window_partition_v2_tm(x: torch.Tensor, window_size,
                           per_row: bool = False) -> torch.Tensor:
    """[D, B, H, W, C] -> [wd, B*nW, wh, ww, C] (raw refold). The refold
    runs over the whole batch, so at B > 1 the leading ``wd`` axis holds
    different rows (at wd = 2 the first half of the batch, then the second
    half), as the reference's; ``per_row`` refolds each row on its own
    (its batch-1 layout) and stacks the rows' windows row by row."""
    D, B, H, W, C = x.shape
    wd, wh, ww = window_size
    x = x.reshape(D // wd, wd, B, H // wh, wh, W // ww, ww, C)
    x = x.permute(2, 0, 3, 5, 1, 4, 6, 7)  # B, nD, nH, nW, wd, wh, ww, C
    if per_row:
        x = x.reshape(B, wd, -1, wh, ww, C).transpose(0, 1)
    return x.reshape(wd, -1, wh, ww, C)


def window_reverse_tm(windows: torch.Tensor, window_size, B, D, H, W,
                      per_row: bool = False) -> torch.Tensor:
    """Inverse of :func:`window_partition_v2_tm`:
    [wd, B*nW, wh, ww, C] -> [D, B, H, W, C]."""
    wd, wh, ww = window_size
    if per_row:
        windows = windows.reshape(wd, B, -1, wh, ww,
                                  windows.shape[-1]).transpose(0, 1)
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


def window_partition(x: torch.Tensor, window_size) -> torch.Tensor:
    """[B, D, H, W, C] -> [B*nW, wd*wh*ww, C]."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window_size
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, C)


def window_reverse(windows: torch.Tensor, window_size, B, D, H, W
                   ) -> torch.Tensor:
    """[B*nW, wd*wh*ww, C] (any layout reshapeable to it) ->
    [B, D, H, W, C]."""
    wd, wh, ww = window_size
    x = windows.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, -1)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, -1)


def pad_to_windows(x: torch.Tensor, window_size):
    """Zero-pad [B, D, H, W, C] so D/H/W are window multiples; returns
    (padded, (D, H, W))."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window_size
    pad_d = (wd - D % wd) % wd
    pad_h = (wh - H % wh) % wh
    pad_w = (ww - W % ww) % ww
    if pad_d or pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h, 0, pad_d))
    return x, (D, H, W)


def compute_mask(D, H, W, window_size, shift_size) -> np.ndarray:
    """Shifted-window attention mask [nW, N, N] of 0 / -100 (float32)."""
    img_mask = np.zeros((1, D, H, W, 1), np.float32)
    cnt = 0
    for d in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0]),
              slice(-shift_size[0], None)):
        for h in (slice(-window_size[1]),
                  slice(-window_size[1], -shift_size[1]),
                  slice(-shift_size[1], None)):
            for w in (slice(-window_size[2]),
                      slice(-window_size[2], -shift_size[2]),
                      slice(-shift_size[2], None)):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    wd, wh, ww = window_size
    m = img_mask.reshape(1, D // wd, wd, H // wh, wh, W // ww, ww, 1)
    m = m.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww)
    attn_mask = m[:, None, :] - m[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


def relative_position_index(window_size) -> np.ndarray:
    """Pairwise relative-position index [N, N] into a flattened bias table
    of (2wd-1)(2wh-1)(2ww-1) rows."""
    wd, wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh),
                                  np.arange(ww), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


def relative_coords_table(window_size, pretrained_window_size=(0, 0, 0)
                          ) -> np.ndarray:
    """Log-spaced relative coordinates for the swin-v2 CPB MLP:
    [1, 2wd-1, 2wh-1, 2ww-1, 3] float32.

    The reference's quirk is kept: ``table[:, :, :, i] /= (ws[i] - 1)``
    on the 5-D table divides W-offset slices 0-2 (across all three
    coordinates), not the coordinate channels. A divisor of 0 (a window
    of 1) is taken as 1.
    """
    wd, wh, ww = window_size
    rd = np.arange(-(wd - 1), wd, dtype=np.float32)
    rh = np.arange(-(wh - 1), wh, dtype=np.float32)
    rw = np.arange(-(ww - 1), ww, dtype=np.float32)
    table = np.stack(np.meshgrid(rd, rh, rw, indexing="ij"))
    table = table.transpose(1, 2, 3, 0)[None]
    ref = (pretrained_window_size if pretrained_window_size[0] > 0
           else window_size)
    for i in range(3):
        table[:, :, :, i] /= max(ref[i] - 1, 1)
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.astype(np.float32)
