"""Event -> voxel-grid rasterization, plain PyTorch forms.

Mirror of ``sdformerflow_tpu/ops/voxel.py``: the reference's trilinear
``put_(accumulate=True)`` scatter-adds as ``index_add_`` into a flat grid,
over fixed-size, possibly padded event buffers. These are the plain twins
of kernel K3 (``ops/hopper_voxel.py``): K3's CPU dispatch runs them, and
``chip_smoke.py`` holds the kernel against them on the card.

All functions take flat event tensors ``x, y, t, p`` of shape ``[N]`` plus
an optional bool ``valid`` mask (padding slots carry no weight), and return
float32 grids. Every weight is rounded in the JAX package's order, so K3,
which rounds each step the same way, differs from these only in the order
of the sums.

Two deviations from the JAX plain forms, both for coordinates the JAX
forms send out of the grid, where its scatter drops or wraps the index:
``events_to_voxel_grid_v2`` drops events whose truncated x/y lie outside
the grid and time corners outside ``[0, num_bins)``, and
``events_to_frames`` drops frame indices outside ``[0, num_frames)``. The
JAX Pallas kernel drops them the same way.
"""

from __future__ import annotations

import numpy as np
import torch


def _t_range(t: torch.Tensor, t_range) -> tuple:
    """(t0, t1) as float32 tensors on ``t``'s device: ``t_range`` is None
    (first and last event), a pair of numbers or 0-d tensors, or a [2]
    tensor. Numbers are filled in on the device: a host-to-device copy of
    a pageable scalar would synchronize the stream."""
    if t_range is None:
        return t[0], t[-1]
    t0, t1 = (v.to(t.device, torch.float32) if isinstance(v, torch.Tensor)
              else torch.full((), v, dtype=torch.float32, device=t.device)
              for v in t_range)
    return t0, t1


def _t_norm(t, num_bins, t_range=None):
    """Timestamps to [0, num_bins - 1] like the reference:
    ``(C - 1) * (t - t_first) / (t_last - t_first)``, a zero span read as
    1."""
    t0, t1 = _t_range(t, t_range)
    denom = t1 - t0
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return (num_bins - 1) * (t - t0) / denom


def _trunc_int(v):
    """torch ``.int()``: truncation toward zero."""
    return torch.trunc(v).to(torch.int32)


def _base_valid(x, valid):
    return (torch.ones(x.shape, dtype=torch.bool, device=x.device)
            if valid is None else valid.to(torch.bool))


def _scatter(grid, idx, w, mask):
    """grid.view(-1)[idx] += w where ``mask`` (masked slots add 0.0 to
    cell 0, which leaves every value unchanged)."""
    idx = torch.where(mask, idx.to(torch.int64), 0)
    grid.index_add_(0, idx, torch.where(mask, w, torch.zeros_like(w)))


def _corner_w(corner, v):
    """1 - |corner - v|, ``corner`` an int tensor."""
    return 1.0 - (corner.to(torch.float32) - v).abs()


def voxel_grid_signed(x, y, t, p, *, num_bins, height, width, valid=None,
                      t_range=None):
    """Signed trilinear voxel grid, value 2p - 1: [num_bins, H, W]
    (the reference's ``VoxelGrid.convert_CHW``)."""
    t_n = _t_norm(t.to(torch.float32), num_bins, t_range)
    x, y = x.to(torch.float32), y.to(torch.float32)
    value = 2.0 * p.to(torch.float32) - 1.0
    x0, y0, t0 = _trunc_int(x), _trunc_int(y), _trunc_int(t_n)
    grid = torch.zeros(num_bins * height * width, dtype=torch.float32,
                       device=x.device)
    base_valid = _base_valid(x, valid)
    for dx in (0, 1):
        for dy in (0, 1):
            for dt in (0, 1):
                xl, yl, tl = x0 + dx, y0 + dy, t0 + dt
                mask = ((xl >= 0) & (xl < width) & (yl >= 0)
                        & (yl < height) & (tl >= 0) & (tl < num_bins)
                        & base_valid)
                w = (value * _corner_w(xl, x) * _corner_w(yl, y)
                     * _corner_w(tl, t_n))
                _scatter(grid, (tl * height + yl) * width + xl, w, mask)
    return grid.reshape(num_bins, height, width)


def voxel_grid_polarities(x, y, t, p, *, num_bins, height, width,
                          valid=None, t_range=None):
    """Per-polarity trilinear voxel grid [num_bins, 2, H, W]: channel 0
    counts events with p == 1, channel 1 the rest (the reference's
    ``VoxelGrid.convert_CHW_polarities``)."""
    t_n = _t_norm(t.to(torch.float32), num_bins, t_range)
    x, y = x.to(torch.float32), y.to(torch.float32)
    x0, y0, t0 = _trunc_int(x), _trunc_int(y), _trunc_int(t_n)
    pos = p.to(torch.float32) == 1.0
    base_valid = _base_valid(x, valid)
    grid = torch.zeros(num_bins * 2 * height * width, dtype=torch.float32,
                       device=x.device)
    channel = torch.where(pos, 0, 1)
    for dx in (0, 1):
        for dy in (0, 1):
            for dt in (0, 1):
                xl, yl, tl = x0 + dx, y0 + dy, t0 + dt
                mask = ((xl >= 0) & (xl < width) & (yl >= 0)
                        & (yl < height) & (tl >= 0) & (tl < num_bins)
                        & base_valid)
                w = _corner_w(xl, x) * _corner_w(yl, y) * _corner_w(tl, t_n)
                idx = ((tl * 2 + channel) * height + yl) * width + xl
                _scatter(grid, idx, w, mask)
    return grid.reshape(num_bins, 2, height, width)


def events_to_voxel_grid_v2(x, y, t, p, *, num_bins, height, width,
                            valid=None, t_range=None, normalize=True):
    """e2vid-style voxel grid [num_bins, H, W]: bilinear in time only,
    x/y truncated, polarity 0 read as -1 (the reference's
    ``events_to_voxel_grid_v2``)."""
    t_n = _t_norm(t.to(torch.float32), num_bins, t_range)
    xs = _trunc_int(x.to(torch.float32))
    ys = _trunc_int(y.to(torch.float32))
    pf = p.to(torch.float32)
    pols = torch.where(pf == 0, -1.0, pf)
    tis = _trunc_int(t_n)
    dts = t_n - tis.to(torch.float32)
    base_valid = (_base_valid(x, valid) & (xs >= 0) & (xs < width)
                  & (ys >= 0) & (ys < height))
    grid = torch.zeros(num_bins * height * width, dtype=torch.float32,
                       device=x.device)
    flat_xy = xs + ys * width
    for tb, w in ((tis, pols * (1.0 - dts)), (tis + 1, pols * dts)):
        mask = (tb >= 0) & (tb < num_bins) & base_valid
        _scatter(grid, flat_xy + tb * width * height, w, mask)
    grid = grid.reshape(num_bins, height, width)
    return normalize_nonzero_std(grid) if normalize else grid


def events_to_frames(x, y, t, p, *, num_frames, height, width, valid=None,
                     t_range=None):
    """Per-frame bilinear (x, y) event counts [num_frames, 2, H, W]:
    channel 0 counts p == 1, channel 1 p == 0, relu'd corner weights (the
    reference's ``events_to_frames``)."""
    t_n = _t_norm(t.to(torch.float32), 2, t_range)  # (2 - 1) * frac
    ts = _trunc_int((num_frames - 1) * t_n)
    x, y = x.to(torch.float32), y.to(torch.float32)
    x0, y0 = _trunc_int(x), _trunc_int(y)
    base_valid = _base_valid(x, valid) & (ts >= 0) & (ts < num_frames)
    grid = torch.zeros(num_frames * 2 * height * width, dtype=torch.float32,
                       device=x.device)
    pf = p.to(torch.float32)
    for pol_idx, pol_mask in ((0, pf == 1), (1, pf == 0)):
        for dx in (0, 1):
            for dy in (0, 1):
                xl, yl = x0 + dx, y0 + dy
                mask = ((xl >= 0) & (xl < width) & (yl >= 0)
                        & (yl < height) & base_valid & pol_mask)
                w = (torch.relu(_corner_w(xl, x))
                     * torch.relu(_corner_w(yl, y)))
                idx = ((ts * 2 + pol_idx) * height + yl) * width + xl
                _scatter(grid, idx, w, mask)
    return grid.reshape(num_frames, 2, height, width)


def normalize_nonzero_std(grid):
    """Zero mean and unit std over the nonzero entries only; a grid whose
    nonzero entries have zero spread is returned as it is."""
    mask = grid != 0
    count = mask.sum().clamp(min=1)
    mean = torch.where(mask, grid, 0.0).sum() / count
    var = torch.where(mask, (grid - mean) ** 2, 0.0).sum() / count
    std = torch.sqrt(var)
    normed = torch.where(mask, (grid - mean) / std, grid)
    return torch.where(std > 0, normed, grid)


def pad_events(x, y, t, p, target_len: int):
    """Host helper: pad flat numpy event arrays to ``target_len``; returns
    (x, y, t, p, valid)."""
    n = len(x)
    if n > target_len:
        raise ValueError(f"{n} events exceed buffer {target_len}")
    valid = np.zeros(target_len, bool)
    valid[:n] = True

    def pad(a):
        out = np.zeros(target_len, a.dtype)
        out[:n] = a
        return out

    return pad(x), pad(y), pad(t), pad(p), valid
