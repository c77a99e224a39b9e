"""The plain events front: a window of raw events -> the model's input, in
float64, as the configuration's serving path defines it (the reference's
``VoxelGrid.convert_CHW`` signed grid over the window's own time span,
the eval protocol's center crop, the polarity split and the min-max
normalization over the nonzero entries)."""

from __future__ import annotations

import numpy as np
import torch


def voxel_signed(req: dict, *, num_bins: int, height: int, width: int,
                 device) -> torch.Tensor:
    """[num_bins, H, W] float64: each event adds ``2p - 1`` to its pixel,
    split linearly between the two bins around its time, the time scaled
    so the window's first and last event fall on bins 0 and num_bins - 1
    (pixel coordinates are integers, so no weight falls on neighbours)."""
    x = torch.from_numpy(np.asarray(req["x"], np.int64)).to(device)
    y = torch.from_numpy(np.asarray(req["y"], np.int64)).to(device)
    t = torch.from_numpy(np.asarray(req["t"], np.int64)).to(device)
    p = torch.from_numpy(np.asarray(req["p"], np.int64)).to(device)
    t0, t1 = t.min(), t.max()
    span = (t1 - t0).double()
    span = torch.where(span == 0, torch.ones_like(span), span)
    tn = (num_bins - 1) * (t - t0).double() / span
    value = 2.0 * p.double() - 1.0
    grid = torch.zeros(num_bins * height * width, dtype=torch.float64,
                       device=device)
    lo = torch.floor(tn).long()
    for b in (lo, lo + 1):
        w = value * (1.0 - (b.double() - tn).abs())
        ok = (b >= 0) & (b < num_bins) & (x >= 0) & (x < width) \
            & (y >= 0) & (y < height)
        grid.index_add_(0, ((b * height + y) * width + x)[ok], w[ok])
    return grid.view(num_bins, height, width)


def model_input(req: dict, program: dict, device) -> torch.Tensor:
    """One request's model input [bins, 2, h, w] float64 (the crop)."""
    res = program["loader"].get("resolution", (480, 640))
    bins = int(program["data"].get("num_frames", 10))
    grid = voxel_signed(req, num_bins=bins, height=res[0], width=res[1],
                        device=device)
    ch, cw = program["loader"]["crop"]
    y0, x0 = (res[0] - ch) // 2, (res[1] - cw) // 2
    grid = grid[:, y0:y0 + ch, x0:x0 + cw]
    x = torch.stack((grid.clamp(min=0), (-grid).clamp(min=0)), dim=1)
    nz = x != 0
    if not bool(nz.any()):
        return x
    mn, mx = x[nz].min(), x[nz].max()
    if mx == mn:
        return x
    return torch.where(nz, (x - mn) / (mx - mn), x)
