"""K3's band plan, on the CPU.

K3 (``csrc/voxel.cu``) sorts the events by row on the card and sums each
tile of the grid in shared memory from the records of its rows. The card
is not needed to check the plan: a float64 emulation below keys seeded
numpy events as the bin pass does, sorts them by key, walks each tile of
the wrapper's own ``hopper_voxel.k3_tiles`` over the key range the tile
kernel reads (a heavy band's records split into shares by the plan pass's
rule, their partial tiles added in share order), adds only the corners
that fall inside the tile, and writes every tile's cells once. On dyadic
events every weight and sum is exact, so the assembled grid must equal
the plain twin of ``ops/voxel.py`` bit for bit.
"""

import itertools
import pathlib
import re
import zlib

import numpy as np
import pytest
import torch

from sdformerflow_tpu_torch.ops import hopper_voxel, voxel

SOURCE = (pathlib.Path(hopper_voxel.__file__).parents[1] / "csrc"
          / "voxel.cu").read_text()


def _constant(name):
    """An int constant of ``csrc/voxel.cu``: the split of heavy bands is
    fixed there, not in the wrapper."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE)[1])


MAX_SPLIT, MIN_ITEM = _constant("kMaxSplit"), _constant("kMinItem")

TWINS = {
    "signed": (voxel.voxel_grid_signed, "num_bins", {}),
    "polarities": (voxel.voxel_grid_polarities, "num_bins", {}),
    "v2": (voxel.events_to_voxel_grid_v2, "num_bins", {"normalize": False}),
    "frames": (voxel.events_to_frames, "num_frames", {}),
}


def _base(v, hi):
    """The kernel's base_index: trunc, clipped to [-2, hi + 1]."""
    return np.clip(np.trunc(v), -2, hi + 1).astype(np.int64)


def _inside(v, hi):
    return (v >= 0) & (v < hi)


def _keys(mode, x, y, p, valid, H, W):
    """The bin pass: yi + 1, or -1 where no corner can land in the frame."""
    xi, yi = _base(x, W), _base(y, H)
    if mode == "v2":
        ok = _inside(xi, W) & _inside(yi, H)
    else:
        ok = (xi >= -1) & (xi < W) & (yi >= -1) & (yi < H)
        if mode == "frames":
            ok &= (p == 1) | (p == 0)
    return np.where(ok & valid, yi + 1, -1)


def _corners(mode, x, y, t, p, bins, H, W, t0, denom):
    """Every corner inside the grid of the records (x, y, t, p):
    (plane, row, col, weight), the weights of ``event_corners``."""
    planes, rows, cols, ws = [], [], [], []

    def add(keep, q, r, c, w):
        keep = keep & _inside(r, H) & _inside(c, W)
        for acc, v in zip((planes, rows, cols, ws), (q, r, c, w)):
            acc.append(np.broadcast_to(v, keep.shape)[keep])

    x0, y0 = np.trunc(x), np.trunc(y)
    xi, yi = _base(x, W), _base(y, H)
    if mode == "frames":
        ch = np.where(p == 1, 0, np.where(p == 0, 1, -1))
        fr = _base((bins - 1) * ((t - t0) / denom), bins)
        keep = (ch >= 0) & _inside(fr, bins)
        wx = [np.maximum(1 - np.abs(x0 + d - x), 0) for d in (0, 1)]
        wy = [np.maximum(1 - np.abs(y0 + d - y), 0) for d in (0, 1)]
        for dx, dy in itertools.product((0, 1), (0, 1)):
            add(keep, fr * 2 + ch, yi + dy, xi + dx, wx[dx] * wy[dy])
    else:
        tn = (bins - 1) * (t - t0) / denom
        tb = np.trunc(tn)
        ti = _base(tn, bins)
        if mode == "v2":
            pol = np.where(p == 0, -1.0, p)
            keep = _inside(xi, W) & _inside(yi, H)
            for dt, w in ((0, pol * (1 - (tn - tb))), (1, pol * (tn - tb))):
                add(keep & _inside(ti + dt, bins), ti + dt, yi, xi, w)
        else:
            value = 2 * p - 1 if mode == "signed" else 1.0
            stride, ch = ((1, 0) if mode == "signed"
                          else (2, np.where(p == 1, 0, 1)))
            wx = [1 - np.abs(x0 + d - x) for d in (0, 1)]
            wy = [1 - np.abs(y0 + d - y) for d in (0, 1)]
            wt = [1 - np.abs(tb + d - tn) for d in (0, 1)]
            for dx, dy, dt in itertools.product((0, 1), repeat=3):
                add(_inside(ti + dt, bins), (ti + dt) * stride + ch,
                    yi + dy, xi + dx, value * wx[dx] * wy[dy] * wt[dt])
    return tuple(np.concatenate(a) if a else np.zeros(0) for a in
                 (planes, rows, cols, ws))


def emulate_k3(mode, bins, H, W, events, valid, t_range, tiles):
    """K3's passes in float64: key, sort by key, split heavy bands into
    shares of their records, then each tile from its band's key range (the
    shares' partial tiles added in share order); every cell written once.
    Returns the grid and the number of work items."""
    x, y, t, p = (np.asarray(e, np.float64) for e in events)
    keys = _keys(mode, x, y, p, valid, H, W)
    kept = np.flatnonzero(keys >= 0)
    order = kept[np.argsort(keys[kept], kind="stable")]
    offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(keys[kept], minlength=H + 1))])
    t0 = t_range[0]
    denom = (t_range[1] - t_range[0]) or 1.0
    # the plan pass: the records each band walks, split against the mean
    first = [b * tiles.rows + (mode == "v2") for b in range(tiles.bands)]
    end = [min(H, (b + 1) * tiles.rows) + 1 for b in range(tiles.bands)]
    recs = [offsets[e] - offsets[f] for f, e in zip(first, end)]
    target = max(MIN_ITEM, -(-sum(recs) // tiles.bands))
    grid = np.full((tiles.n_planes, H, W), np.nan)
    items = 0
    for band, qs, cs in itertools.product(range(tiles.bands),
                                          range(tiles.plane_slabs),
                                          range(tiles.col_slabs)):
        shares = min(MAX_SPLIT, max(1, recs[band] // target))
        r0, q0, c0 = band * tiles.rows, qs * tiles.planes, cs * tiles.cols
        nr, nq = min(tiles.rows, H - r0), min(tiles.planes,
                                              tiles.n_planes - q0)
        nc = min(tiles.cols, W - c0)
        beg, n_recs = offsets[first[band]], recs[band]
        tile = np.zeros((nq, nr, nc))
        for j in range(shares):      # partial tiles, added in share order
            part = np.zeros_like(tile)
            sel = order[beg + n_recs * j // shares:
                        beg + n_recs * (j + 1) // shares]
            q, r, c, w = _corners(mode, x[sel], y[sel], t[sel], p[sel],
                                  bins, H, W, t0, denom)
            q, r, c = q - q0, r - r0, c - c0
            inn = _inside(q, nq) & _inside(r, nr) & _inside(c, nc)
            np.add.at(part, (q[inn], r[inn], c[inn]), w[inn])
            tile += part
            items += 1
        cells = grid[q0:q0 + nq, r0:r0 + nr, c0:c0 + nc]
        assert np.isnan(cells).all(), "a cell written by two tiles"
        cells[...] = tile
    assert not np.isnan(grid).any(), "a cell no tile wrote"
    return grid, items


def _dyadic(rng, n, lo, hi):
    return (rng.integers(0, int(round((hi - lo) * 4)) + 1, n) * 0.25
            + lo).astype(np.float32)


def _events(kind, rng, n, H, W, bins, rows):
    """Dyadic events with x from 2 before to 2 beyond the frame, t in
    [0, bins - 1], p in {0, 0.5, 1}, 1/8 invalid; ``kind`` sets y."""
    x = _dyadic(rng, n, -2.0, W + 2.0)
    y = _dyadic(rng, n, -2.5, H + 2.5)
    t = _dyadic(rng, n, 0.0, bins - 1.0)
    p = rng.choice(np.float32([0.0, 0.5, 1.0]), n, p=[0.45, 0.1, 0.45])
    valid = rng.random(n) >= 0.125
    if kind == "y_in_(-1,0)":
        y[: n // 2] = _dyadic(rng, n // 2, -0.75, -0.25)
    elif kind == "y_last_row":
        y[: n // 2] = H - 1 + _dyadic(rng, n // 2, 0.25, 0.75)
    elif kind == "y_beyond":
        y[: n // 2] = _dyadic(rng, n // 2, H + 1.0, H + 4.0)
        y[n // 2: 3 * n // 4] = _dyadic(rng, n // 4, -4.0, -2.0)
    elif kind == "band_edge":
        edge = min(rows, H - 1)
        y[: n // 2] = edge + rng.choice(np.float32([-0.25, 0.0, 0.25]),
                                        n // 2)
    elif kind == "skewed":     # 9/10 of the events on 1/10 of the rows
        y[: 9 * n // 10] = _dyadic(rng, 9 * n // 10, H // 2, H // 2 + 0.75)
    elif kind == "all_invalid":
        valid[:] = False
    return (x, y, t, p), valid


# (mode, bins, H, W, events, k3_tiles overrides)
CASES = (
    [(m, 4, 12, 20, kind, {}) for m in sorted(TWINS)
     for kind in ("uniform", "y_in_(-1,0)", "y_last_row", "y_beyond",
                  "band_edge", "skewed", "single", "all_invalid")]
    + [("signed", 10, 6, 346, "uniform", {}),          # MVSEC's width
       ("frames", 5, 7, 346, "band_edge", {}),
       ("polarities", 15, 3, 640, "uniform", {}),      # the largest row
       ("polarities", 6, 9, 20, "uniform", {"smem_budget": 700}),
       ("v2", 7, 9, 346, "uniform", {"smem_budget": 1000}),
       ("signed", 3, 8, 346, "y_last_row", {"smem_budget": 500}),
       ("signed", 4, 20, 346, "skewed", {"smem_budget": 6000}),
       ("v2", 4, 20, 346, "skewed", {"smem_budget": 600}),
       ("polarities", 3, 10, 24, "skewed", {"smem_budget": 300})]
)


@pytest.mark.parametrize(
    "mode,bins,H,W,kind,plan", CASES,
    ids=[f"{m}-{b}x{h}x{w}-{k}-" + "-".join(f"{a}{v}" for a, v in p.items())
         for m, b, h, w, k, p in CASES])
def test_band_plan_matches_twin(mode, bins, H, W, kind, plan):
    tiles = hopper_voxel.k3_tiles(mode, bins, H, W, **plan)
    rng = np.random.default_rng(zlib.crc32(f"{mode}{bins}{H}{W}{kind}".encode()))
    n = 1 if kind == "single" else 1500
    events, valid = _events(kind, rng, n, H, W, bins, tiles.rows)
    if kind == "single":
        events = tuple(np.float32([v]) for v in (W / 2 + 0.25, 1.5, 1.0, 1))
        valid = np.ones(1, bool)
    t_range = (0.0, bins - 1.0)
    got, items = emulate_k3(mode, bins, H, W, events, valid, t_range,
                             tiles)
    twin, bins_kw, extra = TWINS[mode]
    want = twin(*(torch.from_numpy(e) for e in events),
                valid=torch.from_numpy(valid), t_range=t_range,
                **{bins_kw: bins}, height=H, width=W, **extra).numpy()
    assert np.array_equal(got.astype(np.float32).reshape(want.shape), want)
    if kind == "skewed":      # the heavy bands were split
        assert items > tiles.n_tiles
    if kind == "all_invalid":
        assert not want.any()
    elif kind != "y_beyond":
        assert np.abs(want).sum() > 0


@pytest.mark.parametrize("mode,bins,H,W", [
    ("signed", 10, 480, 640), ("v2", 10, 480, 640),
    ("polarities", 10, 480, 640), ("frames", 10, 480, 640),
    ("signed", 15, 480, 640), ("polarities", 15, 480, 640),
    ("signed", 5, 260, 346), ("polarities", 15, 260, 346),
    ("polarities", 15, 480, 4000), ("signed", 1, 1, 1)])
def test_k3_tiles_fit_two_ctas_an_sm(mode, bins, H, W):
    tiles = hopper_voxel.k3_tiles(mode, bins, H, W)
    assert 2 * (tiles.smem_bytes + 1024) <= 228 * 1024
    assert tiles.bands * tiles.rows >= H > (tiles.bands - 1) * tiles.rows
    assert tiles.plane_slabs * tiles.planes >= tiles.n_planes
    assert tiles.col_slabs * tiles.cols >= W
    assert tiles.cols == W or tiles.cols % 4 == 0
    assert tiles.rows <= hopper_voxel.K3_ROWS
    # at 10-15 bins and W = 640 no row is split
    if W == 640:
        assert (tiles.planes, tiles.cols) == (tiles.n_planes, W)


def test_k3_tiles_refuse_what_does_not_fit():
    with pytest.raises(ValueError, match="no tile fits"):
        hopper_voxel.k3_tiles("signed", 10, 8, 8, smem_budget=12)
    with pytest.raises(ValueError, match="rows"):
        hopper_voxel.k3_tiles("signed", 10, hopper_voxel.K3_MAX_ROWS + 1, 8)
    with pytest.raises(ValueError, match="mode"):
        hopper_voxel.k3_tiles("counts", 10, 8, 8)
