"""Host-side loader utilities for MDR / MVSEC, the port's own copy of
``sdformerflow_tpu/data/loader_utils.py``: the event file readers, the
e2vid-style voxelizer, the RAFT-style augmentors and the MVSEC GT-flow
propagation, in numpy.

Where the JAX package reaches pandas, h5py or cv2, none of which the card's
host has, this module has its own numpy code:

- ``get_events_h5`` / ``write_events_h5``: ``data/hdf5.py``;
- :func:`resize_linear` for ``cv2.resize(..., INTER_LINEAR)`` (the
  augmentors): the output size ``rint(n * f)``, the source coordinate
  ``(d + 0.5) / f - 0.5`` from the factor itself (not the ratio of the
  sizes), in float32 as cv2 computes it; a column below 0 clamps to 0 and
  one at or past ``n - 1`` to ``n - 1``, with weight 0; rows clamp their
  index and keep their weights; an output of the input's size is a copy;
- :func:`remap_nearest` for ``cv2.remap(..., INTER_NEAREST)`` (the GT
  propagation): the map rounded half to even, 0 outside the image.

Like cv2, :func:`resize_linear` refuses arrays of more than 3 dimensions,
so ``MDREventFlow`` with ``loader.polarity: false`` and augmentation
raises, as the JAX package does.

One deviation, for coordinates the JAX form sends out of the grid:
:func:`events_to_voxel_grid` drops events whose truncated x/y lie outside
the frame, where JAX's flat ``np.add.at`` puts them into another pixel (a
negative index, or a column past a row's end) or raises past the grid's
end. MVSEC's events are always inside; DSEC's rectified ones
(``preprocess_dsec --host``) are not.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .hdf5 import read_event_block, write_event_block


def get_compressed_events(event_path: str) -> np.ndarray:
    """.npz events -> [N, 4] float64 rows [t * 1e-9, x, y, 2p - 1]."""
    d = np.load(event_path)
    p = 2.0 * d["p"] - 1.0
    return np.stack([d["t"] * 1e-9, d["x"], d["y"], p], axis=1).astype(
        np.float64)


def get_events_h5(event_path: str) -> np.ndarray:
    """Pandas-HDF event file -> [N, 4] float64 rows [ts, x, y, p], read from
    its fixed-format ``myDataset/block0_items`` and ``block0_values``."""
    cols, vals = read_event_block(event_path, "myDataset")
    idx = [cols.index(k) for k in ("ts", "x", "y", "p")]
    return vals[:, idx].astype(np.float64)


def write_events_h5(path: str, data: np.ndarray,
                    columns=("ts", "x", "y", "p")):
    """Write an event window in the fixed-format layout
    (``myDataset/{axis0, block0_items, block0_values}``) that
    :func:`get_events_h5`, h5py and the JAX package read."""
    write_event_block(path, np.asarray(data, np.float64), columns,
                      "myDataset")


def read_flo(flow_path: str) -> np.ndarray:
    """Middlebury .flo -> [H, W, 2] float32."""
    with open(flow_path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic != 202021.25:
            raise ValueError(f"invalid .flo magic in {flow_path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
        return np.resize(data, (h, w, 2))


class EventSequence:
    """Sorted event container [N, 4] = [ts, x, y, p]."""

    def __init__(self, features: np.ndarray, height: int, width: int,
                 timestamp_multiplier: Optional[float] = None,
                 convert_to_relative: bool = False):
        self.features = np.asarray(features, np.float64)
        self.image_height = height
        self.image_width = width
        if len(self.features) and not np.all(
                self.features[:-1, 0] <= self.features[1:, 0]):
            self.features = self.features[np.argsort(self.features[:, 0])]
        if timestamp_multiplier is not None:
            self.features[:, 0] *= timestamp_multiplier
        if convert_to_relative and len(self.features):
            self.features[:, 0] -= self.features[0, 0]

    def __len__(self):
        return len(self.features)

    def __add__(self, other):
        return EventSequence(
            np.concatenate([self.features, other.features]),
            self.image_height, self.image_width)


def events_to_voxel_grid(event_sequence: EventSequence, num_bins: int,
                         normalize: bool = True, pol: bool = True):
    """t-bilinear scatter of the reference's
    EventSequenceToVoxelGrid_Pytorch. pol=True -> signed [bins, H, W];
    pol=False -> [bins, 2, H, W]; normalized over the nonzero entries by
    their mean and unbiased (n - 1) std, as torch's ``.std()``. Events
    whose truncated x/y lie outside the frame are dropped (the module's
    one deviation from JAX)."""
    ev = event_sequence.features.astype(np.float64)
    h, w = event_sequence.image_height, event_sequence.image_width

    t = ev[:, 0]
    t0, t1 = t[0], t[-1]
    dt = (t1 - t0) or 1.0
    ts = (num_bins - 1) * (t - t0) / dt
    xs = ev[:, 1].astype(np.int64)
    ys = ev[:, 2].astype(np.int64)
    pols = ev[:, 3].astype(np.float32)
    pols[pols == 0] = -1
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)

    tis = np.floor(ts)
    tis_long = tis.astype(np.int64)
    dts = (ts - tis).astype(np.float32)

    def scatter(grid_flat, sel, idx, vals):
        np.add.at(grid_flat, idx[sel], vals[sel])

    if pol:
        grid = np.zeros(num_bins * h * w, np.float32)
        vals_left = pols * (1.0 - dts)
        vals_right = pols * dts
        base = xs + ys * w
        sel = (tis < num_bins) & (tis >= 0) & inside
        scatter(grid, sel, base + tis_long * w * h, vals_left)
        sel = ((tis + 1) < num_bins) & (tis >= 0) & inside
        scatter(grid, sel, base + (tis_long + 1) * w * h, vals_right)
        grid = grid.reshape(num_bins, h, w)
    else:
        grid = np.zeros((num_bins * h * w, 2), np.float32)
        base = xs + ys * w
        for ch, mask_pol in ((0, pols == 1), (1, pols == -1)):
            mask_pol = mask_pol & inside
            sel = (tis < num_bins) & (tis >= 0) & mask_pol
            scatter(grid[:, ch], sel, base + tis_long * w * h, 1.0 - dts)
            sel = ((tis + 1) < num_bins) & (tis >= 0) & mask_pol
            scatter(grid[:, ch], sel, base + (tis_long + 1) * w * h, dts)
        grid = grid.reshape(num_bins, h, w, 2).transpose(0, 3, 1, 2)

    if normalize:
        mask = grid != 0
        if mask.any():
            mean = grid[mask].mean()
            std = grid[mask].std(ddof=1) if mask.sum() > 1 else 0.0
            if std > 0:
                grid[mask] = (grid[mask] - mean) / std
            else:
                grid[mask] = grid[mask] - mean
    return grid


def resize_linear(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """``cv2.resize(img, None, fx=fx, fy=fy, interpolation=INTER_LINEAR)``
    of a float32 or float64 [H, W] or [H, W, C] array."""
    if img.ndim not in (2, 3):
        raise ValueError(f"resize_linear takes [H, W] or [H, W, C], not a "
                         f"{img.ndim}-D array (cv2.resize refuses it too)")
    if img.dtype not in (np.float32, np.float64):
        raise ValueError(f"resize_linear takes float32 or float64, not "
                         f"{img.dtype}")
    h, w = img.shape[:2]
    oh, ow = int(np.rint(h * fy)), int(np.rint(w * fx))
    if (oh, ow) == (h, w):            # cv2 copies whatever the factors
        return img.copy()
    ft = img.dtype.type

    def taps(m, f):
        pos = ((np.arange(m) + 0.5) * (1.0 / f) - 0.5).astype(ft)
        i0 = np.floor(pos)
        return i0.astype(np.int64), (pos - i0).astype(ft)

    x0, ax = taps(ow, fx)
    low, high = x0 < 0, x0 >= w - 1
    ax[low | high] = 0
    x0 = np.clip(x0, 0, w - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    y0, ay = taps(oh, fy)
    y1 = np.clip(y0 + 1, 0, h - 1)
    y0 = np.clip(y0, 0, h - 1)
    shape = (-1,) + (1,) * (img.ndim - 2)
    ax, ay = ax.reshape(shape), ay.reshape(shape)
    rows = img[:, x0] * (ft(1) - ax) + img[:, x1] * ax     # [H, OW(, C)]
    return rows[y0] * (ft(1) - ay)[:, None] + rows[y1] * ay[:, None]


def remap_nearest(img: np.ndarray, map_x: np.ndarray,
                  map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, INTER_NEAREST)`` of an [H, W] array:
    ``img`` at the maps rounded half to even, 0 where that falls outside
    the image."""
    h, w = img.shape
    xi, yi = np.rint(map_x), np.rint(map_y)
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.zeros(map_x.shape, img.dtype)
    out[inside] = img[yi[inside].astype(np.int64),
                      xi[inside].astype(np.int64)]
    return out


def prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask,
              scale_factor=1.0):
    """One nearest-neighbor propagation step of the GT flow chain."""
    fx = remap_nearest(x_flow.astype(np.float32), x_indices, y_indices)
    fy = remap_nearest(y_flow.astype(np.float32), x_indices, y_indices)
    x_mask[fx == 0] = False
    y_mask[fy == 0] = False
    x_indices += fx * scale_factor
    y_indices += fy * scale_factor


def estimate_corresponding_gt_flow(x_flow_in, y_flow_in, gt_timestamps,
                                   start_time, end_time):
    """Propagate GT flow across [start_time, end_time] by chained remaps.
    Only the GT frames it reads are taken to float64 (JAX converts the
    whole [M, H, W] stack on every call: the same values, M times the
    work)."""
    def frame(flow_in, i):
        return np.squeeze(np.asarray(flow_in[i], np.float64))

    gt_timestamps = np.asarray(gt_timestamps, np.float64)

    gt_iter = np.searchsorted(gt_timestamps, start_time, side="right") - 1
    gt_dt = gt_timestamps[gt_iter + 1] - gt_timestamps[gt_iter]
    x_flow = frame(x_flow_in, gt_iter)
    y_flow = frame(y_flow_in, gt_iter)
    dt = end_time - start_time
    if gt_dt > dt:
        return x_flow * dt / gt_dt, y_flow * dt / gt_dt

    x_indices, y_indices = np.meshgrid(np.arange(x_flow.shape[1]),
                                       np.arange(x_flow.shape[0]))
    x_indices = x_indices.astype(np.float32)
    y_indices = y_indices.astype(np.float32)
    orig_x, orig_y = x_indices.copy(), y_indices.copy()
    x_mask = np.ones(x_indices.shape, bool)
    y_mask = np.ones(y_indices.shape, bool)

    scale = (gt_timestamps[gt_iter + 1] - start_time) / gt_dt
    prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask, scale)
    gt_iter += 1
    while gt_timestamps[gt_iter + 1] < end_time:
        x_flow = frame(x_flow_in, gt_iter)
        y_flow = frame(y_flow_in, gt_iter)
        prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask)
        gt_iter += 1

    final_dt = end_time - gt_timestamps[gt_iter]
    final_gt_dt = gt_timestamps[gt_iter + 1] - gt_timestamps[gt_iter]
    x_flow = frame(x_flow_in, gt_iter)
    y_flow = frame(y_flow_in, gt_iter)
    prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask,
              final_dt / final_gt_dt)

    x_shift = x_indices - orig_x
    y_shift = y_indices - orig_y
    x_shift[~x_mask] = 0
    y_shift[~y_mask] = 0
    return x_shift, y_shift


class DenseSparseAugmentor:
    """RAFT-style scale/stretch/flip/crop over two event-volume pairs +
    flow, with flow-vector rescaling, on the host. Draws from ``rng`` (a
    ``numpy.random.Generator``) in the JAX package's order, so one seed
    gives the same transform."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5,
                 do_flip=False, rng=None):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.rng = rng or np.random.default_rng()

    def __call__(self, *arrays):
        """arrays: (img1, img2[, dimg1, dimg2], flow), all [H, W, C]."""
        rng = self.rng
        arrays = list(arrays)
        flow = arrays[-1]
        ht, wd = arrays[0].shape[:2]
        min_scale = max((self.crop_size[0] + 8) / float(ht),
                        (self.crop_size[1] + 8) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.random() < self.stretch_prob:
            sx *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        sx, sy = max(sx, min_scale), max(sy, min_scale)

        if rng.random() < self.spatial_aug_prob:
            arrays = [resize_linear(a, sx, sy) for a in arrays[:-1]]
            flow = resize_linear(flow, sx, sy) * [sx, sy]
        else:
            arrays = arrays[:-1]

        if self.do_flip:
            if rng.random() < self.h_flip_prob:
                arrays = [a[:, ::-1] for a in arrays]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if rng.random() < self.v_flip_prob:
                arrays = [a[::-1] for a in arrays]
                flow = flow[::-1] * [1.0, -1.0]

        y0 = rng.integers(0, arrays[0].shape[0] - self.crop_size[0])
        x0 = rng.integers(0, arrays[0].shape[1] - self.crop_size[1])
        sl = (slice(y0, y0 + self.crop_size[0]),
              slice(x0, x0 + self.crop_size[1]))
        arrays = [np.ascontiguousarray(a[sl]) for a in arrays]
        flow = np.ascontiguousarray(flow[sl])
        return (*arrays, flow)


class FlowAugmentor(DenseSparseAugmentor):
    """Two-volume variant (img1, img2, flow)."""
