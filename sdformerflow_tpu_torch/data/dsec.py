"""DSEC datasets and the host batcher, the port's own copy of
``sdformerflow_tpu/data/dsec.py`` (``DSECDatasetLite``,
``DSECEventListDataset``, ``SyntheticEventFlowDataset``,
``SyntheticEventListDataset``, ``_collate``, ``batch_iterator``; host-side
numpy, the packer is the port's ``native``).

Items are (chunk, mask, label): chunk [bins, H, W] signed voxels (or
[bins, 2, H, W]) or a dict of padded event buffers, mask [H, W], label
[2, H, W] flow.

The readers take the offline preprocessor's tree:
``{path}/event_tensors/{NN}bins[_pol]/left/<seq>/<seq>_<idx>.npy`` (voxels),
``{path}/event_tensors/01lists/left/<seq>_<idx>.npy`` (pickled dicts of raw
events x/y/t/p), ``{path}/gt_tensors/<file>.npy``,
``{path}/mask_tensors/<file>.npy`` and
``{path}/sequence_lists/{train,valid}_split_{seq,doubleseq}.csv``.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator

import numpy as np

from .. import native


def _read_split(path: str, file_list: str, suffix: str):
    with open(os.path.join(path, "sequence_lists", file_list + suffix)) as f:
        return [row for row in csv.reader(f) if row]


def _seq(name: str) -> str:
    """An item file's sequence: ``thun_00_a_0003.npy`` -> ``thun_00_a``."""
    return "_".join(name.split("_")[:-1])


class DSECDatasetLite:
    """Preprocessed voxel (or frame) tensors of DSEC: chunk [bins, H, W]
    (``NNbins``, polarity folded as the sign), [bins, 2, H, W]
    (``NNbins_pol``, ``loader.polarity: false``) or ``NNframes``
    (``model.encoding`` other than voxel); with ``data.num_chunks == 2``
    the two windows of a ``_split_doubleseq.csv`` row concatenated."""

    def __init__(self, config: dict, file_list: str):
        data_cfg = config["data"]
        self.path = data_cfg["path"]
        self.flow_path = os.path.join(self.path, "gt_tensors")
        self.mask_path = os.path.join(self.path, "mask_tensors")
        self.encoding = config["model"].get("encoding", "voxel")
        self.num_frames = data_cfg.get("num_frames", 10)
        self.num_chunks = data_cfg.get("num_chunks", 1)
        if self.encoding == "voxel":
            polarity = config["loader"].get("polarity", True)
            sub = f"{self.num_frames:02d}bins" + ("" if polarity else "_pol")
        else:
            sub = f"{self.num_frames:02d}frames"
        self.events_path = os.path.join(self.path, "event_tensors", sub,
                                        "left")
        self.files = _read_split(self.path, file_list,
                                 "_split_doubleseq.csv" if self.num_chunks == 2
                                 else "_split_seq.csv")

    def __len__(self):
        return len(self.files)

    def _chunk(self, name):
        return np.load(os.path.join(self.events_path, _seq(name), name),
                       allow_pickle=True)

    def __getitem__(self, idx):
        row = self.files[idx]
        mask = np.load(os.path.join(self.mask_path, row[-1]))
        label = np.load(os.path.join(self.flow_path, row[-1]))
        chunk = self._chunk(row[0])
        if self.num_chunks == 2:
            chunk = np.concatenate([chunk, self._chunk(row[1])], axis=0)
        return chunk.astype(np.float32), mask, label.astype(np.float32)


class DSECEventListDataset:
    """DSEC over raw per-window event lists (``event_tensors/01lists/left``:
    pickled dicts of x/y/t/p, DSEC's uint16/uint16/int64 us/uint8).

    Items are (dict of padded [N] buffers x/y/t/p/valid, mask, label); the
    events are voxelized on the device by the step. At most ``max_events``
    events are kept, padded to the next power of two; t is rebased to the
    first event, which keeps it exact in float32. The events stay in their
    file's order (the JAX reader's ``presort=False``): K3 groups them by
    row on the card, so the host sorts nothing."""

    def __init__(self, config: dict, file_list: str,
                 max_events: int = 1 << 21):
        self.path = config["data"]["path"]
        self.flow_path = os.path.join(self.path, "gt_tensors")
        self.mask_path = os.path.join(self.path, "mask_tensors")
        self.events_path = os.path.join(self.path, "event_tensors",
                                        "01lists", "left")
        self.max_events = max_events
        self.files = _read_split(self.path, file_list, "_split_seq.csv")

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        target = self.files[idx][0]
        mask = np.load(os.path.join(self.mask_path, target))
        label = np.load(os.path.join(self.flow_path, target))
        ev = np.load(os.path.join(self.events_path, target),
                     allow_pickle=True)
        d = ev[0] if isinstance(ev, np.ndarray) and ev.dtype == object else ev
        n = min(len(d["x"]), self.max_events)
        cap = min(1 << max(n - 1, 1).bit_length(), self.max_events)
        x, y, t, p, valid = native.pack_window(
            *(np.asarray(d[k][:n]) for k in "xytp"), cap)
        events = {"x": x, "y": y, "t": t, "p": p, "valid": valid}
        return events, mask, label.astype(np.float32)


class SyntheticEventFlowDataset:
    """Deterministic synthetic (chunk, mask, label) samples with voxel-like
    sparsity statistics — used by tests and benchmarks when no DSEC data is
    mounted."""

    def __init__(self, num_samples=64, num_bins=10, height=288, width=384,
                 seed=0, per_polarity=False, structured=False):
        self.n = num_samples
        self.num_bins = num_bins
        self.height = height
        self.width = width
        self.seed = seed
        self.per_polarity = per_polarity
        self.structured = structured

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        shape = ((self.num_bins, 2, self.height, self.width)
                 if self.per_polarity
                 else (self.num_bins, self.height, self.width))
        if self.structured:
            # learnable task: a moving bar whose per-bin displacement IS the
            # (spatially constant) GT flow — the label is a deterministic
            # function of the event pattern
            v = rng.uniform(-4, 4, size=2).astype(np.float32)
            chunk = np.zeros(shape, np.float32)
            ys, xs = np.mgrid[0:self.height, 0:self.width]
            cx = rng.uniform(0.25, 0.75) * self.width
            cy = rng.uniform(0.25, 0.75) * self.height
            for b in range(self.num_bins):
                frac = b / max(self.num_bins - 1, 1)
                bx, by = cx + frac * v[0], cy + frac * v[1]
                bar = (np.abs(xs - bx) < 2) | (np.abs(ys - by) < 2)
                if self.per_polarity:
                    chunk[b, b % 2][bar] = 1.0
                else:
                    chunk[b][bar] = 1.0 if b % 2 == 0 else -1.0
            label = np.broadcast_to(
                v[:, None, None], (2, self.height, self.width)).copy()
            mask = np.ones((self.height, self.width), bool)
            return chunk, mask, label
        chunk = rng.normal(0, 1, shape).astype(np.float32)
        chunk *= (rng.uniform(size=shape) < 0.1)  # ~10% occupancy
        label = rng.normal(0, 3, (2, self.height, self.width)).astype(
            np.float32)
        mask = (rng.uniform(size=(self.height, self.width)) > 0.2)
        return chunk, mask, label


class SyntheticEventListDataset:
    """Synthetic raw-event-list samples (events dict + mask + label) for the
    on-device voxelization path. Events are sampled from the magnitudes of a
    SyntheticEventFlowDataset chunk, so ``voxelize -> encode`` reproduces
    (approximately) the same input the preprocessed synthetic path sees —
    the ``--structured`` moving-bar task stays learnable end to end."""

    def __init__(self, num_samples=64, num_bins=10, height=288, width=384,
                 seed=0, structured=False, events_per_cell=2,
                 max_events=1 << 20, presort=True):
        self.base = SyntheticEventFlowDataset(
            num_samples, num_bins, height, width, seed,
            per_polarity=False, structured=structured)
        self.events_per_cell = events_per_cell
        self.max_events = max_events
        self.events_presorted = bool(presort)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        chunk, mask, label = self.base[idx]
        rng = np.random.default_rng(self.base.seed + 7919 * (idx + 1))
        bins = chunk.shape[0]
        b0, y0, x0 = np.nonzero(np.abs(chunk) > 0.05)
        reps = self.events_per_cell
        b = np.repeat(b0, reps)
        yr, xr = np.repeat(y0, reps), np.repeat(x0, reps)
        yf = (yr + rng.uniform(-0.5, 0.5, b.size)).clip(
            0, chunk.shape[1] - 1)
        xf = (xr + rng.uniform(-0.5, 0.5, b.size)).clip(
            0, chunk.shape[2] - 1)
        # timestamps uniformly inside each source bin; t normalized to [0,1]
        t = (b + rng.uniform(0, 1, b.size)) / bins
        p = (chunk[b, yr, xr] > 0).astype(np.uint8)
        order = np.argsort(t, kind="stable")
        n = min(b.size, self.max_events)
        cap = 1 << max(int(n) - 1, 1).bit_length()
        pack_args = (xf[order][:n].astype(np.float32),
                     yf[order][:n].astype(np.float32),
                     t[order][:n].astype(np.float32),
                     p[order][:n].astype(np.float32))
        if self.events_presorted:
            xs, ys, ts, ps, valid = native.pack_window_sorted(
                *pack_args, min(cap, self.max_events),
                height=chunk.shape[1], t0=0.0)
        else:
            xs, ys, ts, ps, valid = native.pack_window(
                *pack_args, min(cap, self.max_events), t0=0.0)
        events = {"x": xs, "y": ys, "t": ts, "p": ps, "valid": valid}
        return events, mask, label


def _stack_events(event_dicts):
    """Stack per-item padded event dicts, re-padding to the batch max.

    ``y`` is edge-padded (repeats the final slot's y) instead of
    zero-padded: presorted buffers (native.pack_window_sorted) must stay
    non-decreasing in the voxelizer's row key, and a zero tail after a
    y=height pad region would break that. Edge padding is harmless for
    unsorted buffers (the tail has valid=0, weight exactly 0)."""
    cap = max(d["x"].size for d in event_dicts)
    out = {}
    for key in ("x", "y", "t", "p", "valid"):
        arrs = []
        for d in event_dicts:
            a = d[key]
            if a.size < cap:
                mode = "edge" if key == "y" else "constant"
                a = np.pad(a, (0, cap - a.size), mode=mode)
            arrs.append(a)
        out[key] = np.stack(arrs)
    return out


def _collate(items) -> dict:
    chunks, masks, labels = zip(*items)
    batch = {
        "mask": np.stack(masks)[:, None].astype(np.float32),
        "label": np.stack(labels),
    }
    if isinstance(chunks[0], dict):
        batch["events"] = _stack_events(chunks)
    else:
        batch["chunk"] = np.stack(chunks)
    return batch


def batch_iterator(dataset, batch_size: int, *, shuffle=False, seed=0,
                   drop_last=True, workers: int = 0) -> Iterator[dict]:
    """Minimal host-side batcher yielding dict batches of stacked numpy
    arrays: chunk [B, ...], mask [B, 1, H, W] float, label [B, 2, H, W].
    Items whose first element is an events dict (raw-list datasets) yield
    ``events`` (dict of [B, N] buffers) instead of ``chunk``.

    ``workers >= 2`` fetches items through a thread pool, keeping up to two
    batches of item futures in flight. The GIL is released inside the C++
    pack kernels (ctypes foreign calls) and large numpy ops, so the
    per-item packing spreads over the host's cores. Batch composition and
    order are identical to the serial path (items are keyed by index;
    datasets here derive their RNG from ``seed + idx``, never from shared
    state), as the reference's ``DataLoader(num_workers=n_workers)`` is."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    idx_batches = []
    for start in range(0, len(order), batch_size):
        idxs = order[start:start + batch_size]
        if drop_last and len(idxs) < batch_size:
            break
        idx_batches.append(idxs)
    if workers and workers >= 2:
        import collections
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as ex:
            pending = collections.deque()
            for idxs in idx_batches:
                pending.append([ex.submit(dataset.__getitem__, int(i))
                                for i in idxs])
                if len(pending) > 2:
                    yield _collate([f.result() for f in pending.popleft()])
            while pending:
                yield _collate([f.result() for f in pending.popleft()])
    else:
        for idxs in idx_batches:
            yield _collate([dataset[i] for i in idxs])
