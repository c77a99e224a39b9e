"""Offline DSEC preprocessor, the port's counterpart of
``scripts/preprocess_dsec.py``: a raw DSEC sequence (``events.h5``,
``rectify_map.h5`` and the 16-bit flow PNGs) -> one tensor a GT window in
the reference's ``saved_flow_data`` layout, which ``train_dsec`` and
``eval_dsec`` read:

  {root}/saved_flow_data/event_tensors/{NN}bins/left/<seq>/<seq>_<idx:04d>.npy
  {root}/saved_flow_data/gt_tensors/<seq>_<idx:04d>.npy   ([2, H, W] float32)
  {root}/saved_flow_data/mask_tensors/<seq>_<idx:04d>.npy ([H, W] bool)

    python -m sdformerflow_tpu_torch.preprocess_dsec --root data/DSEC \\
        --sequence zurich_city_02_a --input voxel --num_frames 10 \\
        [--make_lists] [--host] [--device cpu]

The HDF5 files are read through ``data/hdf5.py`` (no h5py): lazily, each
GT window decoding only the chunks of ``events/{p,x,y,t}`` it touches.
DSEC's published ``events.h5`` is compressed with a plugin filter that
reader refuses by its id; a file stored with deflate or without a filter
is read. The flow PNGs go through ``utils/visualization.read_png`` (no
cv2; it returns RGB, so channel 0 is x, 1 is y and 2 the valid mask).

``--input voxel`` voxelizes each window on the card with K3
(``ops/hopper_voxel.py``, one launch a window, over exactly the window's
events); ``--device cpu`` runs K3's plain twin (``ops/voxel.py``) instead,
and ``--host`` the numpy voxelizer (``data/loader_utils.py``), as JAX's
``--host``. ``cnt`` (one count frame an equal-dt sub-window) and ``list``
(the raw events) run on the host, as in JAX. It runs on the card unless
``--device cpu`` or ``--host`` is given, and fails when there is no card.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import time

import numpy as np
import torch

from . import native
from .data import hdf5
from .data.loader_utils import EventSequence, events_to_voxel_grid
from .ops import hopper_voxel as V
from .utils.visualization import read_png

HEIGHT, WIDTH = 480, 640

TRAIN_SEQUENCES = [
    "zurich_city_09_a", "zurich_city_07_a", "zurich_city_02_c",
    "zurich_city_11_b", "thun_00_a", "zurich_city_02_d", "zurich_city_11_c",
    "zurich_city_03_a", "zurich_city_10_a", "zurich_city_05_b",
    "zurich_city_08_a", "zurich_city_01_a", "zurich_city_10_b",
    "zurich_city_02_e", "zurich_city_05_a", "zurich_city_06_a",
    "zurich_city_11_a", "zurich_city_02_a",
]
TEST_SEQUENCES = [
    "interlaken_00_b", "interlaken_01_a", "thun_01_a", "thun_01_b",
    "zurich_city_12_a", "zurich_city_14_c", "zurich_city_15_a",
]


class EventSlicer:
    """Random-access slicing of a DSEC ``events.h5`` by microsecond window
    through its ``ms_to_idx`` index (``np.searchsorted`` within the
    window's milliseconds); without the index, it is rebuilt with the
    host packer's one-pass scan (``native.compute_ms_to_idx``)."""

    def __init__(self, h5f: hdf5.File):
        self.h5f = h5f
        self.events = {k: h5f[f"events/{k}"] for k in ("p", "x", "y", "t")}
        self.t_offset = int(h5f["t_offset"][()]) if "t_offset" in h5f else 0
        if "ms_to_idx" in h5f:
            self.ms_to_idx = np.asarray(h5f["ms_to_idx"][()], np.int64)
        else:
            t_all = np.asarray(self.events["t"][()], np.int64)
            n_ms = int(t_all[-1] // 1000) + 2 if t_all.size else 1
            self.ms_to_idx = native.compute_ms_to_idx(t_all, n_ms)

    def get_events(self, t_start_us: int, t_end_us: int):
        t_start_us -= self.t_offset
        t_end_us -= self.t_offset
        ms0 = math.floor(t_start_us / 1000)
        ms1 = math.ceil(t_end_us / 1000)
        if ms1 >= self.ms_to_idx.size:
            return None
        i0, i1 = self.ms_to_idx[ms0], self.ms_to_idx[ms1]
        t_window = np.asarray(self.events["t"][i0:i1])
        lo = np.searchsorted(t_window, t_start_us, side="left")
        hi = np.searchsorted(t_window, t_end_us, side="left")
        out = {"t": t_window[lo:hi] + self.t_offset}
        for k in ("p", "x", "y"):
            out[k] = np.asarray(self.events[k][i0 + lo:i0 + hi])
        return out


def rectify_events(x, y, rectify_map):
    assert rectify_map.shape == (HEIGHT, WIDTH, 2), rectify_map.shape
    return rectify_map[y, x]


def create_flow_maps(sequence, flow_maps_path, save_flow, save_mask):
    """flow PNG16 -> ([2,H,W] float32, [H,W] bool) pairs:
    v = (png - 2^15)/128, channel 2 = valid."""
    os.makedirs(save_flow, exist_ok=True)
    os.makedirs(save_mask, exist_ok=True)
    for idx, name in enumerate(sorted(os.listdir(flow_maps_path)), start=1):
        img = read_png(os.path.join(flow_maps_path, name))
        flow_x = (img[..., 0].astype(float) - 2 ** 15) / 128.0
        flow_y = (img[..., 1].astype(float) - 2 ** 15) / 128.0
        valid = img[..., 2].astype(bool)
        flow = np.stack([flow_x, flow_y]).astype(np.float32)
        fname = f"{sequence}_{idx:04d}.npy"
        np.save(os.path.join(save_flow, fname), flow)
        np.save(os.path.join(save_mask, fname), valid)


def _subdir(events_input, num_frames, signed):
    return {"voxel": f"{num_frames:02d}bins" if signed
            else f"{num_frames:02d}bins_pol",
            "cnt": f"{num_frames:02d}frames",
            "list": f"{num_frames:02d}lists"}[events_input]


def _ms(t0):
    return 1e3 * (time.perf_counter() - t0)


def process_sequence(root, sequence, events_input="voxel", num_frames=10,
                     on_device=True, signed=True, device="cuda"):
    """Write the tensors of every GT window of ``sequence``; returns a
    record a window written: its index, event count and the host-clock ms
    of reading it (slice, rectify, time normalization), of the voxel
    (host-to-device copy, K3 and the copy back) and of the ``.npy``
    write."""
    ts_path = os.path.join(root, "train_optical_flow", sequence, "flow",
                           "forward_timestamps.txt")
    timestamps = np.loadtxt(ts_path, delimiter=",", dtype="int64")
    events_path = os.path.join(root, "train_events", sequence, "events",
                               "left")

    flow_dir = os.path.join(root, "train_optical_flow", sequence, "flow",
                            "forward")
    save_base = os.path.join(root, "saved_flow_data")
    if os.path.isdir(flow_dir):
        create_flow_maps(sequence, flow_dir,
                         os.path.join(save_base, "gt_tensors"),
                         os.path.join(save_base, "mask_tensors"))

    save_dir = os.path.join(save_base, "event_tensors",
                            _subdir(events_input, num_frames, signed),
                            "left", sequence)
    os.makedirs(save_dir, exist_ok=True)
    voxelize = V.voxel_grid_signed_k3 if signed else \
        V.voxel_grid_polarities_k3
    records = []

    with hdf5.File(os.path.join(events_path, "events.h5")) as f, \
            hdf5.File(os.path.join(events_path, "rectify_map.h5")) as rf:
        slicer = EventSlicer(f)
        rectmap = rf["rectify_map"][()]

        for idx in range(timestamps.shape[0]):
            t_read = time.perf_counter()
            t_beg, t_end = timestamps[idx]
            ev = slicer.get_events(int(t_beg), int(t_end))
            if ev is None:
                continue
            xy = rectify_events(ev["x"], ev["y"], rectmap)
            x_r, y_r = xy[:, 0], xy[:, 1]
            p = ev["p"].astype(np.float32)
            rec = {"window": idx + 1, "events": len(x_r), "voxel_ms": 0.0}

            if events_input == "voxel":
                # the time normalization of JAX's script, in float32 and
                # in its order (another order moves events across bins)
                t = (ev["t"] - ev["t"][0]).astype("float32")
                t = t / t[-1] if t[-1] > 0 else t
                rec["read_ms"] = _ms(t_read)
                t_vox = time.perf_counter()
                if on_device:
                    x, y, tt, pp = (torch.from_numpy(a).to(device) for a in
                                    (x_r, y_r, t, p))
                    chunk = voxelize(
                        x, y, tt, pp, num_bins=num_frames, height=HEIGHT,
                        width=WIDTH,
                        t_range=(float(t[0]), float(t[-1]))).cpu().numpy()
                else:
                    seq = EventSequence(
                        np.stack([t, x_r, y_r, p], 1), HEIGHT, WIDTH)
                    chunk = events_to_voxel_grid(seq, num_frames,
                                                 normalize=False, pol=True)
                rec["voxel_ms"] = _ms(t_vox)
            elif events_input == "cnt":
                # reference cnt layout: one [2, H, W] count frame per equal-dt
                # sub-window, stacked to [num_frames, 2, H, W] (channel 0 = ON)
                dt = (t_end - t_beg) / num_frames
                t_ev = ev["t"].astype(np.float64)
                in_bounds = ((x_r >= 0) & (x_r < WIDTH)
                             & (y_r >= 0) & (y_r < HEIGHT))
                chunk = np.zeros((num_frames, 2, HEIGHT, WIDTH), np.float32)
                for fr in range(num_frames):
                    # EventSlicer.get_events half-open window [start, end)
                    m = (in_bounds & (t_ev >= t_beg + fr * dt)
                         & (t_ev < t_beg + (fr + 1) * dt))
                    xi = x_r[m].astype(int)
                    yi = y_r[m].astype(int)
                    pi = p[m].astype(int)
                    np.add.at(chunk[fr], (1 - pi, yi, xi), 1.0)
                rec["read_ms"] = _ms(t_read)
            elif events_input == "list":
                t = (ev["t"] - t_beg) / (t_end - t_beg)
                chunk = np.array([{"p": ev["p"], "t": t, "x": x_r,
                                   "y": y_r}], dtype=object)
                rec["read_ms"] = _ms(t_read)
            t_write = time.perf_counter()
            np.save(os.path.join(save_dir,
                                 f"{sequence}_{idx + 1:04d}.npy"), chunk)
            rec["write_ms"] = _ms(t_write)
            records.append(rec)
    return records


def write_split_csvs(root, train_sequences, valid_sequences,
                     events_input="voxel", num_frames=10, signed=True):
    """Write ``saved_flow_data/sequence_lists/{train,valid}_split_seq.csv``
    and the ``_split_doubleseq.csv`` consecutive-pair variants from the
    tensors :func:`process_sequence` wrote: a row a window whose GT flow
    and mask exist (test-server sequences get none); a doubleseq row pairs
    two consecutive GT windows of one sequence. Returns (path, rows) of
    each file."""
    save_base = os.path.join(root, "saved_flow_data")
    sub = _subdir(events_input, num_frames, signed)
    lists_dir = os.path.join(save_base, "sequence_lists")
    os.makedirs(lists_dir, exist_ok=True)

    def rows_for(sequences):
        single, double = [], []
        for seq in sequences:
            seq_dir = os.path.join(save_base, "event_tensors", sub, "left",
                                   seq)
            if not os.path.isdir(seq_dir):
                continue
            files = sorted(f for f in os.listdir(seq_dir)
                           if f.endswith(".npy"))
            with_gt = [f for f in files if os.path.isfile(
                os.path.join(save_base, "gt_tensors", f))]
            single.extend([f] for f in with_gt)
            gt = set(with_gt)
            for a, b in zip(files, files[1:]):
                # consecutive windows: _0007.npy followed by _0008.npy
                if (int(b.rsplit("_", 1)[1][:-4])
                        == int(a.rsplit("_", 1)[1][:-4]) + 1 and b in gt):
                    double.append([a, b])
        return single, double

    written = []
    for split, seqs in (("train", train_sequences),
                        ("valid", valid_sequences)):
        single, double = rows_for(seqs)
        for suffix, rows in ((f"{split}_split_seq.csv", single),
                             (f"{split}_split_doubleseq.csv", double)):
            path = os.path.join(lists_dir, suffix)
            with open(path, "w", newline="") as f:
                csv.writer(f).writerows(rows)
            written.append((path, len(rows)))
    return written


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--sequence", default=None,
                    help="one sequence; default: all train sequences")
    ap.add_argument("--input", default="voxel",
                    choices=["voxel", "cnt", "list"])
    ap.add_argument("--num_frames", type=int, default=10)
    ap.add_argument("--host", action="store_true",
                    help="voxelize on host numpy instead of the device")
    ap.add_argument("--make_lists", action="store_true",
                    help="after processing, write sequence_lists CSVs "
                         "(train/valid splits) from the produced tensors")
    ap.add_argument("--valid_seqs", default="zurich_city_05_a",
                    help="comma-separated sequences held out as the valid "
                         "split when --make_lists is set")
    ap.add_argument("--device", default="cuda",
                    help="where the voxel runs (default: the card; cpu runs "
                         "K3's plain twin)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {sequence: its window records} and, with ``--make_lists``,
    ``"lists"``: (path, rows) of each CSV."""
    args = parse_args(argv)
    on_device = not args.host
    if on_device and torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("preprocess_dsec: no CUDA device; pass --device cpu "
                         "(K3's plain twin) or --host to run on the CPU")
    sequences = [args.sequence] if args.sequence else TRAIN_SEQUENCES
    out = {}
    for seq in sequences:
        print(f"processing {seq}")
        t0 = time.perf_counter()
        out[seq] = process_sequence(args.root, seq, args.input,
                                    args.num_frames, on_device=on_device,
                                    device=args.device)
        print(f"{seq}: {len(out[seq])} windows in "
              f"{time.perf_counter() - t0:.2f} s")

    if args.make_lists:
        valid = [s for s in args.valid_seqs.split(",") if s]
        train = [s for s in sequences if s not in valid]
        out["lists"] = write_split_csvs(args.root, train, valid, args.input,
                                        args.num_frames)
        for path, n in out["lists"]:
            print(f"wrote {path} ({n} rows)")
    return out


if __name__ == "__main__":
    main()
