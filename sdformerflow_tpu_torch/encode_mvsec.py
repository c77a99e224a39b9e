"""Offline MVSEC preparation, the port's counterpart of
``scripts/encode_mvsec.py``: slice the raw ``<seq>_data.hdf5`` event
stream into one event ``.h5`` an image frame and propagate the distorted
GT flow of ``<seq>_gt.hdf5`` between frame timestamps (dt1 or dt4), into
the layout ``data/mvsec.py`` (``train_mdr``, ``eval_mvsec``) reads:

  {out}/{seq}/event/{frame:06d}.h5      (pandas' fixed format, ts,x,y,p)
  {out}/{seq}/flowgt_dt{N}/{i}.npy      ([H, W, 2] float32)

    python -m sdformerflow_tpu_torch.encode_mvsec --data_dir data/MVSEC_raw \\
        --out_dir data/MVSEC --sequence indoor_flying3 --dt 1

The raw files are read through ``data/hdf5.py`` (no h5py): only
``davis/left/{events, image_raw_event_inds, image_raw_ts}`` and
``davis/left/{flow_dist, flow_dist_ts}``, never the image datasets. The
event files are written by ``data/loader_utils.write_events_h5``. It runs
on the host: JAX's script has no device work either.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .data import hdf5
from .data.loader_utils import estimate_corresponding_gt_flow, write_events_h5


def encode_events(raw_events, image_raw_event_inds, image_raw_ts, event_dir,
                  dt_time: int = 1):
    """Slice events into [frame i-1, frame i+dt-1] windows, one .h5 each."""
    os.makedirs(event_dir, exist_ok=True)
    n = image_raw_ts.shape[0] - (dt_time - 1)
    for i in range(n):
        out = os.path.join(event_dir, f"{i:06d}.h5")
        if os.path.exists(out):
            continue
        # the reference's quirk, kept: ``inds[i - 1]`` is python's negative
        # index at i == 0, so frame 0 slices from the last frame's index (an
        # empty window, skipped) whenever inds[-1] >= 0
        lo = (0 if image_raw_event_inds[i - 1] < 0
              else int(image_raw_event_inds[i - 1]))
        hi = int(image_raw_event_inds[i + dt_time - 1])
        frame = np.asarray(raw_events[lo:hi])
        if frame.size == 0:
            continue
        # raw columns: x, y, ts, p -> store ts, x, y, p
        write_events_h5(out, np.stack(
            [frame[:, 2], frame[:, 0], frame[:, 1], frame[:, 3]], 1))


def generate_flowgt(gt_file, image_raw_ts, flowgt_path, dt: int,
                    valid_range=(21, None)):
    """Propagate GT distorted flow across [t_i, t_{i+dt}] per frame i."""
    os.makedirs(flowgt_path, exist_ok=True)
    with hdf5.File(gt_file) as f:
        gt = np.float32(f["davis/left/flow_dist"][()])
        gt_ts = np.float64(f["davis/left/flow_dist_ts"][()])
    U, V = gt[:, 0], gt[:, 1]
    n = image_raw_ts.shape[0]
    lo = valid_range[0]
    hi = valid_range[1] if valid_range[1] is not None else n - 8
    for i in range(n):
        out = os.path.join(flowgt_path, f"{i}.npy")
        if os.path.exists(out) or not (lo < i and i + dt < n and i < hi):
            continue
        try:
            u, v = estimate_corresponding_gt_flow(
                U, V, gt_ts, float(image_raw_ts[i]),
                float(image_raw_ts[i + dt]))
        except IndexError:
            continue
        np.save(out, np.stack((u, v), axis=2).astype(np.float32))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_dir", required=True,
                    help="dir holding <seq>/<seq>_data.hdf5 and _gt.hdf5")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--sequence", required=True)
    ap.add_argument("--dt", type=int, default=1, choices=[1, 4])
    ap.add_argument("--only_event", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    seq = args.sequence
    data_path = os.path.join(args.data_dir, seq, f"{seq}_data.hdf5")
    save_path = os.path.join(args.out_dir, seq)

    with hdf5.File(data_path) as d:
        raw = np.asarray(d["davis/left/events"][()])
        inds = np.asarray(d["davis/left/image_raw_event_inds"][()])
        ts = np.float64(d["davis/left/image_raw_ts"][()])

    encode_events(raw, inds, ts, os.path.join(save_path, "event"))
    print("events encoded")

    if not args.only_event:
        gt_file = os.path.join(args.data_dir, seq, f"{seq}_gt.hdf5")
        generate_flowgt(gt_file, ts,
                        os.path.join(save_path, f"flowgt_dt{args.dt}"),
                        args.dt)
        print(f"flowgt_dt{args.dt} encoded")


if __name__ == "__main__":
    main()
