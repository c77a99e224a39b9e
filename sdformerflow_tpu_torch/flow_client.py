"""Client for the flow inference server (``sdformerflow_tpu_torch.serve``),
the counterpart of ``scripts/flow_client.py``.

Importable helpers (used by tests and ``chip_smoke.py``) + a small CLI.
The wire protocol is numpy ``.npz`` bodies — POST /flow with either
``chunk`` ([bins, H, W] voxels at crop size) or ``x,y,t,p`` ([N] raw
events at sensor resolution); the response npz carries ``flow``
([2, H, W] float32).

    # voxels from an .npy/.npz file (key 'chunk' if npz)
    python -m sdformerflow_tpu_torch.flow_client --url http://127.0.0.1:8787 \
        --chunk win.npy --out flow.npy
    # raw events from an npz with x/y/t/p arrays
    python -m sdformerflow_tpu_torch.flow_client --url http://127.0.0.1:8787 \
        --events ev.npz
"""

from __future__ import annotations

import argparse
import io
import json
import urllib.request

import numpy as np


def post_flow(url: str, *, chunk=None, events=None, timeout: float = 300.0):
    """POST one request; returns the flow [2, H, W] float32.

    Exactly one of ``chunk`` (array) / ``events`` (dict with x/y/t/p)
    must be given.
    """
    if (chunk is None) == (events is None):
        raise ValueError("pass exactly one of chunk/events")
    buf = io.BytesIO()
    if chunk is not None:
        np.savez(buf, chunk=np.asarray(chunk, np.float32))
    else:
        np.savez(buf, **{k: np.asarray(events[k]) for k in
                         ("x", "y", "t", "p")})
    req = urllib.request.Request(url.rstrip("/") + "/flow",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return np.load(io.BytesIO(r.read()))["flow"]


def get_stats(url: str, timeout: float = 30.0) -> dict:
    """GET /stats: served, pending and the latency percentiles."""
    with urllib.request.urlopen(url.rstrip("/") + "/stats",
                                timeout=timeout) as r:
        return json.loads(r.read())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", default="http://127.0.0.1:8787")
    ap.add_argument("--chunk", help=".npy/.npz voxel chunk [bins, H, W]")
    ap.add_argument("--events", help=".npz with x/y/t/p event arrays")
    ap.add_argument("--out", help="write the flow to this .npy path")
    ap.add_argument("--stats", action="store_true",
                    help="print server stats and exit")
    args = ap.parse_args()

    if args.stats:
        print(json.dumps(get_stats(args.url)))
        return
    if args.chunk:
        data = np.load(args.chunk)
        chunk = data["chunk"] if hasattr(data, "files") else data
        flow = post_flow(args.url, chunk=chunk)
    elif args.events:
        data = np.load(args.events)
        flow = post_flow(args.url,
                         events={k: data[k] for k in ("x", "y", "t", "p")})
    else:
        raise SystemExit("pass --chunk, --events, or --stats")
    mag = np.sqrt((flow ** 2).sum(0))
    print(f"flow {flow.shape} | mean |v| {mag.mean():.4f} px "
          f"| max |v| {mag.max():.4f} px")
    if args.out:
        np.save(args.out, flow)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
