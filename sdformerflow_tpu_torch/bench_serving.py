"""Serving throughput at the DSEC eval protocol's scale, the counterpart of
``scripts/bench_serving.py``, over the port's :class:`serving.FlowServer`:
the request rate end to end (host pack and bucket, H2D, the bf16 forward,
D2H, pipelined across requests) for voxel requests at the crop and for
raw-event requests of 2^``--events_exp`` events at sensor resolution
(voxelized by K3 on the card, center-cropped, forward). The model keeps its
initialization, as in the JAX script.

    python -m sdformerflow_tpu_torch.bench_serving [--requests 32] \\
        [--events_exp 20] [--device cpu]

It runs on the card unless ``--device cpu`` and prints the card's name and
power limit (``nvidia-smi``) beside the numbers.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "train_dsec_sdformerflow_en4.yaml")


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else \
        "nvidia-smi unavailable"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--events_exp", type=int, default=20,
                    help="log2 events per raw-event request")
    ap.add_argument("--config", default=CONFIG)
    ap.add_argument("--no_events", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns ``{label: {"requests", "seconds", "windows_per_s",
    "ms_per_request", "stats"}}`` and the card."""
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("bench_serving: no CUDA device; pass --device cpu")
    from .serving import FlowServer
    from .training.config import load_config

    config = load_config(args.config)
    h, w = config["loader"].get("crop") or [288, 384]
    res = config["loader"].get("resolution", [480, 640])
    bins = config["data"].get("num_frames", 10)
    n_events = 1 << args.events_exp
    rng = np.random.default_rng(0)
    card = (card_name() if torch.device(args.device).type == "cuda"
            else "cpu")
    print(f"device {args.device}: {card}", flush=True)
    out = {"card": card}

    with FlowServer(config, device=args.device, bf16=True) as server:
        t0 = time.perf_counter()
        server.warmup(None if args.no_events else n_events)
        print(f"warmup {time.perf_counter() - t0:.1f}s", flush=True)

        def drive(make_request, label):
            # warm the queue depth, then measure the steady state
            [f.result() for f in [server.submit(make_request())
                                  for _ in range(4)]]
            t0 = time.perf_counter()
            futs = [server.submit(make_request())
                    for _ in range(args.requests)]
            flows = [f.result() for f in futs]
            dt = time.perf_counter() - t0
            if not all(np.isfinite(fl).all() for fl in flows):
                raise RuntimeError(f"{label}: a flow is not finite")
            out[label] = {"requests": args.requests, "seconds": dt,
                          "windows_per_s": args.requests / dt,
                          "ms_per_request": dt / args.requests * 1e3,
                          "stats": server.stats()}
            print(f"{label}: {args.requests} requests in {dt:.3f}s = "
                  f"{args.requests / dt:.2f} windows/s "
                  f"({dt / args.requests * 1e3:.2f} ms/request); "
                  f"stats {server.stats()}; {card}", flush=True)

        drive(lambda: rng.normal(
            size=(bins, h, w)).astype(np.float32) * 0.3, "voxel@crop")

        if not args.no_events:
            def make_events():
                return {
                    "x": rng.uniform(0, res[1] - 1,
                                     n_events).astype(np.float32),
                    "y": rng.uniform(0, res[0] - 1,
                                     n_events).astype(np.float32),
                    "t": np.sort(rng.uniform(0, 1, n_events)
                                 ).astype(np.float32),
                    "p": rng.integers(0, 2, n_events).astype(np.float32)}
            drive(make_events, f"events@2^{args.events_exp}")
    return out


if __name__ == "__main__":
    main()
