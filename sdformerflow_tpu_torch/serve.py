"""HTTP inference server for event-camera optical flow, the counterpart of
``scripts/serve.py``: a front over :class:`serving.FlowServer` (the bf16
eval step on the card, dispatch and fetch threads pipelining requests, raw
events voxelized by K3).

    python -m sdformerflow_tpu_torch.serve \\
        --train_config configs/train_dsec_sdformerflow_en4.yaml \\
        --ckpt runs/en4/ckpt --port 8787 [--warmup_events 1048576] \\
        [--device cpu]

``--port 0`` binds a free port; the line ``serving on http://HOST:PORT``
names it. SIGTERM finishes the requests in flight, then closes the server.
``--dp N`` batches up to N queued compatible requests over the cards
``cuda:0 .. cuda:N-1`` (``FlowServer(devices=...)``), and refuses when
fewer cards are visible; with ``--device cpu`` over N CPU replicas of one
model (one batch of N rows on the CPU).

Protocol (numpy .npz bodies):
  POST /flow   body npz with either ``chunk`` ([bins, H, W] voxels at crop
               size) or ``x,y,t,p`` ([N] raw events at sensor resolution;
               for a model of two event windows, E-RAFT's
               ``configs/dsec_eraft.yaml``: ``old_x, ..., old_p`` and
               ``new_x, ..., new_p``, the two consecutive windows)
               -> npz response with ``flow`` ([2, H, W] float32); 400 with
               the error's text when the body or the request is bad
  GET  /stats  -> JSON {served, pending, latency_ms_p50, latency_ms_p95,
               serve.requests, serve.groups, serve.rows, serve.event_slots,
               serve.failed}: the counters since the start (requests
               launched, forwards, rows launched with their padding, raw
               event slots voxelized, requests answered with an error)
  GET  /healthz -> 200 "ok"

Where the time goes inside the server: its dispatch and fetch threads
record spans (``utils/tracing.py``: each request's ``serve.queue``, each
forward's ``serve.pack``, ``serve.upload`` and ``serve.issue``) while a
``torch.profiler`` session runs or inside ``tracing.enable()``;
``tracing.chrome_events(trace["baseTimeNanoseconds"])`` gives them as
chrome-trace events to add to the profiler's exported trace (Perfetto).
"""

from __future__ import annotations

import argparse
import io
import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


def build_handler(server):
    """The request handler class over ``server`` (a ``FlowServer``)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/stats":
                self._send(200, json.dumps(server.stats()).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/flow":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            try:
                data = np.load(io.BytesIO(body), allow_pickle=False)
                if "chunk" in data:
                    request = data["chunk"]
                elif "old_x" in data:
                    request = {w: {k: data[f"{w}_{k}"] for k in "xytp"}
                               for w in ("old", "new")}
                else:
                    request = {k: data[k] for k in ("x", "y", "t", "p")}
                flow = server.infer(request)
            except Exception as e:  # noqa: BLE001 - surfaced to the client
                self._send(400, f"{type(e).__name__}: {e}".encode(),
                           "text/plain")
                return
            buf = io.BytesIO()
            np.savez_compressed(buf, flow=flow)
            self._send(200, buf.getvalue())

    return Handler


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train_config", required=True)
    ap.add_argument("--eval_config", default=None)
    ap.add_argument("--ckpt", default=None,
                    help="a trainer checkpoint directory, or a .pt under "
                         "the reference's state_dict names")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787,
                    help="0 binds a free port (printed)")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: the card)")
    ap.add_argument("--no_bf16", action="store_true")
    ap.add_argument("--warmup_events", type=int, default=None,
                    help="serve one events request in this many events' "
                         "bucket at startup")
    ap.add_argument("--warmup_all_buckets", action="store_true",
                    help="also warm every smaller event bucket")
    ap.add_argument("--dp", type=int, default=1,
                    help="batch queued requests over this many devices: "
                         "cuda:0..N-1, or N rows on the CPU with --device "
                         "cpu")
    ap.add_argument("--s2d", action="store_true",
                    help="exact space-to-depth embed re-expression "
                         "(MS_PED models with running-stats BN only)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cuda = torch.device(args.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device; pass --device cpu to serve "
                         "on the CPU")
    devices = None
    if args.dp > 1:
        if cuda and torch.cuda.device_count() < args.dp:
            raise SystemExit(f"serve: --dp {args.dp} needs {args.dp} CUDA "
                             f"devices, {torch.cuda.device_count()} visible")
        devices = [f"cuda:{i}" for i in range(args.dp)] if cuda \
            else [args.device] * args.dp
    from .serving import FlowServer
    from .training.config import load_config, merge_eval_config

    config = load_config(args.train_config)
    if args.eval_config:
        config = merge_eval_config(config, load_config(args.eval_config))
    server = FlowServer(config, ckpt=args.ckpt, device=args.device,
                        bf16=not args.no_bf16, s2d=args.s2d,
                        devices=devices)
    try:
        print("warming up...", flush=True)
        server.warmup(args.warmup_events,
                      all_buckets=args.warmup_all_buckets)
        httpd = ThreadingHTTPServer((args.host, args.port),
                                    build_handler(server))
        host, port = httpd.server_address[:2]
        print(f"serving on http://{host}:{port}", flush=True)
        # graceful stop on SIGTERM (what orchestrators send): shutdown()
        # waits for serve_forever to return, so it runs on a helper thread
        signal.signal(signal.SIGTERM, lambda s, f: threading.Thread(
            target=httpd.shutdown, daemon=True).start())
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
    finally:
        server.close()
    print("server closed", flush=True)


if __name__ == "__main__":
    main()
