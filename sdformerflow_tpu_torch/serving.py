"""Persistent-process inference serving, a port of
``sdformerflow_tpu/serving.py:FlowServer``.

The unit of work is one event window -> one flow map. A request is either
a voxel chunk at crop size or a dict of raw events x/y/t/p at sensor
resolution. Throughput comes from keeping the card busy across requests:
PyTorch launches CUDA work asynchronously, so a dispatch thread packs,
uploads and launches request k+1 while a fetch thread waits for request
k's result on the host and resolves its future - the only thread that
waits on the device.

Raw events are packed on the host into one [1, 5, bucket] float32 buffer
(x/y/t/p/valid; pinned on the card's host, ``native.pack_window``), copied
to the device in one non-blocking transfer, voxelized there by K3
(``ops/hopper_voxel.py``) and center-cropped inside the eval step. K3 is
order-free, so the events are not sorted on the host. Event counts are
padded to power-of-two buckets (:func:`next_bucket`).

``s2d=True`` serves the exact space-to-depth re-expression of the embed
head (``training/s2d_embed.py``), as the JAX server's option does.
``model=`` serves a model built elsewhere, e.g. one that
``training/bn_folding.py:fold_model`` folded (JAX passes such a model in
its ``state``).

The ANN family (STTFlowNet, MultiResUNet) is served from voxel requests of
its chunk's bins (``data.num_frames * data.num_chunks``, 20 for the DSEC
STT config). Events are voxelized into ``data.num_frames`` bins, as in
JAX, so where the model takes another count (the STT configs' two chunks)
an events request fails with a ``ValueError`` that says so.

Batching over devices (JAX ``mesh=``, ``serving.py:243-352``): with
``devices=[d0, d1, ...]`` (``parallel/mesh.py:make_mesh``; a device may
appear more than once) the dispatch thread coalesces up to ``len(devices)``
queued compatible requests (the same kind and event bucket, waiting
``batch_window_s`` for more; an incompatible request is parked as the next
group's leader) into one batch padded to ``len(devices)`` rows; row i runs
on ``devices[i]``, and each distinct device runs its rows as one batched
forward on its own replica of the model (an events group is packed into
one pinned ``[pad, 5, bucket]`` buffer, one K3 launch a row). The fetch
thread resolves each request's future from its row. A batched row's flow
is its batch-1 flow (``make_eval_step(per_row=True)``: each request's
input is normalized on its own and the spiking swin blocks refold each row
on its own; the reference's raw refold mixes a batch's rows, and so does
JAX's mesh server). A model whose eval forward
itself mixes a batch's rows (BN_notrack's batch statistics, the STT's
two-window standardization: ``couples_rows``) runs a group as one batch
on one device as JAX does, and refuses a list of several distinct devices,
where each would take its own rows' statistics.

Not ported: the fused-attention option (the port's eval attention always
runs K1). The HTTP front is ``serve.py`` (``python -m
sdformerflow_tpu_torch.serve``).
"""

from __future__ import annotations

import itertools
import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from . import native
from .parallel.mesh import distinct, make_mesh, replicate
from .training.config import chunk_bins
from .training.export import build_inference_state, step_kwargs
from .training.train_step import make_eval_step
from .utils import tracing

# counted at all times (``stats()``), and into the tracer while it is on
COUNTERS = ("serve.requests", "serve.groups", "serve.rows",
            "serve.event_slots", "serve.failed")


def next_bucket(n: int, minimum: int = 4096) -> int:
    """Smallest power of two >= n (and >= minimum): the padded event-buffer
    length, so requests fall into ~log2(max events) shapes."""
    return max(minimum, 1 << max(int(n) - 1, 1).bit_length())


class FlowServer:
    """Inference engine over one model.

    Parameters
    ----------
    config: parsed config dict (``training.config.load_config``).
    state_dict: the model's weights (e.g. ``training.from_jax.from_jax``);
        ``None`` keeps the model's initialization.
    ckpt: a checkpoint directory of the port's trainer
        (``training/checkpoints.py``) or a ``.pt`` under the reference's
        state_dict names, restored into the model alone before the bf16
        cast; not together with ``state_dict``. The model is built by
        ``training.export.build_inference_state``, as the exporter's.
    device: where the model runs (``"cuda"`` launches the Hopper kernels).
    devices: a list of devices to batch queued requests over (see the
        module's docstring), ``devices[0]`` in place of ``device``; None
        serves one request a forward.
    batch_window_s: how long the dispatcher waits for more requests to
        fill a batch once one is in hand (only with ``devices``).
    bf16: run the bf16 inference path (params and activations bf16, BN
        statistics float32) - the deployment path.
    max_pending: bound on queued and in-flight requests before ``submit``
        blocks.
    s2d: serve the space-to-depth re-expression of the embed head
        (``training/s2d_embed.py``, exact; the MS_PED embed with BN only),
        applied to the weights before the bf16 cast.
    model: a model of ``config``'s geometry, weights loaded (e.g. folded
        by ``training.bn_folding.fold_model``), served in place of the one
        the other arguments would build; cast on a copy for bf16.
    """

    def __init__(self, config: dict, state_dict: Optional[dict] = None, *,
                 ckpt: Optional[str] = None, device="cuda", bf16: bool = True,
                 max_pending: int = 8, s2d: bool = False,
                 model: Optional[torch.nn.Module] = None, devices=None,
                 batch_window_s: float = 0.002):
        self._devices = None if devices is None else make_mesh(
            devices=devices)
        self.device = torch.device(device) if devices is None \
            else self._devices[0]
        if model is None:
            model = build_inference_state(config, ckpt, s2d,
                                          device=self.device,
                                          state_dict=state_dict)
        elif state_dict is not None or ckpt is not None or s2d:
            raise ValueError("give model, or state_dict / ckpt / s2d to "
                             "build one, not both")
        else:
            model = model.to(self.device).eval()
        self._input_bins = chunk_bins(config)
        self._num_bins = config["data"].get("num_frames", 10)
        self._resolution = tuple(config["loader"].get("resolution",
                                                      (480, 640)))
        crop = config["loader"].get("crop")
        self._crop = tuple(crop) if crop else None
        batched = devices is not None
        self._batch = len(self._devices) if batched else 1
        self._batch_window = float(batch_window_s)
        self._step = make_eval_step(
            model, **step_kwargs(config, bf16=bf16, events=False),
            per_row=batched)
        self.model = self._step.model
        # the events step runs the same cast model: voxelize at sensor
        # resolution, center crop, forward
        self._events_step = make_eval_step(
            self.model, **step_kwargs(config, bf16=bf16, events=True),
            per_row=batched)
        # (voxel step, events step) of each distinct device's replica
        self._steps = {self.device: (self._step, self._events_step)}
        if batched:
            self._replicate(config, bf16)

        self._requests: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=max_pending)
        self._inflight: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=max_pending)
        self._closed = threading.Event()
        self._lock = threading.Lock()
        self._served = 0
        self._latencies: list = []
        self._counts = dict.fromkeys(COUNTERS, 0)
        self._request_ids = itertools.count()
        self._group_ids = itertools.count()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="flow-dispatch")
        self._fetcher = threading.Thread(
            target=self._fetch_loop, daemon=True, name="flow-fetch")
        self._dispatcher.start()
        self._fetcher.start()

    def _replicate(self, config, bf16):
        """The batched server's replicas: one copy of the cast model (its
        rows refolded apart) per distinct device, each with its two
        steps."""
        homes = distinct(self._devices)
        mixers = sorted({type(m).__name__ for m in self.model.modules()
                         if getattr(m, "couples_rows", False)})
        if mixers and len(homes) > 1:
            raise ValueError(
                f"this model's eval forward mixes the rows of a batch "
                f"({', '.join(mixers)}: batch statistics); over "
                f"{len(homes)} devices each would take its own rows' "
                "statistics, unlike one batch: serve it on one device "
                "(devices=[d] * n) or with devices=None")
        for dev, model in replicate(self.model, homes).items():
            if dev != self.device:
                self._steps[dev] = tuple(make_eval_step(
                    model, **step_kwargs(config, bf16=bf16, events=events),
                    per_row=True) for events in (False, True))

    # ---------------------------------------------------------------- API

    def submit(self, request) -> Future:
        """Enqueue one window; returns a Future resolving to the flow map
        [2, h, w] float32 at crop size.

        ``request`` is either a voxel chunk ([bins, h, w] or
        [bins, 2, h, w] numpy array, already at crop size) or a dict with
        keys x/y/t/p ([N] arrays of raw events at sensor resolution:
        uint16/uint16/int64/uint8 as DSEC stores them, or any numeric
        dtype), voxelized and center-cropped on the device.
        """
        if self._closed.is_set():
            raise RuntimeError("server closed")
        fut: Future = Future()
        self._requests.put((fut, request, time.perf_counter_ns(),
                            next(self._request_ids)))
        return fut

    def infer(self, request):
        """Synchronous single-request helper."""
        return self.submit(request).result()

    def warmup(self, n_events: Optional[int] = None, *,
               all_buckets: bool = False):
        """Serve a zero voxel request, plus one events request in the bucket
        of ``n_events`` (with ``all_buckets``, in every bucket from the
        smallest up to it), so that the first requests of real traffic do
        not pay for kernel builds and allocations."""
        h, w = self._crop or self._resolution
        self.infer(np.zeros((self._input_bins, h, w), np.float32))
        if n_events is None:
            return
        top = next_bucket(n_events)
        buckets = [top]
        if all_buckets:
            b = next_bucket(0)
            while b < top:
                buckets.insert(-1, b)
                b *= 2
        for bucket in buckets:
            self.infer({"x": np.zeros(bucket, np.float32),
                        "y": np.zeros(bucket, np.float32),
                        "t": np.linspace(0, 1, bucket, dtype=np.float32),
                        "p": np.ones(bucket, np.float32)})

    def pack_events(self, request: dict) -> torch.Tensor:
        """One raw-events request -> its [1, 5, bucket] float32 host buffer
        (rows x, y, t, p, valid), pinned when the server runs on the card.
        ``t`` is taken as it comes (no rebase), as the JAX server packs
        it."""
        return self._pack_group([request], 1)

    def _pinned(self) -> bool:
        return any(d.type == "cuda" for d in self._steps)

    def _pack_group(self, requests, rows: int) -> torch.Tensor:
        """Raw-events requests -> one [rows, 5, bucket] float32 host buffer
        in the largest request's bucket, the rows past the requests'
        all-zero (no valid event)."""
        bucket = next_bucket(max(len(r["x"]) for r in requests))
        buf = torch.empty((rows, 5, bucket), dtype=torch.float32,
                          pin_memory=self._pinned())
        buf[len(requests):] = 0
        for b, r in enumerate(requests):
            native.pack_window(r["x"], r["y"], r["t"], r["p"], bucket,
                               t0=0.0, out=buf[b].numpy())
        return buf

    def stats(self) -> dict:
        """Requests served and pending, the p50 / p95 latency (ms) of the
        last 512-1024 served, and the counters since the start
        (``COUNTERS``: requests launched, groups, rows launched with their
        padding, event slots, failed requests)."""
        with self._lock:
            lat = list(self._latencies)
            served = self._served
            counts = dict(self._counts)
        out = {"served": served, "pending": self._requests.qsize()
               + self._inflight.qsize(), **counts}
        if lat:
            out["latency_ms_p50"] = float(np.percentile(lat, 50) * 1e3)
            out["latency_ms_p95"] = float(np.percentile(lat, 95) * 1e3)
        return out

    def close(self):
        self._closed.set()
        self._requests.put(None)
        self._dispatcher.join(timeout=30)
        self._inflight.put(None)
        self._fetcher.join(timeout=30)

    @staticmethod
    def _batch_key(request):
        """Requests coalesce into one batch iff their keys match: the same
        kind and event bucket (voxel chunks: the same shape)."""
        if isinstance(request, dict):
            return ("events", next_bucket(len(request["x"])))
        return ("voxel", np.shape(request))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ workers

    def _collect_group(self, leader):
        """The leader request plus up to batch - 1 more compatible requests
        arriving within the batching window. Returns (group, stop) where
        ``stop`` means the close sentinel was seen."""
        group = [leader]
        try:
            key = self._batch_key(leader[1])
        except Exception:  # noqa: BLE001 - a malformed request fails alone
            return group, False
        deadline = time.perf_counter() + self._batch_window
        while len(group) < self._batch:
            timeout = deadline - time.perf_counter()
            try:
                nxt = (self._requests.get(timeout=timeout) if timeout > 0
                       else self._requests.get_nowait())
            except queue_mod.Empty:
                break
            if nxt is None:
                return group, True
            try:
                compatible = self._batch_key(nxt[1]) == key
            except Exception as e:  # noqa: BLE001 - delivered via future
                self._fail([nxt[0]], e)
                continue
            if not compatible:
                self._carry = nxt   # the next group's leader
                break
            group.append(nxt)
        return group, False

    def _dispatch_loop(self):
        self._carry = None
        stop = False
        while not stop:
            item = self._carry if self._carry is not None \
                else self._requests.get()
            self._carry = None
            if item is None:
                break
            group, stop = (self._collect_group(item) if self._batch > 1
                           else ([item], False))
            live = [item for item in group
                    if item[0].set_running_or_notify_cancel()]
            if not live:
                continue
            gid = next(self._group_ids)
            if tracing.on():
                now = time.perf_counter_ns()
                for _, _, t, rid in live:
                    tracing.record("serve.queue", t, now, key=rid,
                                   parent=("serve.pack", gid))
            try:
                parts, tally = self._launch([r for _, r, _, _ in live], gid)
            except Exception as e:  # noqa: BLE001 - delivered via futures
                self._fail([f for f, _, _, _ in live], e)
                continue
            self._inflight.put(([f for f, _, _, _ in live], parts,
                                [t for _, _, t, _ in live], tally))
        # fail what is still queued once closed
        closed = RuntimeError("server closed")
        if self._carry is not None:
            self._fail([self._carry[0]], closed)
        while True:
            try:
                item = self._requests.get_nowait()
            except queue_mod.Empty:
                break
            if item is not None:
                self._fail([item[0]], closed)

    def _tally(self, counts: dict):
        """Add ``counts`` to the server's counters (under the lock) and to
        the tracer's (while it is on)."""
        with self._lock:
            for name, n in counts.items():
                self._counts[name] += n
        for name, n in counts.items():
            tracing.count(name, n)

    def _fail(self, futures, exc):
        self._tally({"serve.failed": len(futures)})
        for fut in futures:
            fut.set_exception(exc)

    def _rows_by_device(self, rows: int):
        """[(device, [row indices])]: row i of a batch runs on
        ``devices[i]``; one entry per distinct device, in first-mention
        order."""
        if self._devices is None:
            return [(self.device, list(range(rows)))]
        out: dict = {}
        for i, dev in enumerate(self._devices):
            out.setdefault(dev, []).append(i)
        return list(out.items())

    def _launch(self, requests, gid: int):
        """Upload group ``gid`` of compatible requests, padded to the batch,
        and launch each device's rows as one forward; returns ([(finest
        flows on the device (launched, not waited for), row indices)], the
        group's counts)."""
        rows = max(self._batch, len(requests))
        events = isinstance(requests[0], dict)
        if events and self._input_bins != self._num_bins:
            raise ValueError(
                f"events are voxelized into data.num_frames = "
                f"{self._num_bins} bins but the model takes "
                f"{self._input_bins}-bin chunks (data.num_chunks = "
                f"{self._input_bins // self._num_bins}): send voxel "
                "chunks")
        with tracing.span("serve.pack", gid):
            if events:
                buf = self._pack_group(requests, rows)
            else:
                first = np.asarray(requests[0], np.float32)
                buf = torch.zeros((rows,) + first.shape,
                                  dtype=torch.float32,
                                  pin_memory=self._pinned())
                for b, r in enumerate(requests):
                    buf[b] = torch.as_tensor(np.asarray(r, np.float32))
        parts = []
        for dev, idx in self._rows_by_device(rows):
            part = buf[idx[0]:idx[-1] + 1] if idx == list(
                range(idx[0], idx[-1] + 1)) else buf[idx]
            with tracing.span("serve.upload", gid):
                part = part.to(dev, non_blocking=True)
            voxel_step, events_step = self._steps[dev]
            with tracing.span("serve.issue", gid):
                if events:
                    flows = events_step({
                        "x": part[:, 0], "y": part[:, 1], "t": part[:, 2],
                        "p": part[:, 3], "valid": part[:, 4] != 0})
                else:
                    flows = voxel_step(part)
            parts.append((flows[-1], idx))   # finest scale
        tally = {"serve.requests": len(requests), "serve.groups": 1,
                 "serve.rows": rows,
                 "serve.event_slots": buf.shape[0] * buf.shape[2]
                 if events else 0}
        return parts, tally

    def _fetch_loop(self):
        while True:
            item = self._inflight.get()
            if item is None:
                break
            futs, parts, t0s, tally = item
            self._tally(tally)
            try:
                rows = {}
                for flow, idx in parts:
                    host = flow.cpu().numpy()   # waits for the device
                    rows.update(zip(idx, host))
            except Exception as e:  # noqa: BLE001 - delivered via futures
                self._fail(futs, e)
                continue
            for i, fut in enumerate(futs):
                fut.set_result(rows[i])
            now = time.perf_counter_ns()
            with self._lock:
                self._served += len(futs)
                self._latencies.extend((now - t0) / 1e9 for t0 in t0s)
                if len(self._latencies) > 1024:
                    del self._latencies[:512]
