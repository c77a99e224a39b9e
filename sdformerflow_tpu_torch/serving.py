"""Persistent-process inference serving, a port of
``sdformerflow_tpu/serving.py:FlowServer``.

The unit of work is one event window -> one flow map. A request is either
a voxel chunk at crop size or a dict of raw events x/y/t/p at sensor
resolution. Throughput comes from keeping the card busy across requests,
on three threads: a staging thread (``flow-stage``) fills each request's
own host slab the moment it arrives, in arrival order; a dispatch thread
(``flow-dispatch``) groups staged requests, copies their slabs to the
device and launches the forward (PyTorch launches CUDA work
asynchronously), so it packs nothing; a fetch thread waits for each
group's result on the host and resolves its futures - the only thread
that waits on the device. A request is staged while the group before it
is issued.

Raw events are packed on the host into the request's own [5, bucket]
float32 slab (x/y/t/p/valid; pinned on the card's host,
``native.pack_window``, which runs without the GIL), copied into its row
of the group's device buffer by one non-blocking transfer, voxelized there
by K3 (``ops/hopper_voxel.py``) and center-cropped inside the eval step.
K3 is order-free, so the events are not sorted on the host. Event counts
are padded to power-of-two buckets (:func:`next_bucket`).

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

A model whose input is consecutive event windows (its ``event_windows``:
E-RAFT's two, ``models/eraft.py``) takes an events request as those
windows, ``{"old": {x, y, t, p}, "new": {x, y, t, p}}``: both are packed
into the request's own slab, one after the other, each padded to its own
bucket; K3 runs once a window and row, each window over its own time span
into ``data.num_frames`` bins, and each window's grid is normalized on its
own (``make_eval_step`` reads the model's ``event_windows``). A one-window
request to such a server, or a two-window request to any other, fails with
a ``ValueError`` that names the form the server takes. Voxel requests take
the whole chunk, ``[data.num_frames * data.num_chunks, H, W]``.

Batching over devices (JAX ``mesh=``, ``serving.py:243-352``): with
``devices=[d0, d1, ...]`` (``parallel/mesh.py:make_mesh``; a device may
appear more than once) the dispatch thread coalesces up to ``len(devices)``
queued compatible requests (the same kind and event bucket, waiting
``batch_window_s`` for more; an incompatible request is parked as the next
group's leader) into one batch padded to ``len(devices)`` rows; row i runs
on ``devices[i]``, and each distinct device runs its rows as one batched
forward on its own replica of the model (an events group fills one
``[rows, 5, bucket]`` buffer on the device, a slab a row and the padded
rows zeroed there, one K3 launch a row). The fetch
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
from typing import NamedTuple, Optional

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
            "serve.event_slots", "serve.failed", "serve.staged")


class Staged(NamedTuple):
    """A request as the staging thread hands it to the dispatch thread."""
    future: Future
    submitted_ns: int      # time.perf_counter_ns() at submit
    rid: int               # the request's id (its spans' key)
    slab: torch.Tensor     # its own host buffer: [5, bucket] or the chunk
    key: tuple             # (kind, bucket or shape): a batch shares one


def next_bucket(n: int, minimum: int = 4096) -> int:
    """Smallest power of two >= n (and >= minimum): the padded event-buffer
    length, so requests fall into ~log2(max events) shapes."""
    return max(minimum, 1 << max(int(n) - 1, 1).bit_length())


def _rows(buf: torch.Tensor) -> dict:
    """A [rows, 5, bucket] buffer of packed windows -> the events step's
    x / y / t / p / valid rows."""
    return {"x": buf[:, 0], "y": buf[:, 1], "t": buf[:, 2], "p": buf[:, 3],
            "valid": buf[:, 4] != 0}


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
    max_pending: bound on requests submitted and not yet answered
        (queued, staged and in flight) before ``submit`` blocks.
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
        self._windows = getattr(model, "event_windows", 1)
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

        # submitted -> staging thread -> staged -> dispatch thread ->
        # in flight (groups) -> fetch thread; ``_room`` bounds the whole
        self._requests: "queue_mod.Queue" = queue_mod.Queue()
        self._staged: "queue_mod.Queue" = queue_mod.Queue()
        self._inflight: "queue_mod.Queue" = queue_mod.Queue()
        self._room = threading.BoundedSemaphore(max_pending)
        self._closed = threading.Event()
        self._lock = threading.Lock()
        self._served = 0
        self._latencies: list = []
        self._counts = dict.fromkeys(COUNTERS, 0)
        self._request_ids = itertools.count()
        self._group_ids = itertools.count()
        self._stager = threading.Thread(
            target=self._stage_loop, daemon=True, name="flow-stage")
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="flow-dispatch")
        self._fetcher = threading.Thread(
            target=self._fetch_loop, daemon=True, name="flow-fetch")
        for thread in (self._stager, self._dispatcher, self._fetcher):
            thread.start()

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
        dtype), voxelized and center-cropped on the device. A model of two
        event windows (E-RAFT) takes ``{"old": {x, y, t, p}, "new": {x,
        y, t, p}}``: the older window and the one after it, each
        voxelized over its own time span and normalized on its own;
        requests batch together when both windows' buckets match.
        """
        if self._closed.is_set():
            raise RuntimeError("server closed")
        self._room.acquire()
        fut: Future = Future()
        fut.add_done_callback(lambda _: self._room.release())
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
            window = {"x": np.zeros(bucket, np.float32),
                      "y": np.zeros(bucket, np.float32),
                      "t": np.linspace(0, 1, bucket, dtype=np.float32),
                      "p": np.ones(bucket, np.float32)}
            self.infer(window if self._windows == 1
                       else {"old": window, "new": window})

    def pack_events(self, request: dict) -> torch.Tensor:
        """One raw-events request -> its [1, 5, bucket] float32 host buffer
        (rows x, y, t, p, valid), pinned when the server runs on the card
        (a two-window request: its flat slab, [1, 5 * (bucket_old +
        bucket_new)]). ``t`` is taken as it comes (no rebase), as the JAX
        server packs it."""
        return self._stage(request)[0][None]

    def _pinned(self) -> bool:
        return any(d.type == "cuda" for d in self._steps)

    def _stage(self, request):
        """One request -> (its own host slab, its batch key): raw events
        packed into a [5, bucket] float32 slab in their count's bucket (two
        windows: each window's [5, bucket] one after the other in one flat
        slab), a voxel chunk copied as float32; pinned when the server runs
        on the card. Requests coalesce into one batch iff their keys match:
        the same kind and event buckets (voxel chunks: the same shape)."""
        if isinstance(request, dict):
            pair = "old" in request or "new" in request
            if pair != (self._windows == 2):
                raise ValueError(
                    "this server takes events as "
                    + ('{"old": {x, y, t, p}, "new": {x, y, t, p}}: two '
                       "consecutive windows, older first"
                       if self._windows == 2 else
                       "one window {x, y, t, p}, not a window pair"))
            if pair:
                return self._stage_pair(request["old"], request["new"])
            if self._input_bins != self._num_bins:
                raise ValueError(
                    f"events are voxelized into data.num_frames = "
                    f"{self._num_bins} bins but the model takes "
                    f"{self._input_bins}-bin chunks (data.num_chunks = "
                    f"{self._input_bins // self._num_bins}): send voxel "
                    "chunks")
            bucket = next_bucket(len(request["x"]))
            slab = torch.empty((5, bucket), dtype=torch.float32,
                               pin_memory=self._pinned())
            native.pack_window(request["x"], request["y"], request["t"],
                               request["p"], bucket, t0=0.0,
                               out=slab.numpy())
            return slab, ("events", bucket)
        chunk = torch.as_tensor(np.asarray(request, np.float32))
        slab = torch.empty(chunk.shape, dtype=torch.float32,
                           pin_memory=self._pinned())
        slab.copy_(chunk)
        return slab, ("voxel", tuple(chunk.shape))

    def _stage_pair(self, old: dict, new: dict):
        """Two windows -> one flat slab, each window's [5, bucket] in turn
        in its own bucket; key ("pair", (bucket_old, bucket_new))."""
        buckets = tuple(next_bucket(len(w["x"])) for w in (old, new))
        slab = torch.empty(5 * sum(buckets), dtype=torch.float32,
                           pin_memory=self._pinned())
        at = 0
        for w, bucket in zip((old, new), buckets):
            native.pack_window(w["x"], w["y"], w["t"], w["p"], bucket,
                               t0=0.0, out=slab[at:at + 5 * bucket]
                               .view(5, bucket).numpy())
            at += 5 * bucket
        return slab, ("pair", buckets)

    def stats(self) -> dict:
        """Requests served and pending, the p50 / p95 latency (ms) of the
        last 512-1024 served, and the counters since the start
        (``COUNTERS``: requests launched, groups, rows launched with their
        padding, event slots, failed requests, requests staged)."""
        with self._lock:
            lat = list(self._latencies)
            served = self._served
            counts = dict(self._counts)
        out = {"served": served, "pending": self._requests.qsize()
               + self._staged.qsize() + self._inflight.qsize(), **counts}
        if lat:
            out["latency_ms_p50"] = float(np.percentile(lat, 50) * 1e3)
            out["latency_ms_p95"] = float(np.percentile(lat, 95) * 1e3)
        return out

    def close(self):
        """Serve what was submitted before, fail what comes after with
        "server closed", and join the three threads."""
        self._closed.set()
        self._requests.put(None)
        self._stager.join(timeout=30)
        self._dispatcher.join(timeout=30)
        self._inflight.put(None)
        self._fetcher.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ workers

    def _stage_loop(self):
        """Fill each request's own slab as it arrives, in arrival order,
        and hand it to the dispatch thread; a request whose slab cannot be
        filled fails alone."""
        while True:
            item = self._requests.get()
            if item is None:
                break
            fut, request, t, rid = item
            try:
                with tracing.span("serve.stage", rid):
                    slab, key = self._stage(request)
            except Exception as e:  # noqa: BLE001 - delivered via future
                if fut.set_running_or_notify_cancel():
                    self._fail([fut], e)
                continue
            self._tally({"serve.staged": 1})
            self._staged.put(Staged(fut, t, rid, slab, key))
        self._staged.put(None)
        self._fail_left(self._requests)

    def _collect_group(self, leader):
        """The leader plus up to batch - 1 more staged requests of its key
        arriving within the batching window. Returns (group, stop) where
        ``stop`` means the close sentinel was seen."""
        group = [leader]
        deadline = time.perf_counter() + self._batch_window
        while len(group) < self._batch:
            timeout = deadline - time.perf_counter()
            try:
                nxt = (self._staged.get(timeout=timeout) if timeout > 0
                       else self._staged.get_nowait())
            except queue_mod.Empty:
                break
            if nxt is None:
                return group, True
            if nxt.key != leader.key:
                self._carry = nxt   # the next group's leader
                break
            group.append(nxt)
        return group, False

    def _dispatch_loop(self):
        self._carry = None
        stop = False
        while not stop:
            item = self._carry if self._carry is not None \
                else self._staged.get()
            self._carry = None
            if item is None:
                break
            group, stop = (self._collect_group(item) if self._batch > 1
                           else ([item], False))
            live = [s for s in group
                    if s.future.set_running_or_notify_cancel()]
            if not live:
                continue
            gid = next(self._group_ids)
            if tracing.on():
                now = time.perf_counter_ns()
                for s in live:
                    tracing.record("serve.queue", s.submitted_ns, now,
                                   key=s.rid, parent=("serve.pack", gid))
            futures = [s.future for s in live]
            try:
                parts, tally = self._launch(live, gid)
            except Exception as e:  # noqa: BLE001 - delivered via futures
                self._fail(futures, e)
                continue
            self._inflight.put((futures, parts,
                                [s.submitted_ns for s in live], tally))
        if self._carry is not None:
            self._fail([self._carry.future], RuntimeError("server closed"))
        self._fail_left(self._staged)

    def _fail_left(self, q):
        """Fail what is still in ``q`` once closed."""
        closed = RuntimeError("server closed")
        while True:
            try:
                item = q.get_nowait()
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

    def _launch(self, group, gid: int):
        """Copy group ``gid`` of staged requests (one key) into one buffer
        on each distinct device, padded to the batch with zero rows, and
        launch each device's rows as one forward; returns ([(finest flows
        on the device (launched, not waited for), row indices)], the
        group's counts)."""
        rows = max(self._batch, len(group))
        kind = group[0].key[0]
        shape = tuple(group[0].slab.shape)
        parts = []
        for dev, idx in self._rows_by_device(rows):
            filled = sum(i < len(group) for i in idx)   # a prefix of idx
            with tracing.span("serve.pack", gid):
                buf = torch.empty((len(idx),) + shape, dtype=torch.float32,
                                  device=dev)
                buf[filled:].zero_()
            with tracing.span("serve.upload", gid):
                for row, i in enumerate(idx[:filled]):
                    buf[row].copy_(group[i].slab, non_blocking=True)
            voxel_step, events_step = self._steps[dev]
            with tracing.span("serve.issue", gid):
                if kind == "events":
                    flows = events_step(_rows(buf))
                elif kind == "pair":
                    at = 5 * group[0].key[1][0]
                    flows = events_step({"windows": [
                        _rows(buf[:, :at].view(len(idx), 5, -1)),
                        _rows(buf[:, at:].view(len(idx), 5, -1))]})
                else:
                    flows = voxel_step(buf)
            parts.append((flows[-1], idx))   # finest scale
        slots = {"events": shape[-1], "pair": shape[-1] // 5}.get(kind, 0)
        tally = {"serve.requests": len(group), "serve.groups": 1,
                 "serve.rows": rows, "serve.event_slots": rows * slots}
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
