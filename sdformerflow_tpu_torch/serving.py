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

Not ported: mesh batching (one request is one batch-1 forward) and the
fused-attention option (the port's eval attention always runs K1). The
HTTP front is ``serve.py`` (``python -m sdformerflow_tpu_torch.serve``).
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from . import native
from .training.config import chunk_bins
from .training.export import build_inference_state, step_kwargs
from .training.train_step import make_eval_step


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
                 model: Optional[torch.nn.Module] = None):
        self.device = torch.device(device)
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
        self._step = make_eval_step(
            model, **step_kwargs(config, bf16=bf16, events=False))
        self.model = self._step.model
        # the events step runs the same cast model: voxelize at sensor
        # resolution, center crop, forward
        self._events_step = make_eval_step(
            self.model, **step_kwargs(config, bf16=bf16, events=True))

        self._requests: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=max_pending)
        self._inflight: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=max_pending)
        self._closed = threading.Event()
        self._lock = threading.Lock()
        self._served = 0
        self._latencies: list = []
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="flow-dispatch")
        self._fetcher = threading.Thread(
            target=self._fetch_loop, daemon=True, name="flow-fetch")
        self._dispatcher.start()
        self._fetcher.start()

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
        self._requests.put((fut, request, time.perf_counter()))
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
        n = len(request["x"])
        bucket = next_bucket(n)
        buf = torch.empty((1, 5, bucket), dtype=torch.float32,
                          pin_memory=self.device.type == "cuda")
        native.pack_window(request["x"], request["y"], request["t"],
                           request["p"], bucket, t0=0.0, out=buf[0].numpy())
        return buf

    def stats(self) -> dict:
        with self._lock:
            lat = list(self._latencies)
            served = self._served
        out = {"served": served, "pending": self._requests.qsize()
               + self._inflight.qsize()}
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

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ workers

    def _dispatch_loop(self):
        while True:
            item = self._requests.get()
            if item is None:
                break
            fut, request, t0 = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                flows = self._launch(request)
            except Exception as e:  # noqa: BLE001 - delivered via future
                fut.set_exception(e)
                continue
            self._inflight.put((fut, flows[-1][0], t0))  # finest scale
        # fail what is still queued once closed
        while True:
            try:
                item = self._requests.get_nowait()
            except queue_mod.Empty:
                break
            if item is not None:
                item[0].set_exception(RuntimeError("server closed"))

    def _launch(self, request):
        """Upload one request and launch its forward; returns the flows on
        the device (launched, not waited for)."""
        if isinstance(request, dict):
            if self._input_bins != self._num_bins:
                raise ValueError(
                    f"events are voxelized into data.num_frames = "
                    f"{self._num_bins} bins but the model takes "
                    f"{self._input_bins}-bin chunks (data.num_chunks = "
                    f"{self._input_bins // self._num_bins}): send voxel "
                    "chunks")
            dev = self.pack_events(request).to(self.device, non_blocking=True)
            return self._events_step({
                "x": dev[:, 0], "y": dev[:, 1], "t": dev[:, 2],
                "p": dev[:, 3], "valid": dev[:, 4] != 0})
        chunk = torch.as_tensor(np.asarray(request, np.float32))
        return self._step(chunk[None].to(self.device))

    def _fetch_loop(self):
        while True:
            item = self._inflight.get()
            if item is None:
                break
            fut, flow, t0 = item
            try:
                result = flow.cpu().numpy()  # waits for the device
            except Exception as e:  # noqa: BLE001 - delivered via future
                fut.set_exception(e)
                continue
            fut.set_result(result)
            now = time.perf_counter()
            with self._lock:
                self._served += 1
                self._latencies.append(now - t0)
                if len(self._latencies) > 1024:
                    del self._latencies[:512]
