"""Persistent-process inference serving, a port of
``sdformerflow_tpu/serving.py:FlowServer`` for voxel-chunk requests.

The unit of work is one event window -> one flow map. Throughput comes from
keeping the card busy across requests: PyTorch launches CUDA work
asynchronously, so a dispatch thread encodes, uploads and launches request
k+1 while a fetch thread waits for request k's result on the host and
resolves its future - the only thread that waits on the device.

Raw-event requests (dicts of x/y/t/p) need the on-device voxelizer (K3,
``ops/pallas_voxel.py`` in the JAX package), which is not ported yet: they
raise ``NotImplementedError``. Mesh batching is not ported either: one
request is one batch-1 forward.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from .models.registry import get_model
from .training.config import build_configs
from .training.train_step import make_eval_step


class FlowServer:
    """Inference engine over one model.

    Parameters
    ----------
    config: parsed config dict (``training.config.load_config``).
    state_dict: the model's weights (e.g. ``training.from_jax.from_jax``);
        ``None`` keeps the model's initialization.
    device: where the model runs (``"cuda"`` launches the Hopper kernels).
    bf16: run the bf16 inference path (params and activations bf16, BN
        statistics float32) - the deployment path.
    max_pending: bound on queued and in-flight requests before ``submit``
        blocks.
    """

    def __init__(self, config: dict, state_dict: Optional[dict] = None, *,
                 device="cuda", bf16: bool = True, max_pending: int = 8):
        model_cfg, swin_cfg, spiking_cfg = build_configs(config)
        name = config["model"]["name"]
        model = get_model(name, model_cfg, swin_cfg, spiking_cfg)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.device = torch.device(device)
        model.to(self.device)

        is_snn = "Spiking" in name
        self._step = make_eval_step(
            model, encoding=config["model"].get("encoding", "voxel"),
            polarity=config["loader"].get("polarity", True) and is_snn,
            norm_input=config["model"].get("norm_input"),
            spike_th=config["data"].get("spike_th"),
            compute_dtype=torch.bfloat16 if bf16 else None)
        self.model = self._step.model

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
        [2, H, W] float32. ``request`` is a voxel chunk ([bins, H, W] or
        [bins, 2, H, W] numpy array at crop size)."""
        if isinstance(request, dict):
            raise NotImplementedError(
                "raw-event requests need the on-device voxelizer, which is "
                "not ported yet; send a voxel chunk")
        if self._closed.is_set():
            raise RuntimeError("server closed")
        fut: Future = Future()
        self._requests.put((fut, request, time.perf_counter()))
        return fut

    def infer(self, request):
        """Synchronous single-request helper."""
        return self.submit(request).result()

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
                chunk = torch.as_tensor(np.asarray(request, np.float32))
                flows = self._step(chunk[None].to(self.device))
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
