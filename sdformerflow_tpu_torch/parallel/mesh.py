"""Devices of a data axis and background batch production, a mirror of
``sdformerflow_tpu/parallel/mesh.py``.

JAX's mesh is a grid of devices with a ``data`` axis; a batch is sharded
along it and the parameters are replicated, and one SPMD program runs over
all of them. In the port a data axis is a list of devices
(:func:`make_mesh`): :func:`shard_batch` splits a batch's rows over it in
order and :func:`replicate` gives one copy of a module per distinct device.
A list may name one device more than once (the test rig, as JAX's tests
run on ``--xla_force_host_platform_device_count`` virtual CPU devices):
such entries share one replica, and their rows run as one batch there.
Training over several cards runs one process per card instead
(``parallel/multihost.py``); ``serving.FlowServer(devices=...)`` takes a
list. :func:`make_grid` returns JAX's 2-D grid, ``n_data`` rows of
``n_model`` devices; training over it runs one process a device,
whose groups ``parallel/multihost.py:make_multihost_mesh`` makes, and
``parallel/sharding_rules.py`` shards the model over the ``model`` axis.

``host_prefetch`` and ``prefetch_to_device`` feed the trainer's batches to
its card.
"""

from __future__ import annotations

import collections
import copy
import queue as queue_mod
import threading

import numpy as np
import torch

from ..utils import tracing


def make_mesh(n_data=None, devices=None) -> list:
    """The devices of a data axis: the first ``n_data`` of ``devices``
    (default: every visible card, else the CPU), as ``torch.device``s."""
    devices = _devices(devices)
    n_data = len(devices) if n_data is None else int(n_data)
    if not 1 <= n_data <= len(devices):
        raise ValueError(f"n_data={n_data} of {len(devices)} device(s)")
    return devices[:n_data]


def make_grid(n_data=None, n_model=1, devices=None) -> list:
    """The (data, model) grid of ``devices`` (as :func:`make_mesh`), laid
    out as JAX's ``devs.reshape(n_data, n_model)``: ``n_data`` lists of
    ``n_model`` devices, row d holding devices ``d * n_model`` to
    ``(d + 1) * n_model - 1`` (``n_data`` defaults to as many rows as the
    devices fill)."""
    devices = _devices(devices)
    n_model = int(n_model)
    if n_model < 1:
        raise ValueError(f"n_model={n_model}")
    n_data = len(devices) // n_model if n_data is None else int(n_data)
    if not 1 <= n_data * n_model <= len(devices):
        raise ValueError(f"n_data={n_data} x n_model={n_model} of "
                         f"{len(devices)} device(s)")
    return [devices[d * n_model:(d + 1) * n_model] for d in range(n_data)]


def _devices(devices) -> list:
    """``devices`` (default: every visible card, else the CPU) as indexed
    ``torch.device``s."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())] or ["cpu"]
    return [_indexed(torch.device(d)) for d in devices]


def _indexed(device: torch.device) -> torch.device:
    """A bare ``cuda`` as the current card's index, so that one card has
    one name."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def distinct(devices) -> list:
    """The devices of a data axis once each, in order of first mention."""
    return list(dict.fromkeys(torch.device(d) for d in devices))


def shard_batch(batch, devices) -> list:
    """A batch (a tensor or nested dicts of ``[B, ...]`` tensors) -> one
    batch per entry of ``devices``, the rows split in order (entry i takes
    rows ``i*B/n`` to ``(i+1)*B/n``) and moved to that device; ``B`` must
    be divisible by ``len(devices)``, as JAX's sharding requires."""
    devices = [torch.device(d) for d in devices]
    first = batch
    while isinstance(first, dict):
        first = next(iter(first.values()))
    b, n = first.shape[0], len(devices)
    if b % n:
        raise ValueError(f"batch {b} is not divisible by the {n} devices "
                         "of the data axis")
    per = b // n
    return [_map(lambda t, i=i, d=d: t[i * per:(i + 1) * per].to(d), batch)
            for i, d in enumerate(devices)]


def replicate(module: torch.nn.Module, devices) -> dict:
    """One copy of ``module`` per distinct device of ``devices``:
    ``{device: module}``. The module itself serves the device it is on; the
    other devices get deep copies."""
    home = next(module.parameters()).device
    return {d: module if d == home else copy.deepcopy(module).to(d)
            for d in distinct(devices)}


def host_prefetch(iterator, size: int = 2):
    """Run the host-side batch producer (dataset reads, event packing,
    collation, a dataset's own augmentation) in a background thread with a
    bounded queue, so that it overlaps the device's work; the order of the
    items is the iterator's. A producer exception re-raises in the
    consumer; closing the generator (an early ``break``, then ``close()``
    or garbage collection) stops the thread through a stop flag."""
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=size)
    stop = threading.Event()
    end = object()
    errs = []

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue_mod.Full:
                continue

    def worker():
        try:
            for item in iterator:
                put(item)
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            errs.append(e)
        finally:
            put(end)

    thread = threading.Thread(target=worker, daemon=True,
                              name="host-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if errs:
                    raise errs[0]
                return
            yield item
    finally:
        stop.set()


def _tensors(batch, pin: bool):
    """A batch of numpy arrays (nested dicts) as torch tensors, in pinned
    memory if ``pin``."""
    if isinstance(batch, dict):
        return {k: _tensors(v, pin) for k, v in batch.items()}
    t = torch.from_numpy(np.ascontiguousarray(batch))
    return t.pin_memory() if pin else t


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _waited(source):
    """``source``'s items, each wait for one in a ``train.batch`` span."""
    end = object()
    while True:
        with tracing.span("train.batch"):
            item = next(source, end)
        if item is end:
            return
        yield item


def prefetch_to_device(iterator, device, size: int = 2):
    """Batches of numpy arrays (nested dicts) -> the same batches as tensors
    on ``device``, keeping ``size`` batches in flight so that the copy of
    batch k+1 overlaps the compute of batch k. The producer, and the
    conversion into pinned host memory, run in a background thread
    (:func:`host_prefetch`; JAX's ``host_threads=True``, the only value its
    loop uses).

    On a CUDA device each batch is copied by non-blocking copies on a side
    stream; before a batch is handed out the consumer's current stream
    waits for that stream (``wait_stream``) and each of its tensors is
    marked as used there (``record_stream``), so the caching allocator does
    not give its memory to another tensor while the compute stream may
    still read it. On the CPU the tensors are the host arrays' views.

    Each wait for the next host batch is a ``train.batch`` span
    (``utils/tracing.py``)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    source = host_prefetch((_tensors(b, cuda) for b in iterator), size=size)
    if not cuda:
        try:
            yield from _waited(source)
        finally:
            source.close()
        return
    side = torch.cuda.Stream(device)
    pending = collections.deque()

    def put(batch):
        with torch.cuda.stream(side):
            return _map(lambda t: t.to(device, non_blocking=True), batch)

    def take(batch):
        compute = torch.cuda.current_stream(device)
        compute.wait_stream(side)
        return _map(lambda t: (t.record_stream(compute), t)[1], batch)

    try:
        for batch in _waited(source):
            pending.append(put(batch))
            if len(pending) == size:
                yield take(pending.popleft())
        while pending:
            yield take(pending.popleft())
    finally:
        source.close()
