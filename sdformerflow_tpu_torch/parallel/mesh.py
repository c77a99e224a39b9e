"""Background batch production and host-to-device prefetch, a mirror of
``host_prefetch`` and ``prefetch_to_device`` in
``sdformerflow_tpu/parallel/mesh.py`` on one card.

The mesh, sharding and replication helpers of that module are not ported:
the port trains on one card (ROADMAP section 1 item 9).
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading

import numpy as np
import torch


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
    still read it. On the CPU the tensors are the host arrays' views."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    source = host_prefetch((_tensors(b, cuda) for b in iterator), size=size)
    if not cuda:
        yield from source
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
        for batch in source:
            pending.append(put(batch))
            if len(pending) == size:
                yield take(pending.popleft())
        while pending:
            yield take(pending.popleft())
    finally:
        source.close()
