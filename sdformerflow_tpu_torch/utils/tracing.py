"""The program's own spans and counters, on a clock a profiler trace can
hold.

One process-wide :class:`Tracer` (this module's functions are its
methods). It records while it is on: while :func:`enable` is in force, or
while a ``torch.profiler`` session is active (one read of
``torch.autograd.profiler._is_profiler_enabled``, a global visible from
every thread). Off, a span site allocates nothing and reads no clock.

Spans are kept by the program because the profiler records
``record_function`` only on the thread that opened it: the server's
dispatch and fetch threads, started before a profile, would be missing
from it. A span is stamped with ``time.perf_counter_ns()``;
:func:`snapshot` hands out one ``(time.time_ns(), time.perf_counter_ns())``
anchor pair read back to back, and :func:`chrome_events` puts the spans on
a chrome trace's timeline, whose ``ts`` is ``time.time_ns()`` less the
trace's ``baseTimeNanoseconds``, in microseconds::

    with torch.profiler.profile(activities=[CPU, CUDA]) as prof:
        ...                                  # serve or train
    prof.export_chrome_trace(path)
    trace = json.load(open(path))
    trace["traceEvents"] += tracing.chrome_events(
        trace["baseTimeNanoseconds"])
    json.dump(trace, open(path, "w"))        # open it in Perfetto

The spans and counters (their readers: ``portbench/metrics/``, and
``FlowServer.stats()``, which keeps the serving counters at all times):

- ``serve.stage``, one a request, on the server's staging thread
  (``flow-stage``), keyed by the request's id: from taking the request off
  the submit queue to handing it to the dispatch thread; it fills the
  request's own host slab (the raw events' pack, or the voxel chunk's
  copy), so the dispatch thread packs nothing;
- ``serve.queue``, one a request: from its ``submit`` to the start of its
  group's launch, keyed by the request's id, its parent
  ``("serve.pack", group id)``;
- ``serve.pack``, ``serve.upload``, ``serve.issue``, on the dispatch
  thread, keyed by the group's id, once a distinct device of the group:
  what is left of the group's fill (its buffer's allocation on the device
  and the padded rows' zeroing there), the staged slabs' non-blocking
  copies into their rows (one a request), the call that issues the
  forward;
- ``train.step``: a train step's host issue (``make_train_step``);
- ``train.batch``: the trainer's wait for its next host batch
  (``parallel/mesh.py:prefetch_to_device``);
- ``eraft.corr``, once an E-RAFT forward (``models/eraft.py``): the host's
  issue of the correlation volume and its pyramid (read by
  ``portbench/metrics/corr_volume_roofline_pct.py``, which takes the
  kernels launched inside it, and by ``eraft_update_issue_ms`` to count the
  forwards);
- ``eraft.update``, one an E-RAFT iteration, keyed by the iteration: its
  lookup and update block, as issued (``eraft_update_issue_ms``: their sum
  a forward); inside it ``eraft.lookup``, the lookup alone
  (``corr_lookup_roofline_pct`` takes the kernels launched inside it);
- counters ``serve.requests`` (requests launched), ``serve.groups``,
  ``serve.rows`` (rows launched, padding included), ``serve.event_slots``
  (rows times the event bucket, summed over a request's windows: K3's
  slots), ``serve.failed`` and ``serve.staged`` (requests staged off the
  dispatch thread); ``eraft.volumes`` (rows whose correlation volume was
  built, padding included: ``corr_volume_roofline_pct``'s work) and
  ``eraft.lookups`` (rows times iterations: ``corr_lookup_roofline_pct``'s
  work). ``FlowServer.stats()`` keeps the ``serve.*`` counters at all
  times.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Hashable, NamedTuple, Optional

from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16


class Span(NamedTuple):
    name: str
    thread: int            # threading.get_native_id(), the trace's tid
    start_ns: int          # time.perf_counter_ns()
    end_ns: int
    key: Optional[Hashable] = None
    # (name, key) of the enclosing span on the same thread, or one given
    parent: Optional[tuple] = None


class _Off:
    """The span site's context while the tracer is off: one shared
    instance, so that the site allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("tracer", "name", "key", "parent", "start_ns")

    def __init__(self, tracer, name, key, parent):
        self.tracer, self.name, self.key, self.parent = (tracer, name, key,
                                                         parent)

    def __enter__(self):
        stack = self.tracer._stack()
        if self.parent is None and stack:
            self.parent = (stack[-1].name, stack[-1].key)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.tracer._stack().pop()
        self.tracer._add(Span(self.name, threading.get_native_id(),
                              self.start_ns, end, self.key, self.parent))
        return False


class Tracer:
    """Spans and integer counters in a bounded buffer (``capacity`` spans;
    what does not fit is counted in ``dropped``)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = int(capacity)
        self._forced = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def on(self) -> bool:
        return self._forced > 0 or _profiler._is_profiler_enabled

    @contextlib.contextmanager
    def enable(self):
        """Record inside the block, profiler or not (blocks nest)."""
        with self._lock:
            self._forced += 1
        try:
            yield self
        finally:
            with self._lock:
                self._forced -= 1

    def span(self, name: str, key=None, parent=None):
        """A context that records one span ``name`` around its block while
        the tracer is on; ``parent`` defaults to the enclosing span's
        ``(name, key)`` on this thread."""
        if not (self._forced or _profiler._is_profiler_enabled):
            return _OFF
        return _Open(self, name, key, parent)

    def record(self, name: str, start_ns: int, end_ns: int, key=None,
               parent=None):
        """A span timed by the caller (``perf_counter_ns`` stamps), such as
        one that began on another thread; recorded on the caller's
        thread."""
        if self.on():
            self._add(Span(name, threading.get_native_id(), int(start_ns),
                           int(end_ns), key, parent))

    def count(self, name: str, n: int = 1):
        if self.on():
            with self._lock:
                self._counters[name] = self._counters.get(name, 0) + int(n)

    def reset(self):
        with self._lock:
            self._spans, self._counters, self._dropped = [], {}, 0

    def snapshot(self) -> dict:
        """The spans and counters so far, ``dropped``, and an ``anchor``
        pair (``time.time_ns()``, ``time.perf_counter_ns()``) read back to
        back."""
        with self._lock:
            out = {"spans": list(self._spans),
                   "counters": dict(self._counters),
                   "dropped": self._dropped}
        out["anchor"] = (time.time_ns(), time.perf_counter_ns())
        return out

    def chrome_events(self, base_ns: int, snap: Optional[dict] = None
                      ) -> list:
        """The spans of ``snap`` (default: a fresh :meth:`snapshot`) as
        chrome-trace complete events (``"ph": "X"``, category
        ``program``) on the timeline of a trace whose
        ``baseTimeNanoseconds`` is ``base_ns``."""
        snap = self.snapshot() if snap is None else snap
        wall, perf = snap["anchor"]
        shift = wall - perf - int(base_ns)
        pid = os.getpid()
        return [{"ph": "X", "cat": "program", "name": s.name,
                 "ts": (s.start_ns + shift) / 1e3,
                 "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid,
                 "tid": s.thread,
                 "args": {"key": s.key, "parent": s.parent}}
                for s in snap["spans"]]

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, span: Span):
        with self._lock:
            if len(self._spans) < self.capacity:
                self._spans.append(span)
            else:
                self._dropped += 1


TRACER = Tracer()
on = TRACER.on
enable = TRACER.enable
span = TRACER.span
record = TRACER.record
count = TRACER.count
reset = TRACER.reset
snapshot = TRACER.snapshot
chrome_events = TRACER.chrome_events
