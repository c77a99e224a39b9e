"""The program's own spans and counters (``sdformerflow_tpu_torch/utils/
tracing.py``) on the timeline of a cell's profiler trace.

The program records while a ``torch.profiler`` session is active, so the
profiled slice after the window holds its spans: the server's threads'
(``serve.queue``, ``serve.pack``, ``serve.upload``, ``serve.issue``) and
the train step's (``train.step``, ``train.batch``), and its counters over
the same slice. :func:`read` takes the cell's chrome trace
(``drivers/common.trace_path``): its kernel intervals, its
``pb.traced_window`` (else the kernels' span) and its
``baseTimeNanoseconds``; takes the program's ``tracing.snapshot()``; and
puts the spans on the trace's timeline through the program's one exporter,
``tracing.chrome_events``. Times are in microseconds, as the trace's.

Nothing to read (None) where there is no trace or the program has no
tracer (a checkout before it).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from .drivers import common

Interval = Tuple[float, float]


class Timeline:
    """One traced slice: the kernels' intervals (``kernels``: start, end,
    name), the window, the program's spans by name (start, end, key,
    parent) and its counters."""

    def __init__(self, trace: dict, snap: dict):
        kernels, window = [], None
        for e in trace.get("traceEvents", []):
            if e.get("ph") != "X":
                continue
            a = float(e["ts"])
            b = a + float(e.get("dur", 0.0))
            if e.get("cat") == "kernel":
                kernels.append((a, b, e.get("name", "?")))
            elif e.get("name") == "pb.traced_window":
                window = (a, b)
        if window is None and kernels:
            window = (min(k[0] for k in kernels), max(k[1] for k in kernels))
        self.kernels = kernels
        self.window = window
        self.counters: Dict[str, int] = dict(snap["counters"])
        self.spans: Dict[str, List[tuple]] = {}
        from sdformerflow_tpu_torch.utils import tracing
        for e in tracing.chrome_events(trace["baseTimeNanoseconds"], snap):
            self.spans.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["args"]["key"],
                 e["args"]["parent"]))

    def within(self, name: str) -> List[tuple]:
        """The spans ``name`` that begin inside the window."""
        if self.window is None:
            return []
        lo, hi = self.window
        return [s for s in self.spans.get(name, []) if lo <= s[0] <= hi]

    def idle(self) -> List[Interval]:
        """The window's stretches with no kernel running (the gaps of the
        union of the kernel intervals, as ``harness.read_trace`` takes
        them)."""
        if self.window is None:
            return []
        lo, hi = self.window
        inside = sorted((max(a, lo), min(b, hi)) for a, b, _ in self.kernels
                        if b > lo and a < hi)
        return gaps(inside, lo, hi)


def merged(intervals) -> List[Interval]:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(intervals, lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in merged(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def overlap(xs, ys) -> float:
    """The length of the intersection of two interval unions."""
    xs, ys = merged(xs), merged(ys)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(cell, res) -> Optional[Timeline]:
    """The cell's traced slice with the program's spans on it, built once
    a result (kept in ``res["program_trace"]``); None where there is
    nothing to read."""
    if "program_trace" not in res:
        res["program_trace"] = _build(cell)
    return res["program_trace"]


def _build(cell) -> Optional[Timeline]:
    path = common.trace_path(cell)
    if not os.path.exists(path):
        return None
    try:
        from sdformerflow_tpu_torch.utils import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    with open(path) as f:
        return Timeline(json.load(f), snap)
