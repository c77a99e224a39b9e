"""Which kernels of a cell's profiler trace a program span launched.

A kernel on the card runs after the host call that launched it, so its own
interval says nothing of the span it belongs to. The trace pairs each
kernel (category ``kernel``) with its launching host call (``cuda_runtime``
or ``cuda_driver``: ``cudaLaunchKernel``, ``cuLaunchKernel``, ...) by the
``correlation`` id both carry; a kernel belongs to a program span
(``program_trace.Timeline.within``) when its launch call began inside it.
Times are in microseconds, as the trace's.

Nothing to read (None) where there is no trace.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from .drivers import common

HOST = ("cuda_runtime", "cuda_driver")


class Launches:
    """The trace's kernels, each ``(start, end, name, launched)`` with the
    host time of its launch call (None where the trace has none)."""

    def __init__(self, trace: dict):
        host, kernels = {}, []
        for e in trace.get("traceEvents", []):
            corr = (e.get("args") or {}).get("correlation")
            if e.get("ph") != "X" or corr is None:
                continue
            a = float(e["ts"])
            if e.get("cat") == "kernel":
                kernels.append((a, a + float(e.get("dur", 0.0)),
                                e.get("name", "?"), corr))
            elif e.get("cat") in HOST:
                host[corr] = a
        self.kernels = [(a, b, n, host.get(c)) for a, b, n, c in kernels]

    def inside(self, spans) -> List[Tuple[float, float, str]]:
        """The kernels launched inside any of ``spans`` ((start, end, ...)
        tuples)."""
        iv = sorted((s[0], s[1]) for s in spans)
        return [(a, b, n) for a, b, n, t in self.kernels
                if t is not None and any(lo <= t <= hi for lo, hi in iv)]


def read(cell, res) -> Optional[Launches]:
    """The cell's traced slice's launches, built once a result (kept in
    ``res["launches"]``); None where there is no trace."""
    if "launches" not in res:
        path = common.trace_path(cell)
        res["launches"] = None
        if os.path.exists(path):
            with open(path) as f:
                res["launches"] = Launches(json.load(f))
    return res["launches"]
