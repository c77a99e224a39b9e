"""What every cell shares: the card's identity, the seeded weights, the
harness's own host spans, the reading of a profiler trace, and the check
that no JAX was loaded.

Nothing here imports the program (``sdformerflow_tpu_torch``): the drivers
do, and hand the program's objects in.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "portbench", "_out")

# NVIDIA H100 SXM data sheet, dense rates, and its HBM3 bandwidth
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "tf32": 495e12}
PEAK_BYTES_PER_S = 3.35e12


def kernel_time(trace: dict, part: str):
    """(launches, seconds) of the trace's kernels whose name holds
    ``part``; None if none ran."""
    hits = [v for n, v in trace.get("kernels", {}).items() if part in n]
    if not hits:
        return None
    return sum(c for c, _ in hits), sum(s for _, s in hits)


def card_info() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines \
        else "nvidia-smi unavailable"


def seeded_state(named: Dict[str, torch.Tensor], seed: int, device,
                 ) -> Dict[str, torch.Tensor]:
    """Weights for every floating tensor of a state_dict, from one normal
    draw on ``device`` seeded with ``seed``, split in the names' sorted
    order and scaled by the leaf's role: a matrix or kernel by one over the
    square root of its fan-in, a norm's scale ``1 + 0.1 n``, a running
    variance ``1 + 0.1 |n|``, swin-v2's logit scale ``log 10 + 0.1 n``,
    anything else (biases, means, vectors) ``0.1 n``. float32; the same
    ``seed`` gives the same weights, for the program and the reference
    alike."""
    names = sorted(n for n, t in named.items() if t.is_floating_point())
    sizes = [named[n].numel() for n in names]
    gen = torch.Generator(device).manual_seed(int(seed) % (1 << 63))
    noise = torch.randn(sum(sizes), generator=gen, device=device,
                        dtype=torch.float32)
    out = {}
    for name, part in zip(names, noise.split(sizes)):
        shape = named[name].shape
        t = part.view(shape)
        if len(shape) >= 2 and t[0].numel() > 1:
            t = t / math.sqrt(t[0].numel())
        elif name.endswith("running_var"):
            t = 1.0 + 0.1 * t.abs()
        elif name.endswith("logit_scale"):
            t = math.log(10.0) + 0.1 * t
        elif name.endswith("weight") or name.endswith("scale"):
            t = 1.0 + 0.1 * t
        else:
            t = 0.1 * t
        out[name] = t
    return out


class Spans:
    """The harness's own host spans: each ``with spans("name")`` adds its
    seconds to a total and marks the interval in a profiler trace
    (``record_function("pb.<name>")``)."""

    def __init__(self):
        self.total: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        with torch.profiler.record_function("pb." + name):
            try:
                yield
            finally:
                self.total[name] = self.total.get(name, 0.0) \
                    + time.perf_counter() - t


def quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile (0-1) of every value, linear between order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union_busy(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    return busy + hi - lo


def read_trace(path: str, top: int = 10) -> Optional[dict]:
    """A chrome trace of ``torch.profiler`` -> the device's busy seconds
    (the union of the kernel intervals, as ``chip_smoke.py:
    device_ms_per_call`` takes it), the traced window's seconds, every
    kernel's launches and seconds (``kernels``), the kernels that took most
    time and the longest idle gaps, each named by the innermost harness
    span (``pb.*``) open at its middle. None if the trace holds no
    kernel."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels, notes, window = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat == "kernel":
            kernels.append((a, b, e.get("name", "?")))
        elif cat == "user_annotation" and e.get("name", "").startswith("pb."):
            notes.append((a, b, e["name"][3:]))
            if e["name"] == "pb.traced_window":
                window = [a, b]
    if not kernels:
        return None
    if not window:
        window = [min(k[0] for k in kernels), max(k[1] for k in kernels)]
    lo, hi = window
    inside = [(max(a, lo), min(b, hi), n) for a, b, n in kernels
              if b > lo and a < hi]
    busy = union_busy([(a, b) for a, b, _ in inside])
    by_name: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    for a, b, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
        launches[n] = launches.get(n, 0) + 1
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # idle gaps between the union's intervals
    iv = sorted((a, b) for a, b, _ in inside)
    gaps, cur = [], lo
    for a, b in iv:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (a + b)
        cover = [(nb - na, n) for na, nb, n in notes
                 if na <= mid <= nb and n != "traced_window"]
        named.append([min(cover)[1] if cover else "no harness span",
                      (b - a) / 1e6])
    return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
            "kernels": {n: [launches[n], s / 1e6]
                        for n, s in by_name.items()},
            "device_ops": [[n, s / 1e6] for n, s in ops],
            "idle_gaps": named}


def profiled(trace_path: str):
    """A ``torch.profiler`` context over CPU and CUDA activity that writes
    its chrome trace to ``trace_path`` on exit."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)

    @contextlib.contextmanager
    def ctx():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield prof
        prof.export_chrome_trace(trace_path)
    return ctx()


FORBIDDEN = ("jax", "jaxlib", "flax", "sdformerflow_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (the part before the first dot),
    taken whole, is JAX's, flax's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})
