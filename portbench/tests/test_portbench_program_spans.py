"""The program's spans on the profiler trace's timeline
(``portbench/program_trace.py``) and the per-layer metrics that read them:
on a synthetic chrome trace with known kernels, idle gaps and spans; on a
CPU profile taken around the program's tracer; through traced runs of both
cells at a small size on the CPU; and, on the card (``pytest -m cuda``),
that a program span and the trace's kernels share one clock."""

import json
import os
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import cuda_or_skip, tiny_cell

from portbench import program_trace, run
from portbench.drivers import common
from portbench.harness import PEAK_BYTES_PER_S

BASE = 1_700_000_000_000_000_000        # the trace's baseTimeNanoseconds
PERF0 = 5_000_000_000                   # perf_counter_ns at the base


def _span(name, a_us, b_us, key=None, parent=None):
    from sdformerflow_tpu_torch.utils.tracing import Span
    return Span(name, 7, PERF0 + int(a_us * 1e3), PERF0 + int(b_us * 1e3),
                key, parent)


def _synthetic():
    """A 1000 us window; kernels busy 0-100, 300-400 (K3's four, one grid)
    and 700-800 us, so idle 100-300, 400-700, 800-1000 (700 us); two
    groups packed at 120-220 and 450-500, uploaded and issued at 220-260 and
    500-520 / 520-600; three queue spans; two train steps and their batch
    waits; counters of 2 groups of 8 rows carrying 11 requests in 2^20-slot
    buckets."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "pb.traced_window",
           "ts": 0.0, "dur": 1000.0},
          {"ph": "X", "cat": "kernel", "name": "void gemm<f>(x)",
           "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "void gemm<f>(x)",
           "ts": 700.0, "dur": 100.0}]
    for name, a in (("(anonymous namespace)::bin_kernel<false>(x)", 300),
                    ("(anonymous namespace)::plan_kernel(x)", 320),
                    ("(anonymous namespace)::bin_kernel<true>(x)", 340),
                    ("(anonymous namespace)::tile_kernel(x)", 360)):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": float(a),
                   "dur": 40.0 if a == 360 else 20.0})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 5.0,
               "dur": 1.0})
    trace = {"baseTimeNanoseconds": BASE, "traceEvents": ev}
    spans = [_span("serve.queue", 10, 120, 0, ("serve.pack", 0)),
             _span("serve.queue", 30, 120, 1, ("serve.pack", 0)),
             _span("serve.queue", 430, 450, 2, ("serve.pack", 1)),
             _span("serve.pack", 120, 220, 0),
             _span("serve.upload", 220, 240, 0),
             _span("serve.issue", 240, 260, 0),
             _span("serve.pack", 450, 500, 1),
             _span("serve.upload", 500, 520, 1),
             _span("serve.issue", 520, 600, 1),
             _span("serve.pack", 1200, 1300, 2),      # after the window
             _span("train.batch", 0, 2), _span("train.step", 2, 50),
             _span("train.batch", 50, 54), _span("train.step", 54, 90)]
    snap = {"spans": spans, "dropped": 0,
            "counters": {"serve.requests": 11, "serve.groups": 2,
                         "serve.rows": 16, "serve.event_slots": 1 << 20,
                         "serve.failed": 0},
            "anchor": (BASE + 123_000, PERF0 + 123_000)}
    return trace, snap


def _res(trace, snap):
    return {"program": {"data": {"num_frames": 10},
                        "loader": {"resolution": [480, 640]}},
            "program_trace": program_trace.Timeline(trace, snap)}


def _read(name, res):
    return run.reader(name)(SimpleNamespace(), res)


def test_interval_arithmetic():
    assert program_trace.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3),
                                                              (5, 6)]
    assert program_trace.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4),
                                                          (5, 6)]
    assert program_trace.overlap([(0, 10)], [(2, 3), (5, 7)]) == 3
    assert program_trace.overlap([(0, 2), (4, 6)], [(1, 5)]) == 2


def test_timeline_places_spans_on_the_trace():
    t = program_trace.Timeline(*_synthetic())
    assert t.window == (0.0, 1000.0)
    assert t.idle() == [(100.0, 300.0), (400.0, 700.0), (800.0, 1000.0)]
    pack = t.spans["serve.pack"][0]
    assert pack[:2] == pytest.approx((120.0, 220.0))
    assert pack[2] == 0
    assert len(t.within("serve.pack")) == 2      # the third is outside


def test_serve_readers_on_known_spans():
    res = _res(*_synthetic())
    assert _read("serve_queue_wait_ms", res) == pytest.approx(
        (110 + 90 + 20) / 3 / 1e3)
    assert _read("serve_padded_rows_pct", res) == pytest.approx(
        100 * 5 / 16)
    assert _read("serve_pack_ms", res) == pytest.approx(150 / 2 / 1e3)
    assert _read("serve_issue_ms", res) == pytest.approx(140 / 2 / 1e3)
    # idle 700 us; dispatch 120-260 and 450-600: 140 + 150 of it idle
    assert _read("serve_idle_in_dispatch_pct", res) == pytest.approx(
        100 * 290 / 700)


def test_train_readers_on_known_spans():
    res = _res(*_synthetic())
    assert _read("train_batch_wait_ms", res) == pytest.approx(6 / 2 / 1e3)
    assert _read("train_step_host_ms", res) == pytest.approx(84 / 2 / 1e3)


def test_voxel_roofline_on_known_kernels():
    vox = run.reader("voxel_roofline_pct")
    bytes_ = vox.__globals__["k3_bytes"]
    # PERF.md's K3 bound: 30.1 MB for 2^20 slots and one 10x480x640 grid
    assert bytes_(1 << 20, 1, 10, 480, 640) == 30_113_792
    assert bytes_(1 << 20, 1, 10, 480, 640) / PEAK_BYTES_PER_S == \
        pytest.approx(8.99e-6, rel=1e-3)
    # K3's four kernels ran 100 us
    assert vox(SimpleNamespace(), _res(*_synthetic())) == pytest.approx(
        100 * 30_113_792 / PEAK_BYTES_PER_S / 100e-6)


def test_nothing_to_read():
    trace, snap = _synthetic()
    snap = dict(snap, spans=[], counters={})
    res = _res(trace, snap)
    for name in ("serve_queue_wait_ms", "serve_padded_rows_pct",
                 "serve_pack_ms", "serve_issue_ms",
                 "serve_idle_in_dispatch_pct", "train_batch_wait_ms",
                 "train_step_host_ms", "voxel_roofline_pct"):
        assert _read(name, res) is None, name
        assert _read(name, {"program_trace": None}) is None, name


def test_read_takes_the_programs_snapshot_once(tmp_path, monkeypatch):
    """A CPU profile around the program's spans, written where the cell's
    trace goes: the spans land inside the window; a program without the
    tracer (an older checkout) gives nothing to read."""
    from sdformerflow_tpu_torch.utils import tracing
    cell = SimpleNamespace(workload="_test_program_spans", trace=True)
    path = common.trace_path(cell)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tracing.reset()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("pb.traced_window"):
                for g in range(3):
                    with tracing.span("serve.pack", g):
                        time.sleep(0.002)
                tracing.count("serve.rows", 8)
        prof.export_chrome_trace(path)
        res = {}
        t = program_trace.read(cell, res)
        assert res["program_trace"] is t
        assert [s[2] for s in t.within("serve.pack")] == [0, 1, 2]
        assert t.counters == {"serve.rows": 8}
        lo, hi = t.window
        for a, b, _, _ in t.within("serve.pack"):
            assert lo <= a < b <= hi + 1000     # within 1 ms
            assert b - a >= 2000 * 0.9
        assert _read("serve_pack_ms", res) >= 1.8
        import sdformerflow_tpu_torch.utils as utils
        monkeypatch.delattr(utils, "tracing")
        monkeypatch.setitem(sys.modules, "sdformerflow_tpu_torch.utils."
                            "tracing", None)
        assert program_trace.read(cell, {}) is None
    finally:
        tracing.reset()
        os.remove(path)


@pytest.mark.parametrize("workload,names", [
    ("en4_serve_events_b8", ("serve_queue_wait_ms", "serve_padded_rows_pct",
                             "serve_pack_ms", "serve_issue_ms",
                             "serve_idle_in_dispatch_pct")),
    ("stt_train_b8", ("train_batch_wait_ms", "train_step_host_ms"))])
def test_traced_cells_read_the_program(workload, names, monkeypatch):
    """A traced run of each cell, small and on the CPU, prints every
    program metric of its cell; the padded share in [0, 100), the idle
    share in [0, 100]. The CPU's trace holds no kernel, which the serving
    driver's trace reader is not built for: it is handed an idle card."""
    from portbench.drivers import serve
    from sdformerflow_tpu_torch.utils import tracing
    read_trace = serve.read_trace

    def idle_card(path):
        return read_trace(path) or {"busy_s": 0.0, "window_s": 1.0,
                                    "kernels": {}, "device_ops": [],
                                    "idle_gaps": []}
    monkeypatch.setattr(serve, "read_trace", idle_card)
    tracing.reset()
    cell = tiny_cell(workload, trace=True)
    line = run.result_line(cell, run.execute(cell), "cpu")
    got = line["metrics"]
    for name in names:
        assert got[name]["value"] >= 0, name
    if workload == "en4_serve_events_b8":
        assert 0 <= got["serve_padded_rows_pct"]["value"] < 100
        assert got["serve_idle_in_dispatch_pct"]["value"] <= 100
        assert "voxel_roofline_pct" not in got
    tracing.reset()


@pytest.mark.cuda
def test_a_span_around_synchronize_ends_after_the_kernel(tmp_path):
    """The program's clock and the trace's agree on the card: a span around
    ``torch.cuda.synchronize()`` after a launch ends after that kernel's
    end in the ``torch.profiler`` trace, and begins after its launch."""
    device = cuda_or_skip()
    from sdformerflow_tpu_torch.utils import tracing
    a = torch.randn(4096, 4096, device=device)
    torch.cuda.synchronize(device)
    tracing.reset()
    path = str(tmp_path / "trace.json")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for k in range(3):
            b = a @ a
            with tracing.span("sync", k):
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    del b
    with open(path) as f:
        trace = json.load(f)
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
               if e.get("cat") == "kernel"]
    gemms = sorted(sorted(kernels, key=lambda k: k[0] - k[1])[:3])
    spans = sorted(tracing.chrome_events(trace["baseTimeNanoseconds"]),
                   key=lambda e: e["args"]["key"])
    tracing.reset()
    assert len(gemms) == 3 and len(spans) == 3
    for (ka, kb), s in zip(gemms, spans):
        assert kb - ka > 100                   # a 4096^3 GEMM: ~1 ms
        assert s["ts"] + s["dur"] >= kb
        assert s["ts"] < kb
