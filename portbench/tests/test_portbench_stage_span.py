"""``serve_stage_ms`` reads the program's ``serve.stage`` spans: on known
spans, where there is nothing to read (a program that stages nothing off
its dispatch thread), and on a CPU profile of a small ``FlowServer``."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT

from portbench import program_trace, run
from portbench.drivers import common

BASE = 1_700_000_000_000_000_000        # the trace's baseTimeNanoseconds
PERF0 = 5_000_000_000                   # perf_counter_ns at the base


def _snap(spans):
    from sdformerflow_tpu_torch.utils.tracing import Span
    return {"spans": [Span(name, 3, PERF0 + int(a * 1e3),
                           PERF0 + int(b * 1e3), key, None)
                      for name, a, b, key in spans],
            "counters": {}, "dropped": 0,
            "anchor": (BASE + 50_000, PERF0 + 50_000)}


def _res(spans):
    trace = {"baseTimeNanoseconds": BASE, "traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "pb.traced_window",
         "ts": 0.0, "dur": 1000.0}]}
    return {"program_trace": program_trace.Timeline(trace, _snap(spans))}


def test_mean_stage_span_in_the_window():
    res = _res([("serve.stage", 10, 40, 0), ("serve.stage", 50, 60, 1),
                ("serve.pack", 60, 400, 0),
                ("serve.stage", 1200, 1900, 2)])      # after the window
    assert run.reader("serve_stage_ms")(None, res) == pytest.approx(
        (30 + 10) / 2 / 1e3)


def test_nothing_to_read():
    read = run.reader("serve_stage_ms")
    assert read(None, _res([("serve.pack", 10, 40, 0)])) is None
    assert read(None, {"program_trace": None}) is None


def test_a_small_server_under_the_profiler(tmp_path):
    """Two events requests through a CPU ``FlowServer`` inside a profiled
    ``pb.traced_window``: two stage spans, each within the window."""
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.serving import FlowServer
    from sdformerflow_tpu_torch.training.config import (build_configs,
                                                         load_config)
    from sdformerflow_tpu_torch.utils import tracing
    cfg = load_config(os.path.join(ROOT, "configs", "test_tiny_snn.yaml"))
    cfg["loader"]["resolution"] = cfg["loader"]["crop"] = [32, 48]
    model = get_model(cfg["model"]["name"], *build_configs(cfg))
    rng = np.random.default_rng(0)
    reqs = [{"x": rng.uniform(0, 47, n).astype(np.float32),
             "y": rng.uniform(0, 31, n).astype(np.float32),
             "t": np.sort(rng.uniform(0, 0.1, n)).astype(np.float32),
             "p": rng.integers(0, 2, n).astype(np.uint8)}
            for n in (1000, 2000)]
    cell = SimpleNamespace(workload="_test_stage_span", trace=True)
    path = common.trace_path(cell)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tracing.reset()
    try:
        with FlowServer(cfg, model.state_dict(), device="cpu",
                        bf16=False) as server:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as p:
                with torch.profiler.record_function("pb.traced_window"):
                    for f in [server.submit(r) for r in reqs]:
                        f.result(timeout=300)
            p.export_chrome_trace(path)
        res = {}
        t = program_trace.read(cell, res)
        stages = t.within("serve.stage")
        assert len(stages) == 2
        lo, hi = t.window
        for a, b, _, _ in stages:
            assert lo <= a <= b <= hi + 1000
        assert run.reader("serve_stage_ms")(cell, res) > 0
    finally:
        tracing.reset()
        os.remove(path)
