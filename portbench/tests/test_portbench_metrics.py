"""The arithmetic of the metrics on inputs made by hand."""

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, run
from portbench.drivers import serve


def test_quantile_is_numpy_linear():
    v = list(np.random.default_rng(0).random(101))
    for q in (0.5, 0.95, 0.99):
        assert harness.quantile(v, q) == pytest.approx(np.quantile(v, q))


def test_window_rate_and_p95_over_every_request():
    # 10 requests due each 0.1 s from t=0, each done 0.05 s after its due
    # time, the last three finishing after the 1 s window closes
    done = [(0.1 * k, 0.1 * k + 0.05) for k in range(10)]
    done += [(0.95, 1.2), (0.96, 1.3), (0.97, 1.4)]
    rate, p95 = serve.summarize(done, 0.0, 1.0)
    assert rate == 10 / 1.0
    lat = [(t - d) * 1e3 for d, t in done]
    assert p95 == pytest.approx(np.quantile(lat, 0.95))
    assert p95 > 300      # the late requests count


def test_union_busy_and_idle_share(tmp_path):
    ev = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 50, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 400, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "pb.traced_window",
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "user_annotation", "name": "pb.submit",
           "ts": 140, "dur": 300}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = harness.read_trace(str(path))
    assert t["busy_s"] == pytest.approx(250e-6)
    assert t["window_s"] == pytest.approx(1000e-6)
    cell = SimpleNamespace()
    idle = run.reader("device_idle_pct.serve")(cell, {"trace": t})
    assert idle == pytest.approx(75.0)
    assert run.reader("device_idle_pct.train")(cell, {"trace": t}) == idle
    assert t["kernels"] == {"a": [2, pytest.approx(200e-6)],
                            "b": [1, pytest.approx(100e-6)]}
    assert t["device_ops"][0] == ["a", pytest.approx(200e-6)]
    # gaps: 500-1000 (no span), 150-400 (inside pb.submit)
    assert t["idle_gaps"][0] == ["no harness span", pytest.approx(500e-6)]
    assert t["idle_gaps"][1] == ["submit", pytest.approx(250e-6)]


def test_no_kernel_no_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": []}))
    assert harness.read_trace(str(path)) is None
    cell = SimpleNamespace()
    assert run.reader("device_idle_pct.train")(cell, {"trace": None}) is None


class _Reckoning:
    """Known counts: 1e12 operations a window; two K2 sites of 1 and 2 GB
    a forward; one K1 site of 0.67 GB and 989 GFLOP a forward."""

    @staticmethod
    def serve_flops_per_window(program):
        return 1e12

    @staticmethod
    def k2_site_bytes(program, rows):
        return (1e9 * rows / 8, 2e9 * rows / 8)

    @staticmethod
    def k1_site_work(program, rows):
        return ((0.67e9 * rows / 8, 989e9 * rows / 8),)


def test_mfu_from_known_counts():
    cell = SimpleNamespace(config={"precision": {"serve": "bf16",
                                                 "train": "fp32_tf32_off"}})
    # 99 windows' operations over 1 s of a busy card at the bf16 peak
    trace = {"busy_s": 1.0, "window_s": 2.0, "windows": 99, "kernels": {}}
    s = run.reader("mfu.serve")(cell, {"trace": trace, "program": {},
                                       "reckoning": _Reckoning})
    assert s == pytest.approx(100.0 * 99e12 / 989e12)
    assert run.reader("mfu.serve")(cell, {"trace": None}) is None
    t = run.reader("mfu.train")(cell, {"train_samples_per_s": 20.0,
                                       "sample_flops": 0.67e12})
    assert t == pytest.approx(20.0)
    assert run.reader("mfu.train")(cell, {}) is None


def test_result_line_correct_and_checks_last():
    cell = SimpleNamespace(trace=False, chips=1, per_layer=[],
                           end_to_end=[{"name": "setup_s", "unit": "s"}])
    res = {"attempted": 3, "failed": 0, "setup_s": 1.5,
           "checks": [("gap", 0.1, 0.2)]}
    line = run.result_line(cell, res, "NVIDIA H100")
    assert line["correct"] and list(line)[-1] == "checks"
    res["checks"] = [("gap", 0.3, 0.2)]
    assert not run.result_line(cell, res, "x")["correct"]
    res.update(checks=[("gap", 0.1, 0.2)], failed=1)
    assert not run.result_line(cell, res, "x")["correct"]
    assert not math.isnan(line["metrics"]["setup_s"]["value"])


def test_rooflines_from_known_counts():
    cell = SimpleNamespace(traffic={"rows": 8})
    res = {"program": {}, "reckoning": _Reckoning, "trace": {
        "busy_s": 1.0, "window_s": 1.0, "kernels": {
            "void psn_fwd_kernel<10>(x)": [4, 3e9 * 2 / 3.35e12 / 0.5],
            "void tc::qk_attn_wgmma_kernel<true>(x)": [2, 2e-3 / 0.25]}}}
    # two forwards' 3 GB of K2 at twice the bytes bound's time: 50%
    assert run.reader("psn_fwd_roofline_pct")(cell, res) == \
        pytest.approx(50.0)
    # two forwards of K1, each bound by its operations (1 ms): 25%
    assert run.reader("qk_attn_roofline_pct")(cell, res) == \
        pytest.approx(25.0)
    res["trace"]["kernels"] = {"other": [1, 1.0]}
    assert run.reader("psn_fwd_roofline_pct")(cell, res) is None
    assert run.reader("qk_attn_roofline_pct")(cell, res) is None

