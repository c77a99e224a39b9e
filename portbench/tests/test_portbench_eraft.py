"""The ``eraft_serve_events_b8`` cell's pieces: found by name, its
reckoning against ``torch.utils.flop_counter``, its three readers'
arithmetic on hand-made traces, a sound run at a small size on the CPU and
one fault for each of its numbers, and, on the card (``pytest -m cuda``),
its lower-precision controls at the cell's size."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT, cuda_or_skip, tiny_cell
from test_portbench_faults import _correct, _fails_on, _wrap_submit

from portbench import launches, program_trace, run
from portbench.configs import eraft_dsec
from portbench.drivers import common, serve_pair
from portbench.harness import PEAK_BYTES_PER_S, PEAK_FLOPS
from portbench.reference import build as ref_build

CELL = "eraft_serve_events_b8"
NEW = ("corr_volume_roofline_pct", "corr_lookup_roofline_pct",
       "eraft_update_issue_ms")


def _program(h=480, w=640, iters=12):
    program = json.load(open(f"{ROOT}/portbench/configs/eraft_dsec.json"))[
        "program"]
    program["loader"]["resolution"] = [h, w]
    program["model"]["iters"] = iters
    return program


def test_found_by_name():
    bench = json.load(open(f"{ROOT}/BENCHMARK.json"))
    cell = run.load_cell(CELL, 1, 1.0, True, root=ROOT)
    assert cell.config_name == "eraft_dsec" and cell.config["reduced"] == []
    assert cell.traffic_name == "cams_events_pair_b8"
    assert cell.traffic["driver"] == "serve_pair"
    assert type(ref_build.build(_program(128, 160))).__module__ == \
        "portbench.reference.models.ERAFT"
    names = [m["name"] for m in cell.per_layer]
    for name in NEW + ("mfu.serve", "device_idle_pct.serve",
                       "voxel_roofline_pct", "serve_stage_ms",
                       "serve_issue_ms"):
        assert name in names and callable(run.reader(name))
    assert [m["name"] for m in cell.end_to_end] == ["serve_latency_p95_ms",
                                                    "setup_s"]
    others = {w["name"] for w in bench["workloads"]} - {CELL}
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]
        else:
            assert set(m["workloads"]) - {CELL} <= others


@pytest.mark.parametrize("h,w", [(128, 160), (136, 170)])
def test_reckoning_is_the_counted_forward(h, w):
    """At a size of 32s and at one the forward pads."""
    program = _program(h, w, iters=3)
    model = ref_build.build(program)
    with FlopCounterMode(display=False) as c, torch.no_grad():
        model(torch.randn(1, 30, h, w))
    assert c.get_total_flops() == eraft_dsec.serve_flops_per_window(program)


def test_reckoning_at_full_size():
    program = _program()
    assert eraft_dsec.serve_flops_per_window(program) == \
        pytest.approx(0.5136e12, rel=1e-3)
    flops, nbytes = eraft_dsec.volume_work(program)
    assert flops == 2 * 4800 ** 2 * 256
    assert nbytes == 4 * (2 * 4800 * 256 + 4800 * (4800 + 1200 + 300 + 70))
    assert eraft_dsec.lookup_bytes(program) == 4800 * 4 * 4 * (100 + 81)


BASE = 1_700_000_000_000_000_000
PERF0 = 5_000_000_000


def _span(name, a_us, b_us, key=None):
    from sdformerflow_tpu_torch.utils.tracing import Span
    return Span(name, 7, PERF0 + int(a_us * 1e3), PERF0 + int(b_us * 1e3),
                key, None)


def _synthetic(spans=True):
    """A 1000 us window. One forward of 2 rows: its volume issued at
    100-150 us (two launches, kernels 300-400 and 400-450 us), its two
    iterations' updates at 150-250 and 250-370 us, their lookups at
    160-170 and 260-280 (kernels 500-520, 600-640). A kernel launched
    outside every span (at 50 us, run 700-800) counts for neither."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "pb.traced_window",
           "ts": 0.0, "dur": 1000.0}]
    for corr, (launch, a, b) in enumerate(((110, 300, 400), (140, 400, 450),
                                           (165, 500, 520), (265, 600, 640),
                                           (50, 700, 800))):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name":
                   "cudaLaunchKernel", "ts": float(launch), "dur": 2.0,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}",
                   "ts": float(a), "dur": float(b - a),
                   "args": {"correlation": corr}})
    trace = {"baseTimeNanoseconds": BASE, "traceEvents": ev}
    snap = {"spans": [], "counters": {}, "dropped": 0,
            "anchor": (BASE + 123_000, PERF0 + 123_000)}
    if spans:
        snap["spans"] = [_span("eraft.corr", 100, 150),
                         _span("eraft.update", 150, 250, 0),
                         _span("eraft.lookup", 160, 170, 0),
                         _span("eraft.update", 250, 370, 1),
                         _span("eraft.lookup", 260, 280, 1)]
        snap["counters"] = {"eraft.volumes": 2, "eraft.lookups": 4}
    return trace, snap


def _res(trace, snap):
    return {"program": _program(), "reckoning": eraft_dsec,
            "program_trace": program_trace.Timeline(trace, snap),
            "launches": launches.Launches(trace)}


def _read(name, res):
    return run.reader(name)(SimpleNamespace(), res)


def test_readers_on_known_spans():
    res = _res(*_synthetic())
    flops, nbytes = eraft_dsec.volume_work(res["program"])
    bound = 2 * max(flops / PEAK_FLOPS["fp32"], nbytes / PEAK_BYTES_PER_S)
    assert _read("corr_volume_roofline_pct", res) == pytest.approx(
        100 * bound / 150e-6)
    bound = 4 * eraft_dsec.lookup_bytes(res["program"]) / PEAK_BYTES_PER_S
    assert _read("corr_lookup_roofline_pct", res) == pytest.approx(
        100 * bound / 60e-6)
    assert _read("eraft_update_issue_ms", res) == pytest.approx(0.22)


def test_nothing_to_read_without_the_spans():
    res = _res(*_synthetic(spans=False))
    for name in NEW:
        assert _read(name, res) is None, name
        assert _read(name, {"program_trace": None, "launches": None}) is None


def test_launches_pair_kernels_with_their_calls():
    found = launches.Launches(_synthetic()[0])
    assert found.inside([(100.0, 150.0)]) == [(300.0, 400.0, "k0"),
                                              (400.0, 450.0, "k1")]
    assert found.inside([]) == []


def eraft_cell(seed=2 ** 33 + 7, trace=False):
    """The cell at the CPU's size: 128x160 frames (the smallest whose 1/8
    pyramid keeps two rows and columns at its fourth level), 4 iterations,
    2 rows, a pool of 4."""
    cell = tiny_cell(CELL, seed=seed, trace=trace)
    p = cell.config["program"]
    p["loader"].update(crop=None, resolution=[128, 160])
    p["model"]["iters"] = 4
    cell.traffic["scene"].update(resolution=[128, 160])
    return cell


def test_sound_run_is_correct():
    line = _correct(eraft_cell())
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def test_answer_rolled_in_the_hand_back(monkeypatch):
    _wrap_submit(monkeypatch, lambda out, flow, k: out.set_result(
        np.roll(flow, 1, axis=-1) if k > 8 else flow))
    assert _fails_on(_correct(eraft_cell()), "flow_gap_ratio")


def test_one_iteration_fewer(monkeypatch):
    from sdformerflow_tpu_torch.models import eraft
    init = eraft.ERAFT.__init__

    def fewer(self, num_bins=15, iters=12):
        init(self, num_bins, iters - 1)
    monkeypatch.setattr(eraft.ERAFT, "__init__", fewer)
    assert _fails_on(_correct(eraft_cell()), "flow_gap_ratio")


def test_context_from_the_older_window(monkeypatch):
    from sdformerflow_tpu_torch.models import eraft
    forward = eraft.ERAFT.forward

    def older(self, x):
        cnet = self.cnet.forward
        self.cnet.forward = lambda new: cnet(x[:, :self.num_bins])
        try:
            return forward(self, x)
        finally:
            del self.cnet.forward
    monkeypatch.setattr(eraft.ERAFT, "forward", older)
    assert _fails_on(_correct(eraft_cell()), "flow_gap_ratio")


def test_windows_normalized_jointly(monkeypatch):
    from sdformerflow_tpu_torch.ops import normalization
    monkeypatch.setattr(normalization, "_per_window",
                        lambda norm, chunk, windows, group, per_row:
                        norm(chunk, group=group, per_row=per_row))
    assert _fails_on(_correct(eraft_cell()), "input_gap")


@pytest.mark.parametrize("where", ["corr_pyramid", "lookup"])
def test_correlation_kept_in_bfloat16(monkeypatch, where):
    """The volume's levels, or the lookup's samples, rounded to bfloat16
    where the configuration states float32."""
    from sdformerflow_tpu_torch.models import eraft
    fn = getattr(eraft, where)

    def rounded(*args, **kw):
        out = fn(*args, **kw)
        if isinstance(out, list):
            return [p.to(torch.bfloat16).float() for p in out]
        return out.to(torch.bfloat16).float()
    monkeypatch.setattr(eraft, where, rounded)
    assert _fails_on(_correct(eraft_cell()), "corr_gap")


def test_traced_run_reads_the_program(monkeypatch):
    """On the CPU the trace holds no kernel: the rooflines have nothing to
    read, the update spans do."""
    from sdformerflow_tpu_torch.utils import tracing
    read_trace = serve_pair.read_trace
    monkeypatch.setattr(serve_pair, "read_trace", lambda path: read_trace(
        path) or {"busy_s": 0.0, "window_s": 1.0, "kernels": {},
                  "device_ops": [], "idle_gaps": []})
    tracing.reset()
    try:
        line = _correct(eraft_cell(trace=True))
    finally:
        tracing.reset()
    got = line["metrics"]
    assert got["eraft_update_issue_ms"]["value"] > 0
    assert got["serve_stage_ms"]["value"] > 0
    assert "corr_volume_roofline_pct" not in got


@pytest.mark.cuda
def test_control_fails_at_cell_size():
    device = cuda_or_skip()
    for seed in (3700000001, 3700000002, 3700000003):
        cell = run.load_cell(CELL, seed, 3.0, False, root=ROOT,
                             t0=time.perf_counter())
        ctl = serve_pair.control(cell, common.program_config(cell), device)
        print(CELL, seed, ctl)
        lim = cell.limits
        assert any(v > lim[k] for k, v in ctl["fp8"].items() if k in lim)
        assert ctl["fp8"]["flow_gap_ratio"] > 2 * lim["flow_gap_ratio"]
        assert ctl["bf16_corr"]["corr_gap"] > 10 * lim["corr_gap"]
        assert ctl["bf16_reference"]["corr_gap"] < lim["corr_gap"]
