"""The port's tracer (``utils/tracing.py``) and its spans and counters in
``FlowServer`` and the train step, on the CPU at a tiny geometry.

Off, nothing is recorded and a span site hands back one shared context.
On (``enable()``, or a ``torch.profiler`` session, whose flag every thread
sees), spans nest, the buffer keeps its bound and counts what it drops,
and ``chrome_events`` puts a span on the profiler trace's timeline within
1 ms of a ``record_function`` around the same block. ``FlowServer`` counts
requests, groups, rows (padding included), event slots and failures at
all times (``stats()``) and into the tracer while it is on; each request's
``serve.stage`` span, on the staging thread, lies inside its
``serve.queue`` span, which ends before its group's ``serve.pack`` begins. A
train step fed by ``prefetch_to_device`` records one ``train.step`` and
one ``train.batch`` a step.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sdformerflow_tpu_torch.models.registry import get_model
from sdformerflow_tpu_torch.parallel.mesh import prefetch_to_device
from sdformerflow_tpu_torch.serving import COUNTERS, FlowServer
from sdformerflow_tpu_torch.training import optim
from sdformerflow_tpu_torch.training.config import build_configs, load_config
from sdformerflow_tpu_torch.training.train_step import make_train_step
from sdformerflow_tpu_torch.utils import tracing

from torch_port_harness import one_torch_thread  # noqa: F401

TINY = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                    "test_tiny_snn.yaml")
H, W = 32, 48
ROWS = 4


def _config():
    cfg = load_config(TINY)
    cfg["loader"]["resolution"] = [H, W]
    cfg["loader"]["crop"] = [H, W]
    return cfg


def _names(snap, name):
    return [s for s in snap["spans"] if s.name == name]


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()


def test_off_records_nothing_and_allocates_no_context():
    assert not tracing.on()
    assert tracing.span("a") is tracing.span("b", key=3)
    with tracing.span("a", key=1):
        tracing.count("c", 5)
        tracing.record("r", 0, 10)
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}
    assert snap["dropped"] == 0


def test_enabled_spans_nest_and_the_bound_holds():
    tr = tracing.Tracer(capacity=5)
    with tr.enable():
        assert tr.on()
        with tr.span("outer", key="g1"):
            with tr.span("inner"):
                with tr.span("leaf", parent=("elsewhere", 7)):
                    pass
            tr.count("n", 2)
            tr.count("n")
        tr.record("late", 5, 9, key=3, parent=("outer", "g1"))
        for _ in range(4):
            with tr.span("more"):
                pass
    assert not tr.on()
    snap = tr.snapshot()
    by = {s.name: s for s in snap["spans"]}
    assert [s.name for s in snap["spans"]] == ["leaf", "inner", "outer",
                                              "late", "more"]
    assert by["outer"].parent is None and by["outer"].key == "g1"
    assert by["inner"].parent == ("outer", "g1")
    assert by["leaf"].parent == ("elsewhere", 7)
    assert by["late"][2:] == (5, 9, 3, ("outer", "g1"))
    assert by["outer"].start_ns <= by["inner"].start_ns \
        <= by["leaf"].start_ns <= by["leaf"].end_ns <= by["inner"].end_ns \
        <= by["outer"].end_ns
    assert by["outer"].thread == threading.get_native_id()
    assert snap["counters"] == {"n": 3}
    assert snap["dropped"] == 3          # 8 spans into 5 places


def test_a_profiler_session_turns_it_on_for_every_thread():
    """A worker started before the profile records while it runs, and not
    after; the counters of concurrent threads lose no add."""
    go = threading.Event()

    def worker():
        go.wait(30)
        for _ in range(200):
            with tracing.span("worker"):
                tracing.count("adds")

    threads = [threading.Thread(target=worker) for _ in range(12)]
    for t in threads:
        t.start()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            assert tracing.on()
            go.set()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not tracing.on()
    with tracing.span("after"):
        pass
    snap = tracing.snapshot()
    assert snap["counters"] == {"adds": 12 * 200}
    assert len(_names(snap, "worker")) == 12 * 200
    assert not _names(snap, "after")
    assert len({s.thread for s in snap["spans"]}) == 12


def test_chrome_events_lie_on_the_profiler_timeline(tmp_path):
    path = tmp_path / "trace.json"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with tracing.span("probe", key=i):
                with torch.profiler.record_function(f"probe{i}"):
                    torch.ones(1000).sum()
                    time.sleep(0.003)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    theirs = {e["name"]: e for e in trace["traceEvents"]
              if e.get("name", "").startswith("probe")}
    ours = tracing.chrome_events(trace["baseTimeNanoseconds"])
    assert [e["args"]["key"] for e in ours] == [0, 1, 2]
    json.dumps(ours)                     # JSON as it stands
    for e in ours:
        t = theirs[f"probe{e['args']['key']}"]
        assert e["ph"] == "X" and e["name"] == "probe"
        assert abs(e["ts"] - t["ts"]) < 1000
        assert abs((e["ts"] + e["dur"]) - (t["ts"] + t["dur"])) < 1000


@pytest.fixture(scope="module")
def server():
    cfg = _config()
    model = get_model(cfg["model"]["name"], *build_configs(cfg))
    with FlowServer(cfg, model.state_dict(), device="cpu", bf16=False,
                    devices=["cpu"] * ROWS, batch_window_s=0.5,
                    max_pending=16) as srv:
        yield srv


def _events(n, seed):
    r = np.random.default_rng(seed)
    return {"x": r.uniform(0, W - 1, n).astype(np.float32),
            "y": r.uniform(0, H - 1, n).astype(np.float32),
            "t": np.sort(r.uniform(0, 1, n)).astype(np.float32),
            "p": r.integers(0, 2, n).astype(np.float32)}


def test_server_counts_rows_groups_slots_and_failures(server):
    """6 voxel requests, then 4 event windows of 5000 events (one group in
    the 8192 bucket), then one malformed request: 10 requests staged and
    launched, every group padded to 4 rows, 4 x 8192 slots, 1 failure; the
    same counts in ``stats()`` and the tracer; one stage span a request on
    the staging thread, the malformed one's too, which goes no further;
    each launched request's stage span lies inside its queue span, which
    ends before its group's pack begins."""
    before = server.stats()
    rng = np.random.default_rng(0)
    voxels = [rng.normal(size=(10, H, W)).astype(np.float32)
              for _ in range(6)]
    with tracing.enable():
        for f in [server.submit(v) for v in voxels]:
            assert f.result(timeout=300).shape == (2, H, W)
        for f in [server.submit(_events(5000, s)) for s in range(4)]:
            assert f.result(timeout=300).shape == (2, H, W)
        sent_bad = time.perf_counter_ns()
        bad = server.submit({"x": np.zeros(3, np.float32)})
        with pytest.raises(KeyError):
            bad.result(timeout=300)
    stats = server.stats()
    got = {k: stats[k] - before[k] for k in COUNTERS}
    snap = tracing.snapshot()
    assert got == snap["counters"]
    assert got["serve.requests"] == 10 and got["serve.failed"] == 1
    assert got["serve.staged"] == 10
    assert got["serve.rows"] == ROWS * got["serve.groups"]
    assert got["serve.event_slots"] == ROWS * 8192
    queue = {s.key: s for s in _names(snap, "serve.queue")}
    stages = {s.key: s for s in _names(snap, "serve.stage")}
    packs = {s.key: s for s in _names(snap, "serve.pack")}
    assert len(queue) == len(_names(snap, "serve.queue")) == 10
    assert len(stages) == len(_names(snap, "serve.stage")) == 11
    assert len(packs) == got["serve.groups"]
    (bad_id,) = set(stages) - set(queue)     # staged, never launched
    assert bad_id == max(stages)
    assert sent_bad <= stages[bad_id].start_ns <= stages[bad_id].end_ns
    stager = {s.thread for s in stages.values()}
    assert len(stager) == 1 and not stager & {s.thread for s in
                                              packs.values()}
    for rid, q in queue.items():
        name, gid = q.parent
        assert name == "serve.pack"
        st = stages[rid]
        assert q.start_ns <= st.start_ns <= st.end_ns <= q.end_ns
        assert q.end_ns <= packs[gid].start_ns
    for name in ("serve.upload", "serve.issue"):
        keys = [s.key for s in _names(snap, name)]
        assert sorted(keys) == sorted(packs)    # launched groups only


def test_server_counts_with_the_tracer_off(server):
    before = server.stats()
    assert server.infer(np.zeros((10, H, W), np.float32)).shape == (2, H, W)
    after = server.stats()
    assert after["serve.requests"] - before["serve.requests"] == 1
    assert after["serve.rows"] - before["serve.rows"] == ROWS
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}


def test_a_train_step_records_one_step_and_one_batch_wait():
    cfg = _config()
    torch.manual_seed(0)
    model = get_model(cfg["model"]["name"], *build_configs(cfg), train=True)
    opt = optim.build_optimizer(model.named_parameters(), lr=1e-4,
                                steps_per_epoch=1)
    step = make_train_step(model, opt)
    rng = np.random.default_rng(1)
    batches = [{"chunk": rng.normal(size=(2, 10, H, W)).astype(np.float32),
                "label": rng.normal(size=(2, 2, H, W)).astype(np.float32),
                "mask": np.ones((2, 1, H, W), np.float32)}
               for _ in range(4)]
    it = prefetch_to_device(iter(batches), "cpu")
    with tracing.enable():
        for _ in range(3):
            loss = step(next(it))["loss"]
    it.close()
    assert np.isfinite(float(loss))
    snap = tracing.snapshot()
    steps, waits = _names(snap, "train.step"), _names(snap, "train.batch")
    assert len(steps) == 3 and len(waits) == 3
    for w, s in zip(waits, steps):
        assert w.end_ns <= s.start_ns and s.parent is None
