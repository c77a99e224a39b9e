"""The port's serving path on the CPU: config -> FlowServer -> flows.

The server must answer like a direct ``make_eval_step`` call on the same
weights (same model, same arithmetic: exact equality), answer a raw-events
request exactly as the voxel request of its own plain-twin grid after the
same center crop, bucket event counts, and report latency. Requests are
staged on the server's own staging thread: a batched events group reaches
the events step as the one host-packed buffer of its requests, bit for
bit; nothing is packed on the dispatch thread; a request that cannot be
staged fails alone.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from sdformerflow_tpu.training.config import build_configs as j_build_configs
from sdformerflow_tpu.training.config import load_config as j_load_config
from sdformerflow_tpu_torch import native
from sdformerflow_tpu_torch.losses import aee_metrics
from sdformerflow_tpu_torch.models.registry import get_model, randomize_
from sdformerflow_tpu_torch.ops.voxel import voxel_grid_signed
from sdformerflow_tpu_torch.serving import FlowServer, next_bucket
from sdformerflow_tpu_torch.training.config import build_configs, load_config
from sdformerflow_tpu_torch.training.train_step import (center_crop,
                                                        make_eval_step)

from torch_port_harness import one_torch_thread  # noqa: F401

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def _tiny_config():
    # the repo's tiny SDformerFlow at 96x128: every stage keeps an even
    # window count (48x64 would leave stage 3 with one window pair)
    config = load_config(os.path.join(CONFIGS, "test_tiny_snn.yaml"))
    config["loader"]["crop"] = [96, 128]
    return config


@pytest.mark.parametrize("name", ["train_dsec_sdformerflow_en4.yaml",
                                  "test_tiny_snn.yaml"])
def test_config_matches_jax(name):
    path = os.path.join(CONFIGS, name)
    model, swin, spiking = build_configs(load_config(path))
    j_model, j_swin, j_spiking = j_build_configs(j_load_config(path))
    assert model == j_model
    for field in swin.__dataclass_fields__:
        assert getattr(swin, field) == getattr(j_swin, field), field
    for field in spiking.__dataclass_fields__:
        assert getattr(spiking, field) == getattr(j_spiking, field), field


def test_flow_server_matches_eval_step_cpu():
    config = _tiny_config()
    model_cfg, swin, spiking = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg, swin, spiking)
    randomize_(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    rng = np.random.default_rng(0)
    requests = [(rng.standard_normal((10, 96, 128))
                 * (rng.random((10, 96, 128)) < 0.3)).astype(np.float32)
                for _ in range(3)]
    step = make_eval_step(model)
    with FlowServer(config, state, device="cpu", bf16=False) as server:
        futures = [server.submit(r) for r in requests]
        flows = [f.result(timeout=120) for f in futures]
        with pytest.raises(ValueError, match="one length"):
            server.infer({"x": np.zeros(4), "y": np.zeros(3),
                          "t": np.zeros(4), "p": np.zeros(4)})
        stats = server.stats()
    assert stats["served"] == 3 and stats["latency_ms_p50"] > 0
    for r, flow in zip(requests, flows):
        want = step(torch.from_numpy(r)[None])
        assert len(want) == 4
        assert flow.shape == (2, 96, 128) and flow.dtype == np.float32
        assert np.isfinite(flow).all() and np.abs(flow).max() > 0
        np.testing.assert_array_equal(flow, want[-1][0].numpy())
        m = aee_metrics(torch.from_numpy(flow)[None], want[-1],
                        torch.ones(1, 1, 96, 128))
        assert m["AEE"].item() == 0.0
    assert not np.array_equal(flows[0], flows[1])


def test_bf16_eval_step_keeps_bn_stats_f32():
    config = _tiny_config()
    model_cfg, swin, spiking = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg, swin, spiking)
    randomize_(model, torch.Generator().manual_seed(1))
    step = make_eval_step(model, compute_dtype=torch.bfloat16)
    cast = step.model
    assert all(p.dtype == torch.bfloat16 for p in cast.parameters())
    assert all(b.dtype == torch.float32 for b in cast.buffers())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    chunk = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 10, 96, 128)).astype(np.float32))
    flows = step(chunk)
    assert flows[-1].dtype == torch.float32
    assert flows[-1].shape == (1, 2, 96, 128)
    assert torch.isfinite(flows[-1]).all()


SENSOR = (104, 136)   # raw events arrive at this size, crop 96x128


@pytest.fixture(scope="module")
def events_server():
    config = _tiny_config()
    config["loader"]["resolution"] = list(SENSOR)
    model_cfg, swin, spiking = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg, swin, spiking)
    randomize_(model, torch.Generator().manual_seed(3))
    with FlowServer(config, model.state_dict(), device="cpu",
                    bf16=False) as server:
        yield server


def _raw_events(n, seed):
    rng = np.random.default_rng(seed)
    h, w = SENSOR
    return {"x": rng.uniform(-1, w, n).astype(np.float32),
            "y": rng.uniform(-1, h, n).astype(np.float32),
            "t": np.sort(rng.uniform(0, 0.1, n)).astype(np.float32),
            "p": rng.integers(0, 2, n).astype(np.uint8)}


def test_next_bucket():
    assert next_bucket(1) == 4096
    assert next_bucket(4096) == 4096
    assert next_bucket(4097) == 8192
    assert next_bucket(100_000) == 131072
    assert next_bucket((1 << 20) + 1) == 1 << 21


def test_events_request_matches_its_voxel_request(events_server):
    """An events request equals the voxel request of its own grid (the
    plain twin, t_range from the events' span) after the same center
    crop, bit for bit."""
    ev = _raw_events(3000, seed=4)
    t = torch.from_numpy(ev["t"])
    grid = voxel_grid_signed(
        torch.from_numpy(ev["x"]), torch.from_numpy(ev["y"]), t,
        torch.from_numpy(ev["p"]), num_bins=10, height=SENSOR[0],
        width=SENSOR[1], t_range=(t.min(), t.max()))
    assert grid.abs().sum() > 0
    chunk = center_crop(grid, (96, 128)).numpy()
    got = events_server.infer(ev)
    assert got.shape == (2, 96, 128) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, events_server.infer(chunk))


def test_events_requests_in_one_bucket(events_server):
    flows = [events_server.submit(_raw_events(n, seed=n)) for n in
             (1000, 3000)]   # both in the 4096 bucket
    a, b = (f.result(timeout=120) for f in flows)
    for flow in (a, b):
        assert flow.shape == (2, 96, 128) and np.isfinite(flow).all()
    assert not np.array_equal(a, b)


def test_warmup_bucket_coverage(events_server):
    """warmup serves one voxel request plus one events request per bucket:
    the target bucket only, or every bucket from the smallest up."""
    before = events_server.stats()["served"]
    events_server.warmup(5000)           # voxel + the 8192 bucket
    assert events_server.stats()["served"] == before + 2
    before = events_server.stats()["served"]
    events_server.warmup(5000, all_buckets=True)  # voxel + 4096 + 8192
    assert events_server.stats()["served"] == before + 3
    before = events_server.stats()["served"]
    events_server.warmup()               # voxel only
    assert events_server.stats()["served"] == before + 1


SMALL = (32, 48)     # sensor = crop: the tiny model's smallest frame


def _small_server(rows, **kwargs):
    """A float32 server on the CPU batching up to ``rows`` requests."""
    config = load_config(os.path.join(CONFIGS, "test_tiny_snn.yaml"))
    config["loader"]["resolution"] = list(SMALL)
    config["loader"]["crop"] = list(SMALL)
    model_cfg, swin, spiking = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg, swin, spiking)
    randomize_(model, torch.Generator().manual_seed(5))
    kwargs.setdefault("batch_window_s", 0.5)
    return FlowServer(config, model.state_dict(), device="cpu", bf16=False,
                      devices=["cpu"] * rows, **kwargs)


def _small_events(n, seed):
    rng = np.random.default_rng(seed)
    h, w = SMALL
    return {"x": rng.uniform(0, w - 1, n).astype(np.float32),
            "y": rng.uniform(0, h - 1, n).astype(np.float32),
            "t": np.sort(rng.uniform(0, 0.1, n)).astype(np.float32),
            "p": rng.integers(0, 2, n).astype(np.uint8)}


def _host_pack(requests, rows):
    """The group's [rows, 5, bucket] buffer packed on the host in one go:
    each request in the largest one's bucket, the rows past them zero."""
    bucket = next_bucket(max(len(r["x"]) for r in requests))
    buf = np.zeros((rows, 5, bucket), np.float32)
    for b, r in enumerate(requests):
        native.pack_window(r["x"], r["y"], r["t"], r["p"], bucket, t0=0.0,
                           out=buf[b])
    return torch.from_numpy(buf)


@pytest.mark.parametrize("rows", [2, 4])
def test_staged_group_is_the_host_packed_buffer(rows):
    """3 events requests of one bucket: each group reaches the events step
    as the host-packed buffer of its requests, padded rows included, bit
    for bit (2 rows: groups of 2 and 1 + a zero row; 4 rows: 3 + 1)."""
    reqs = [_small_events(n, seed) for n, seed in
            ((1000, 1), (3000, 2), (2500, 3))]
    seen = []
    with _small_server(rows) as server:
        cpu = torch.device("cpu")
        voxel_step, events_step = server._steps[cpu]

        def spy(ev):
            seen.append(torch.stack([ev["x"], ev["y"], ev["t"], ev["p"],
                                     ev["valid"].float()], 1))
            return events_step(ev)
        server._steps[cpu] = (voxel_step, spy)
        flows = [f.result(timeout=300)
                 for f in [server.submit(r) for r in reqs]]
    for flow in flows:
        assert flow.shape == (2,) + SMALL and np.isfinite(flow).all()
    groups = [reqs[i:i + rows] for i in range(0, len(reqs), rows)]
    assert len(seen) == len(groups)
    for got, group in zip(seen, groups):
        want = _host_pack(group, rows)
        assert got.shape == want.shape == (rows, 5, 4096)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert not want[len(group):].any()


def test_nothing_is_packed_on_the_dispatch_thread(monkeypatch):
    """Events and voxel requests, mixed: every ``native.pack_window`` call
    and every request's staging runs on the staging thread."""
    packs, stages = [], []
    pack = native.pack_window

    def pack_spy(*args, **kwargs):
        packs.append(threading.current_thread().name)
        return pack(*args, **kwargs)
    monkeypatch.setattr(native, "pack_window", pack_spy)
    rng = np.random.default_rng(6)
    voxels = [rng.normal(size=(10,) + SMALL).astype(np.float32)
              for _ in range(2)]
    reqs = [_small_events(2000, 7), voxels[0], _small_events(1500, 8),
            voxels[1]]
    with _small_server(2) as server:
        stage = server._stage

        def stage_spy(request):
            stages.append(threading.current_thread().name)
            return stage(request)
        monkeypatch.setattr(server, "_stage", stage_spy)
        for f in [server.submit(r) for r in reqs]:
            assert np.isfinite(f.result(timeout=300)).all()
    assert packs == ["flow-stage"] * 2
    assert stages == ["flow-stage"] * 4


def test_a_malformed_request_fails_alone():
    """One request without ``t`` among three good ones: it fails with its
    own KeyError; the three are answered in one group; ``serve.failed``
    counts 1 and ``serve.staged`` 3."""
    with _small_server(4) as server:
        before = server.stats()
        good = [_small_events(2000, s) for s in range(3)]
        bad = {"x": np.zeros(5, np.float32), "y": np.zeros(5, np.float32)}
        futs = [server.submit(r) for r in (good[0], bad, good[1], good[2])]
        with pytest.raises(KeyError, match="'t'"):
            futs[1].result(timeout=300)
        flows = [futs[i].result(timeout=300) for i in (0, 2, 3)]
        after = server.stats()
    for flow in flows:
        assert flow.shape == (2,) + SMALL and np.isfinite(flow).all()
    got = {k: after[k] - before[k] for k in
           ("serve.failed", "serve.staged", "serve.requests",
            "serve.groups")}
    assert got == {"serve.failed": 1, "serve.staged": 3,
                   "serve.requests": 3, "serve.groups": 1}
    assert after["served"] - before["served"] == 3


def test_many_submitters_through_a_small_bound():
    """12 threads submit 3 requests each (voxel, events and, from every
    third thread, one malformed) through ``max_pending=3`` with a short
    switch interval: every future resolves, each good one with a flow,
    each malformed one with its KeyError; the counters add up and the
    bound is whole again."""
    rng = np.random.default_rng(9)
    voxel = rng.normal(size=(10,) + SMALL).astype(np.float32)
    futures, lock = [], threading.Lock()

    def submitter(k):
        reqs = [voxel, _small_events(1000 + k, k)]
        if k % 3 == 0:
            reqs.append({"x": np.zeros(4, np.float32)})
        for r in reqs:
            f = server.submit(r)
            with lock:
                futures.append((isinstance(r, dict) and "t" not in r, f))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _small_server(4, max_pending=3,
                           batch_window_s=0.01) as server:
            threads = [threading.Thread(target=submitter, args=(k,))
                       for k in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            for bad, f in futures:
                if bad:
                    with pytest.raises(KeyError):
                        f.result(timeout=300)
                else:
                    assert np.isfinite(f.result(timeout=300)).all()
            stats = server.stats()
            assert all(server._room.acquire(blocking=False)
                       for _ in range(3))
    finally:
        sys.setswitchinterval(interval)
    assert len(futures) == 28
    assert stats["serve.failed"] == 4
    assert stats["serve.staged"] == stats["serve.requests"] == 24
    assert stats["served"] == 24 and stats["pending"] == 0
