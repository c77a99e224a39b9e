"""The port's HTTP front (``sdformerflow_tpu_torch.serve``), its client and
the serving bench, on the CPU: requests over HTTP answer exactly as
``FlowServer.infer`` does in process, the protocol's other routes behave as
JAX's (``tests/test_serving.py::test_http_round_trip``), and the CLI binds
``--port 0``, serves and stops cleanly on SIGTERM.
"""

import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from sdformerflow_tpu_torch import bench_serving, flow_client, serve
from sdformerflow_tpu_torch.models.registry import get_model, randomize_
from sdformerflow_tpu_torch.serving import FlowServer
from sdformerflow_tpu_torch.training.config import build_configs, load_config

from torch_port_harness import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = os.path.join(ROOT, "configs", "test_tiny_snn.yaml")
CROP, SENSOR = (96, 128), (104, 136)


@pytest.fixture(scope="module")
def url():
    """A CPU FlowServer on the tiny config at 96x128 (seeded weights, f32)
    behind ``build_handler`` on a free port."""
    config = load_config(TINY)
    config["loader"]["crop"] = list(CROP)
    config["loader"]["resolution"] = list(SENSOR)
    model_cfg, swin, spiking = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg, swin, spiking)
    randomize_(model, torch.Generator().manual_seed(2))
    with FlowServer(config, model.state_dict(), device="cpu",
                    bf16=False) as server:
        httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                    serve.build_handler(server))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            yield f"http://127.0.0.1:{httpd.server_address[1]}", server
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
    assert not thread.is_alive()


def _events(n, seed):
    rng = np.random.default_rng(seed)
    h, w = SENSOR
    return {"x": rng.integers(0, w, n).astype(np.uint16),
            "y": rng.integers(0, h, n).astype(np.uint16),
            "t": np.sort(rng.integers(0, 50_000, n)).astype(np.int64),
            "p": rng.integers(0, 2, n).astype(np.uint8)}


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def test_http_requests_equal_in_process_infer(url):
    base, server = url
    rng = np.random.default_rng(3)
    chunk = (rng.standard_normal((10,) + CROP)
             * (rng.random((10,) + CROP) < 0.3)).astype(np.float32)
    events = _events(3000, seed=4)
    got = flow_client.post_flow(base, chunk=chunk)
    assert got.dtype == np.float32 and got.shape == (2,) + CROP
    assert np.abs(got).max() > 0
    np.testing.assert_array_equal(got, server.infer(chunk))
    got = flow_client.post_flow(base, events=events)
    assert got.shape == (2,) + CROP and np.isfinite(got).all()
    np.testing.assert_array_equal(got, server.infer(events))
    with pytest.raises(ValueError, match="exactly one"):
        flow_client.post_flow(base)


def test_http_routes_stats_healthz_404_400(url):
    base, server = url
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert r.status == 200 and r.read() == b"ok"
    flow_client.post_flow(base, chunk=np.zeros((10,) + CROP, np.float32))
    stats = flow_client.get_stats(base)
    assert stats == json.loads(urllib.request.urlopen(
        base + "/stats", timeout=30).read())
    assert stats["served"] >= 1 and stats["pending"] == 0
    assert stats["latency_ms_p50"] > 0
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nope", timeout=30)
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/nope", b"")
    assert e.value.code == 404
    bad = {"not an npz": b"garbage"}
    buf = io.BytesIO()
    np.savez(buf, chunk=np.zeros((10, 8, 8), np.float32))   # wrong size
    bad["chunk of another size"] = buf.getvalue()
    buf = io.BytesIO()
    np.savez(buf, x=np.zeros(4), y=np.zeros(3), t=np.zeros(4),
             p=np.zeros(4))
    bad["events of unequal lengths"] = buf.getvalue()
    buf = io.BytesIO()
    np.savez(buf, x=np.zeros(4))
    bad["events without y/t/p"] = buf.getvalue()
    for why, body in bad.items():
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/flow", body)
        assert e.value.code == 400, why
        assert e.value.read(), why
    # the server still answers after the bad requests
    assert flow_client.get_stats(base)["served"] == stats["served"]


def test_serve_cli_port_0_and_sigterm():
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdformerflow_tpu_torch.serve",
         "--train_config", TINY, "--device", "cpu", "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"serving on (http://127\.0\.0\.1:(\d+))", line)
            if m:
                break
        assert m and int(m.group(2)) > 0, lines
        base = m.group(1)
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.read() == b"ok"
        h, w = load_config(TINY)["loader"]["crop"]
        flow = flow_client.post_flow(base, chunk=np.zeros((10, h, w),
                                                          np.float32))
        assert flow.shape == (2, h, w)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "server closed" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_serve_refuses_data_parallel(monkeypatch):
    """``--dp N`` on the card needs N visible cards (here one)."""
    monkeypatch.setattr(serve.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(serve.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--dp 2 needs 2 CUDA devices"):
        serve.main(["--train_config", TINY, "--dp", "2"])


def test_bench_serving_on_cpu(tmp_path):
    out = bench_serving.main(["--config", TINY, "--device", "cpu",
                              "--requests", "2", "--events_exp", "12"])
    assert out["card"] == "cpu"
    for label in ("voxel@crop", "events@2^12"):
        assert out[label]["requests"] == 2
        assert out[label]["windows_per_s"] > 0
        assert out[label]["stats"]["served"] >= 2
