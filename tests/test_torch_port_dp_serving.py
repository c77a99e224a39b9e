"""PyTorch port vs the JAX package: ``FlowServer`` batching queued requests
over devices, on the CPU (float32).

The port's batched server (``FlowServer(devices=["cpu"] * 2)``, one replica,
groups of two rows) answers every request with its batch-1 flow: the flow
of the port's one-request server and of JAX's one-request server, within
atol 1e-5 (the tolerance of JAX's ``tests/test_serving.py:130-160``). The
weights are seeded random draws, so the model fires and a wrong row shows.
JAX's mesh server (``FlowServer(mesh=make_mesh(n_data=2))``) does not
answer so: the reference's raw window refold mixes a batch's rows
(``ops/windows.py:window_partition_v2_tm``), and the input's min-max
normalization spans the batch, so JAX's batched flows are those of the
two-row batch forward. The port's eval step computes that forward too
(held here against JAX's mesh server at 1e-5), while its server keeps the
rows apart on purpose. Mixed event and voxel requests park the
incompatible leader; two distinct devices (``cpu`` and ``cpu:0``) run one
row each on their own replicas; a model whose eval mixes rows (BN_notrack)
refuses distinct devices; ``serve --dp 2 --device cpu`` answers over HTTP.
"""

import concurrent.futures
import os
import re
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from sdformerflow_tpu.models.registry import get_model as j_get_model
from sdformerflow_tpu.parallel.mesh import make_mesh as j_make_mesh
from sdformerflow_tpu.serving import FlowServer as JFlowServer
from sdformerflow_tpu.training import config as j_config
from sdformerflow_tpu.training import optim as j_optim
from sdformerflow_tpu.training import train_step as j_train_step
from sdformerflow_tpu_torch import flow_client
from sdformerflow_tpu_torch.models.registry import get_model
from sdformerflow_tpu_torch.serving import FlowServer
from sdformerflow_tpu_torch.training import optim
from sdformerflow_tpu_torch.training.checkpoints import save_checkpoint
from sdformerflow_tpu_torch.training.config import build_configs, load_config
from sdformerflow_tpu_torch.training.from_jax import from_jax
from sdformerflow_tpu_torch.training.train_step import make_eval_step

from torch_port_harness import randomize_tree
from torch_port_harness import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
TINY = os.path.join(ROOT, "configs", "test_tiny_snn.yaml")
H, W = 32, 48       # JAX's serving tests' frame: stage 4 has 5 windows
ATOL = 1e-5


def _config():
    cfg = load_config(TINY)
    cfg["loader"]["resolution"] = [H, W]
    cfg["loader"]["crop"] = [H, W]     # the model is built at the crop
    cfg["loader"]["batch_size"] = 1
    return cfg


def _voxels(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(10, H, W)).astype(np.float32) for _ in range(n)]


def _events(n, seed):
    r = np.random.default_rng(seed)
    return {"x": r.uniform(0, W - 1, n).astype(np.float32),
            "y": r.uniform(0, H - 1, n).astype(np.float32),
            "t": np.sort(r.uniform(0, 1, n)).astype(np.float32),
            "p": r.integers(0, 2, n).astype(np.float32)}


@pytest.fixture(scope="module")
def servers():
    """JAX's one-request and mesh servers and the port's one-request and
    batched servers, over one randomized float32 state."""
    cfg = _config()
    jmodel = j_get_model(cfg["model"]["name"],
                         *j_config.build_configs(cfg))
    x = np.zeros((1, 10, 2, H, W), np.float32)
    shapes = jax.eval_shape(lambda z: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, z, False), x)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), randomize_tree(
            jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes), 5))
    state = j_train_step.TrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=j_optim.build_optimizer(steps_per_epoch=1))
    tmodel = get_model(cfg["model"]["name"], *build_configs(cfg))
    sd = from_jax(variables, tmodel)
    with JFlowServer(cfg, state, bf16=False) as jone, \
            JFlowServer(cfg, state, bf16=False, mesh=j_make_mesh(n_data=2),
                        max_pending=16, batch_window_s=0.5) as jmesh, \
            FlowServer(cfg, sd, device="cpu", bf16=False) as one, \
            FlowServer(cfg, sd, device="cpu", bf16=False, max_pending=16,
                       devices=["cpu"] * 2, batch_window_s=0.5) as batched:
        yield dict(cfg=cfg, sd=sd, jone=jone, jmesh=jmesh, one=one,
                   batched=batched)


def _groups(server, monkeypatch):
    """Record the kinds of each group the server launches."""
    seen = []
    launch = server._launch

    def spy(group, gid):
        seen.append([s.key[0] for s in group])
        return launch(group, gid)

    monkeypatch.setattr(server, "_launch", spy)
    return seen


def test_coalesced_voxel_requests_equal_batch1_serving(servers, monkeypatch):
    """6 requests queued at once: 3 groups of 2 rows, each flow its batch-1
    flow on the port and on JAX."""
    xs = _voxels(6, seed=7)
    groups = _groups(servers["batched"], monkeypatch)
    futs = [servers["batched"].submit(x) for x in xs]
    flows = [f.result(timeout=120) for f in futs]
    assert groups == [["voxel", "voxel"]] * 3
    for x, flow in zip(xs, flows):
        want = servers["jone"].infer(x)
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(flow, servers["one"].infer(x), atol=ATOL)
        np.testing.assert_allclose(flow, want, atol=ATOL)


def test_jax_mesh_server_is_the_two_row_batch_forward(servers):
    """JAX's batched flows are the port's two-row eval forward (rows mixed
    by the refold and the batch-wide normalization), not batch-1 flows."""
    xs = _voxels(2, seed=8)
    futs = [servers["jmesh"].submit(x) for x in xs]
    got = np.stack([f.result(timeout=120) for f in futs])
    model = get_model(servers["cfg"]["model"]["name"],
                      *build_configs(servers["cfg"]))
    model.load_state_dict(servers["sd"])
    step = make_eval_step(model.eval(), norm_input="minmax")
    want = step(torch.from_numpy(np.stack(xs)))[-1].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    one = np.stack([servers["one"].infer(x) for x in xs])
    assert np.abs(got - one).max() > 100 * ATOL


def test_mixed_kinds_park_the_incompatible_leader(servers, monkeypatch):
    evs = [_events(1500, i) for i in range(3)]
    vox = _voxels(1, seed=9)[0]
    groups = _groups(servers["batched"], monkeypatch)
    reqs = [evs[0], evs[1], vox, evs[2]]
    futs = [servers["batched"].submit(r) for r in reqs]
    flows = [f.result(timeout=120) for f in futs]
    assert groups == [["events", "events"], ["voxel"], ["events"]]
    for r, flow in zip(reqs, flows):
        np.testing.assert_allclose(flow, servers["one"].infer(r), atol=ATOL)
        np.testing.assert_allclose(flow, servers["jone"].infer(r), atol=ATOL)


def test_distinct_devices_run_their_rows_on_their_replicas(servers):
    cfg, sd = servers["cfg"], servers["sd"]
    xs = _voxels(2, seed=10)
    with FlowServer(cfg, sd, device="cpu", bf16=False,
                    devices=["cpu", "cpu:0"], batch_window_s=0.5) as s:
        assert sorted(map(str, s._steps)) == ["cpu", "cpu:0"]
        assert s._rows_by_device(2) == [(torch.device("cpu"), [0]),
                                        (torch.device("cpu:0"), [1])]
        futs = [s.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            np.testing.assert_allclose(f.result(timeout=120),
                                       servers["one"].infer(x), atol=ATOL)


def test_row_mixing_model_refuses_distinct_devices():
    cfg = _config()
    cfg["model"]["spiking_neuron"]["spike_norm"] = "BN_notrack"
    with pytest.raises(ValueError, match="mixes the rows of a batch"):
        FlowServer(cfg, device="cpu", bf16=False, devices=["cpu", "cpu:0"])
    with FlowServer(cfg, device="cpu", bf16=False,
                    devices=["cpu", "cpu"]) as s:
        assert list(s._steps) == [torch.device("cpu")]


def test_serve_dp2_on_cpu_answers_over_http(servers, tmp_path):
    """``serve --dp 2 --device cpu`` from a trainer checkpoint: concurrent
    requests over HTTP equal the in-process one-request server."""
    cfg = servers["cfg"]
    model = get_model(cfg["model"]["name"], *build_configs(cfg))
    model.load_state_dict(servers["sd"])
    opt = optim.build_optimizer(model.named_parameters(), steps_per_epoch=1)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, model, opt, 0, 0)
    config_path = tmp_path / "tiny.yaml"
    config_path.write_text(yaml.safe_dump(cfg))
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdformerflow_tpu_torch.serve",
         "--train_config", str(config_path), "--ckpt", ckpt, "--device",
         "cpu", "--port", "0", "--dp", "2", "--no_bf16"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"serving on (http://127\.0\.0\.1:\d+)", line)
            if m:
                break
        assert m, lines
        base = m.group(1)
        xs = _voxels(4, seed=11)
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            flows = list(ex.map(lambda x: flow_client.post_flow(
                base, chunk=x), xs))
        for x, flow in zip(xs, flows):
            np.testing.assert_allclose(flow, servers["one"].infer(x),
                                       atol=ATOL)
        assert flow_client.get_stats(base)["served"] >= 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "server closed" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
