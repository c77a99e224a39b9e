"""The port's serving path on the CPU: config -> FlowServer -> flows.

The server must answer like a direct ``make_eval_step`` call on the same
weights (same model, same arithmetic: exact equality), reject raw-event
requests until the on-device voxelizer is ported, and report latency.
"""

import os

import numpy as np
import pytest
import torch

from sdformerflow_tpu.training.config import build_configs as j_build_configs
from sdformerflow_tpu.training.config import load_config as j_load_config
from sdformerflow_tpu_torch.losses import aee_metrics
from sdformerflow_tpu_torch.models.registry import get_model, randomize_
from sdformerflow_tpu_torch.serving import FlowServer
from sdformerflow_tpu_torch.training.config import build_configs, load_config
from sdformerflow_tpu_torch.training.train_step import make_eval_step

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
        with pytest.raises(NotImplementedError):
            server.submit({"x": np.zeros(4), "y": np.zeros(4),
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
