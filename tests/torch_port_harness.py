"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_port_*).

Both frameworks get the same numpy inputs and the same randomized
variables: every parameter and BN statistic is drawn (0.4 * N(0, 1), BN
variances |.| + 0.25), because zero positional encodings, identity BN and
symmetric PSN mixes would hide wrong pairings (PERF_NOTES round 3).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sdformerflow_tpu.models.common import SpikingConfig as JSpikingConfig
from sdformerflow_tpu.models.common import SwinConfig as JSwinConfig
from sdformerflow_tpu.models.registry import get_model as j_get_model
from sdformerflow_tpu.models.snn_flownet import (
    SpikingformerFlowNet as JSpikingformerFlowNet)
from sdformerflow_tpu_torch.models.common import SpikingConfig, SwinConfig
from sdformerflow_tpu_torch.models.registry import get_model
from sdformerflow_tpu_torch.models.snn_flownet import SpikingformerFlowNet
from sdformerflow_tpu_torch.training.from_jax import from_jax


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a test module on one torch thread: under the suite's parallel
    workers torch's default of a thread a core oversubscribes the host, and
    the trainer entry points then run 30-90x slower (~1 s alone). Module
    scope, so that it also covers the module's shared fixtures (an autouse
    fixture is set up first within its scope)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize_tree(variables, seed: int):
    """numpy-randomized copy of a flax variable dict, in float64."""
    rng = np.random.default_rng(seed)
    out = {}
    for coll, tree in variables.items():
        def draw(a, stats=coll == "batch_stats"):
            v = 0.4 * rng.standard_normal(np.shape(a))
            return np.abs(v) + 0.25 if stats else v
        out[coll] = jax.tree_util.tree_map(draw, tree)
    return out


def flownet_pair(*, size, depths, heads, window, num_steps, num_bins, base,
                 drop_path_rate=0.2, s2d_embed=False, mlp_ratio=4.0,
                 **cfg_extra):
    """(JAX model with the fused Pallas attention, port model) of one
    SDformerFlow geometry, with the s2d embed head if ``s2d_embed``; the
    ``cfg_extra`` switches (``fold_bn``, ``s2d_train``) go to both
    SpikingConfigs."""
    swin_kw = dict(arc_type="swinv1",
                   patch_embed_type="MS_PED_Spiking_PatchEmbed_Conv_sfn",
                   input_size=size, patch_size=(1, 1, 2, 2), depths=depths,
                   num_heads=heads, out_indices=tuple(range(len(depths))),
                   window_size=window, qk_scale=0.125,
                   drop_path_rate=drop_path_rate, mlp_ratio=mlp_ratio)
    cfg_kw = dict(num_steps=num_steps, v_th=0.1, v_reset=None,
                  neuron_type="psn", spike_norm="BN", s2d_embed=s2d_embed,
                  **cfg_extra)
    net_kw = dict(num_bins=num_bins, base_num_channels=base,
                  num_encoders=len(depths), use_upsample_conv=False, ms=True)
    jmodel = JSpikingformerFlowNet(
        swin=JSwinConfig(**swin_kw),
        cfg=JSpikingConfig(**cfg_kw, fused_qk_attn=True), **net_kw)
    tmodel = SpikingformerFlowNet(SwinConfig(**swin_kw),
                                  SpikingConfig(**cfg_kw), **net_kw).eval()
    return jmodel, tmodel


def init_pair(jmodel, tmodel, x_enc: np.ndarray, seed: int):
    """Randomized float64 variables for both models (crossed through
    ``from_jax``); returns the JAX variables."""
    # every leaf is drawn anew: the init's shapes are enough (no compile)
    shapes = jax.eval_shape(lambda z: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, z, False), x_enc.astype(np.float32))
    variables = randomize_tree(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape), shapes), seed)
    tmodel.double().load_state_dict(from_jax(variables, tmodel))
    return variables


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def zoo_pair(name, *, model_cfg=None, **kw):
    """(JAX model, port model) of registry ``name`` on the tiny zoo
    geometry (T = 4, base 8, depths (1, 1, 1), window (2, 3, 3), 32x32, 4
    bins, PSN + BN, drop-path off); ``kw`` overrides SwinConfig or
    SpikingConfig fields (each goes to whichever has it), ``model_cfg`` the
    registry's model section."""
    swin_kw = dict(arc_type="swinv1",
                   patch_embed_type="Spiking_PatchEmbed_Conv_sfn",
                   input_size=(32, 32), patch_size=(1, 1, 2, 2),
                   depths=(1, 1, 1), num_heads=(2, 2, 2),
                   out_indices=(0, 1, 2), window_size=(2, 3, 3),
                   qk_scale=0.125, drop_path_rate=0.0, mlp_ratio=2.0)
    cfg_kw = dict(num_steps=4, v_th=0.3, v_reset=None, neuron_type="psn",
                  spike_norm="BN")
    swin_fields = {f.name for f in dataclasses.fields(SwinConfig)}
    for k, v in kw.items():
        (swin_kw if k in swin_fields else cfg_kw)[k] = v
    model_cfg = dict({"num_bins": 4, "base_num_channels": 8},
                     **(model_cfg or {}))
    jmodel = j_get_model(name, model_cfg, JSwinConfig(**swin_kw),
                         JSpikingConfig(**cfg_kw))
    tmodel = get_model(name, model_cfg, SwinConfig(**swin_kw),
                       SpikingConfig(**cfg_kw))
    return jmodel, tmodel
