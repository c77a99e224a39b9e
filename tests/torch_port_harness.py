"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_port_*).

Both frameworks get the same numpy inputs and the same randomized
variables: every parameter and BN statistic is drawn (0.4 * N(0, 1), BN
variances |.| + 0.25), because zero positional encodings, identity BN and
symmetric PSN mixes would hide wrong pairings (PERF_NOTES round 3).
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from sdformerflow_tpu.models.common import SpikingConfig as JSpikingConfig
from sdformerflow_tpu.models.common import SwinConfig as JSwinConfig
from sdformerflow_tpu.models.snn_flownet import (
    SpikingformerFlowNet as JSpikingformerFlowNet)
from sdformerflow_tpu_torch.models.common import SpikingConfig, SwinConfig
from sdformerflow_tpu_torch.models.snn_flownet import SpikingformerFlowNet
from sdformerflow_tpu_torch.training.from_jax import from_jax


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


def flownet_pair(*, size, depths, heads, window, num_steps, num_bins, base):
    """(JAX model with the fused Pallas attention, port model) of one
    SDformerFlow geometry."""
    swin_kw = dict(arc_type="swinv1",
                   patch_embed_type="MS_PED_Spiking_PatchEmbed_Conv_sfn",
                   input_size=size, patch_size=(1, 1, 2, 2), depths=depths,
                   num_heads=heads, out_indices=tuple(range(len(depths))),
                   window_size=window, qk_scale=0.125)
    cfg_kw = dict(num_steps=num_steps, v_th=0.1, v_reset=None,
                  neuron_type="psn", spike_norm="BN")
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
    variables = jax.jit(lambda z: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, z, False))(x_enc.astype(np.float32))
    variables = randomize_tree(variables, seed)
    tmodel.double().load_state_dict(from_jax(variables, tmodel))
    return variables


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))
