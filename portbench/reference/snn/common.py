"""Configuration dataclasses, mirrors of ``sdformerflow_tpu/models/common.py``.

Plain frozen dataclasses with the JAX package's field names and defaults for
every field ``training/config.py:build_configs`` fills, and ``fold_bn``.
The JAX-only switches left out:

- ``fused_qk_attn``: the port runs K1 at every even window count of a
  temporal window of 2 in eval, for a PSN with running-statistics BN;
- ``pairlocal_attn``: the port always runs the pair-local form at an even
  window count of a temporal window of 2 (in train, or for another neuron
  or norm; K1 is its eval form), which is what the switch selects in JAX,
  and the raw-refold form elsewhere, where JAX's switch has no effect
  either.

One deviation under ``fold_bn``: JAX turns its fused attention off there
(``spiking_swin.py:323-328``); the port keeps K1, on the folded linears
with a unit scale and the folded bias as its shift (the same function).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SpikingConfig:
    """The reference's ``spiking_neuron`` config section."""
    num_steps: int = 10
    v_th: float = 1.0
    v_reset: Optional[float] = None
    neuron_type: str = "lif"
    surrogate: str = "atan"
    surrogate_alpha: float = 2.0
    tau: float = 2.0
    detach_reset: bool = True
    spike_norm: Optional[str] = "BN"
    # the membrane monitor: while a collection is active
    # (spiking_layers.collect_sites) each neuron site also records its
    # per-step membrane statistics
    store_v_seq: bool = False
    # eval-time BN folding (training/bn_folding.py:fold_model): every
    # foldable BN site is skipped and its partner conv / linear has a bias
    fold_bn: bool = False
    # the eval-only space-to-depth embed head (weights rearranged by
    # training/s2d_embed.py)
    s2d_embed: bool = False
    # the same re-expression in both modes on reference-shaped parameters
    # (expanded at each call, BN statistics over the 4 block positions):
    # the base model's state_dict
    s2d_train: bool = False

    def replace(self, **kw) -> "SpikingConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """The reference's ``swin_transformer`` config section."""
    arc_type: str = "swinv1"
    patch_embed_type: str = "MS_PED_Spiking_PatchEmbed_Conv_sfn"
    input_size: Tuple[int, int] = (288, 384)
    patch_size: Tuple[int, ...] = (1, 1, 2, 2)
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    window_size: Tuple[int, int, int] = (2, 9, 9)
    pretrained_window_size: Tuple[int, int, int] = (0, 0, 0)
    mlp_ratio: float = 4.0
    qk_scale: Optional[float] = 0.125
    drop_path_rate: float = 0.2

    def replace(self, **kw) -> "SwinConfig":
        return dataclasses.replace(self, **kw)


def trunc_normal_02_(t: torch.Tensor) -> torch.Tensor:
    """flax ``truncated_normal(stddev=0.02, lower=-2, upper=2)``: N(0, 0.02)
    cut at two standard deviations (the JAX ANN's Dense and bias-table
    init)."""
    return torch.nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04)
