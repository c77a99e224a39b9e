"""Configuration dataclasses, mirrors of ``sdformerflow_tpu/models/common.py``.

Plain frozen dataclasses with the JAX package's field names and defaults for
every field ``training/config.py:build_configs`` fills. The JAX-only
switches (``fused_qk_attn`` / ``pairlocal_attn``: the port always runs the
pair-local attention, ``fold_bn``, ``store_v_seq``) are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
    # the JAX package's s2d embed re-expressions, not ported yet: setting
    # one raises NotImplementedError
    s2d_embed: bool = False
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
