"""Model registry, mirror of ``sdformerflow_tpu/models/registry.py`` for the
ported names, plus the seeded randomization the slice runs on (the repo has
no trained checkpoint).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn as nn

from .common import SpikingConfig, SwinConfig

MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn
    return deco


def get_model(name: str, model_cfg: dict, swin_cfg: SwinConfig,
              spiking_cfg: SpikingConfig) -> nn.Module:
    """Build a registered model, in eval mode (the only ported mode)."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](model_cfg, swin_cfg, spiking_cfg).eval()


@register_model("MS_SpikingformerFlowNet_en4")
def _mssf4(model_cfg, swin_cfg, spiking_cfg):
    from .snn_flownet import SpikingformerFlowNet
    return SpikingformerFlowNet(
        swin=swin_cfg, cfg=spiking_cfg,
        num_bins=model_cfg.get("num_bins", 10),
        base_num_channels=model_cfg.get("base_num_channels", 96),
        kernel_size=model_cfg.get("kernel_size", 3),
        num_encoders=4,
        use_upsample_conv=model_cfg.get("use_upsample_conv", False),
        ms=True)


@torch.no_grad()
def randomize_(model: nn.Module, generator: torch.Generator,
               scale: float = 0.4, var_floor: float = 0.25) -> nn.Module:
    """Overwrite every parameter and BN statistic with seeded noise, in
    place: ``scale * N(0, 1)`` everywhere, BN variances ``|.| + var_floor``.
    Degenerate inits (zero positional encodings, identity BN, symmetric PSN
    mixes) would hide wrong pairings in an A/B, so every value is drawn."""
    for name, t in sorted(model.state_dict().items()):
        noise = torch.randn(t.shape, generator=generator, dtype=torch.float64,
                            device=generator.device)
        noise = noise.mul_(scale)
        if name.endswith("running_var"):
            noise = noise.abs_().add_(var_floor)
        t.copy_(noise.to(t.device, t.dtype))
    return model
