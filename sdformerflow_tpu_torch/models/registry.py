"""Model registry, mirror of ``sdformerflow_tpu/models/registry.py`` (every
name: the SNN zoo and the ANN family), plus ``ERAFT`` (``models/eraft.py``,
which JAX lacks) and the seeded randomization the port's checks run on
(the repo has no trained checkpoint).

``input_bins`` (``training.config.chunk_bins``: ``data.num_frames *
data.num_chunks``) is the bin count of the chunks an STTFlowNet will take;
torch needs it at construction. The other models ignore it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

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
              spiking_cfg: SpikingConfig, *, train: bool = False,
              input_bins: Optional[int] = None) -> nn.Module:
    """Build a registered model, in eval mode unless ``train``;
    ``input_bins`` the bins of the chunks it will take (default
    ``model.num_bins``)."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(MODEL_REGISTRY)}")
    if input_bins is not None:
        model_cfg = dict(model_cfg, input_bins=input_bins)
    return MODEL_REGISTRY[name](model_cfg, swin_cfg, spiking_cfg).train(train)


def _spikingformer(model_cfg, swin_cfg, spiking_cfg, *, ms, num_en):
    from .snn_flownet import SpikingformerFlowNet
    return SpikingformerFlowNet(
        swin=swin_cfg, cfg=spiking_cfg,
        num_bins=model_cfg.get("num_bins", 10),
        base_num_channels=model_cfg.get("base_num_channels", 96),
        kernel_size=model_cfg.get("kernel_size", 3),
        num_encoders=num_en,
        use_upsample_conv=model_cfg.get("use_upsample_conv", False),
        ms=ms)


@register_model("SpikingformerFlowNet")
def _sf(model_cfg, swin_cfg, spiking_cfg):
    return _spikingformer(model_cfg, swin_cfg, spiking_cfg, ms=False,
                          num_en=3)


@register_model("MS_SpikingformerFlowNet")
def _mssf(model_cfg, swin_cfg, spiking_cfg):
    return _spikingformer(model_cfg, swin_cfg, spiking_cfg, ms=True,
                          num_en=3)


@register_model("MS_SpikingformerFlowNet_en4")
def _mssf4(model_cfg, swin_cfg, spiking_cfg):
    return _spikingformer(model_cfg, swin_cfg, spiking_cfg, ms=True,
                          num_en=4)


@register_model("SpikingMultiResUNet")
def _smru(model_cfg, swin_cfg, spiking_cfg):
    from .snn_flownet import SpikingMultiResUNetFlow
    return SpikingMultiResUNetFlow(
        cfg=spiking_cfg,
        num_bins=model_cfg.get("num_bins", 10),
        base_num_channels=model_cfg.get("base_num_channels", 32),
        num_encoders=model_cfg.get("num_encoders", 4),
        kernel_size=model_cfg.get("kernel_size", 5),
        use_upsample_conv=model_cfg.get("use_upsample_conv", True),
        ms=model_cfg.get("ms", False))


def _sttflownet(model_cfg, swin_cfg, spiking_cfg, *, num_en):
    from .ann_flownet import STTFlowNet
    # the reference's ANN constructors never pass qk_scale, so the ANN attention
    # always scales by head_dim ** -0.5; the config's 0.125 default is the
    # SNN backbone's and must not reach the ANN
    return STTFlowNet(
        swin=swin_cfg.replace(qk_scale=None),
        num_bins=model_cfg.get("num_bins", 10),
        base_num_channels=model_cfg.get("base_num_channels", 96),
        kernel_size=model_cfg.get("kernel_size", 3),
        num_encoders=num_en,
        use_upsample_conv=model_cfg.get("use_upsample_conv", True),
        norm=model_cfg.get("norm"),
        final_activation=model_cfg.get("final_activation"),
        norm_input=bool(model_cfg.get("norm_input", False)),
        encoding=model_cfg.get("encoding", "voxel"),
        input_bins=model_cfg.get("input_bins"))


@register_model("STTFlowNet")
def _stt(model_cfg, swin_cfg, spiking_cfg):
    return _sttflownet(model_cfg, swin_cfg, spiking_cfg, num_en=3)


@register_model("STTFlowNet_4en")
def _stt4(model_cfg, swin_cfg, spiking_cfg):
    return _sttflownet(model_cfg, swin_cfg, spiking_cfg, num_en=4)


@register_model("MultiResUNet")
def _mru(model_cfg, swin_cfg, spiking_cfg):
    from .ann_flownet import MultiResUNetFlow
    return MultiResUNetFlow(
        num_bins=model_cfg.get("num_bins", 10),
        base_num_channels=model_cfg.get("base_num_channels", 32),
        num_encoders=model_cfg.get("num_encoders", 4),
        kernel_size=model_cfg.get("kernel_size", 5),
        norm=model_cfg.get("norm"),
        use_upsample_conv=model_cfg.get("use_upsample_conv", True),
        final_activation=model_cfg.get("final_activation"))


@register_model("ERAFT")
def _eraft(model_cfg, swin_cfg, spiking_cfg):
    from .eraft import ERAFT
    bins = int(model_cfg.get("num_bins", 15))
    if model_cfg.get("input_bins") not in (None, 2 * bins):
        raise ValueError(
            f"ERAFT takes two windows of model.num_bins = {bins} bins "
            f"(data.num_frames = {bins}, data.num_chunks = 2), not "
            f"{model_cfg['input_bins']}-bin chunks")
    return ERAFT(num_bins=bins, iters=int(model_cfg.get("iters", 12)))


@torch.no_grad()
def randomize_(model: nn.Module, generator: torch.Generator,
               scale: float = 0.4, var_floor: float = 0.25) -> nn.Module:
    """Overwrite every parameter and BN statistic with seeded noise, in
    place: ``scale * N(0, 1)`` everywhere, BN variances ``|.| + var_floor``.
    Degenerate inits (zero positional encodings and relative-position
    tables, identity BN, symmetric PSN mixes, equal PLIF decays and GLIF
    gates, the constant ``logit_scale``) would hide wrong pairings in an
    A/B, so every entry of the state_dict is drawn."""
    for name, t in sorted(model.state_dict().items()):
        noise = torch.randn(t.shape, generator=generator, dtype=torch.float64,
                            device=generator.device)
        noise = noise.mul_(scale)
        if name.endswith("running_var"):
            noise = noise.abs_().add_(var_floor)
        t.copy_(noise.to(t.device, t.dtype))
    return model
