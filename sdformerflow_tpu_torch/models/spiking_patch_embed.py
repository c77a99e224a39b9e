"""The flagship (en4) spiking patch embed, a mirror of
``sdformerflow_tpu/models/spiking_patch_embed.py``: ``sfn_regroup`` and
``MSPEDSpikingPatchEmbedConvSfn`` with its base branch and its
``cfg.s2d_embed`` branch (the eval-only space-to-depth re-expression of the
full-resolution head, ``ops/s2d.py``; its weights come from
``training/s2d_embed.py``). The train-capable ``cfg.s2d_train`` form is not
ported.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.s2d import space_to_depth
from .common import SpikingConfig
from .spiking_layers import (Conv2d, MSSpikingConvEncoderLayer,
                             SpikingConvEncoderLayer, SpikingNorm,
                             SpikingPEDLayer, SpikingResidualStack,
                             conv_output_size, require_bn)


def sfn_regroup(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """[B, bins, 2, H, W] -> [T, B, H, W, num_ch], num_ch = 2 * bins // T:
    channel i is polarity i % 2 of bins (i // 2) * T .. (i // 2 + 1) * T."""
    B, bins, P, H, W = x.shape
    num_ch = bins * 2 // num_steps
    chans = [x[:, (i // 2) * num_steps:(i // 2 + 1) * num_steps, i % 2]
             for i in range(num_ch)]                 # [B, T, H, W] each
    return torch.stack(chans, dim=-1).permute(1, 0, 2, 3, 4)


class _S2DExitConvLayer(nn.Module):
    """Block-space exit of the embed's stride-2 MS conv (``cfg.s2d_embed``,
    the JAX module of the same name): a 2x2 stride-1 conv with asymmetric
    (1, 0) padding on the s2d tensor, emitting the half-resolution output in
    the normal layout, then BN - the exact image of the 3x3 stride-2 conv
    under ``ops/s2d.py:s2d_kernel_s2``. Child names match
    ``MSSpikingConvEncoderLayer`` (``conv``, ``norm``)."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig):
        super().__init__()
        require_bn(cfg)
        self.conv = Conv2d(in_channels, out_channels, 2, stride=1,
                           padding=0, bias=False)
        self.norm = SpikingNorm(out_channels)

    def forward(self, x):
        # channels-last [..., H, W, C]: one row on top, one column on the left
        return self.norm(self.conv(F.pad(x, (0, 0, 1, 0, 1, 0))))


class MSPEDSpikingPatchEmbedConvSfn(nn.Module):
    """sfn regroup -> SEW head -> MS conv /2 -> 2x MS resblocks -> PED
    projection /2; [B, bins, 2, H, W] -> [T, B, H/4, W/4, embed_dim].

    With ``cfg.s2d_embed`` the head and the MS conv run in 2x2 block space
    (head ``[4 * 48, 4 * ci, 3, 3]``, exit :class:`_S2DExitConvLayer`): eval
    only, on BN, with weights rearranged by ``training/s2d_embed.py``."""

    def __init__(self, img_size, patch_size=(1, 1, 2, 2), in_chans=10,
                 embed_dim=96, cfg: SpikingConfig = SpikingConfig(),
                 num_res=2):
        super().__init__()
        if cfg.s2d_train:
            raise NotImplementedError("cfg.s2d_train (the train-capable s2d "
                                      "embed) is not ported")
        self.in_chans = in_chans
        self.num_steps = cfg.num_steps
        self.s2d = cfg.s2d_embed
        num_ch = in_chans * 2 // cfg.num_steps
        if self.s2d:
            self.head = SpikingConvEncoderLayer(4 * num_ch,
                                                4 * (embed_dim // 2), cfg,
                                                3, 1, 1)
            self.conv = _S2DExitConvLayer(4 * (embed_dim // 2), embed_dim,
                                         cfg)
        else:
            self.head = SpikingConvEncoderLayer(num_ch, embed_dim // 2, cfg,
                                                3, 1, 1)
            self.conv = MSSpikingConvEncoderLayer(embed_dim // 2, embed_dim,
                                                  cfg, 3, 2, 1,
                                                  first_layer=True)
        self.residual_encoding = SpikingResidualStack(embed_dim, cfg, num_res)
        self.proj = SpikingPEDLayer(embed_dim, embed_dim, cfg,
                                    stride=tuple(patch_size[-2:]))
        h, w = (conv_output_size(n, 3, 2, 1) for n in img_size)
        self.patches_resolution = tuple(
            conv_output_size(n, 3, s, 1)
            for n, s in zip((h, w), patch_size[-2:]))

    def forward(self, x):
        x = sfn_regroup(x[:, :self.in_chans], self.num_steps)
        if self.s2d:
            if self.training:
                raise ValueError("cfg.s2d_embed is inference-only (train-mode"
                                 " BN statistics would be per block-channel)")
            x = space_to_depth(x)
        x = self.conv(self.head(x))
        return self.proj(self.residual_encoding(x))
