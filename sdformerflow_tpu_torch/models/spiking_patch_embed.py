"""The flagship (en4) spiking patch embed, a mirror of
``sdformerflow_tpu/models/spiking_patch_embed.py``: ``sfn_regroup`` and
``MSPEDSpikingPatchEmbedConvSfn`` (its base branch; the s2d re-expressions
are not ported).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .common import SpikingConfig
from .spiking_layers import (MSSpikingConvEncoderLayer, SpikingConvEncoderLayer,
                             SpikingPEDLayer, SpikingResidualStack,
                             conv_output_size)


def sfn_regroup(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """[B, bins, 2, H, W] -> [T, B, H, W, num_ch], num_ch = 2 * bins // T:
    channel i is polarity i % 2 of bins (i // 2) * T .. (i // 2 + 1) * T."""
    B, bins, P, H, W = x.shape
    num_ch = bins * 2 // num_steps
    chans = [x[:, (i // 2) * num_steps:(i // 2 + 1) * num_steps, i % 2]
             for i in range(num_ch)]                 # [B, T, H, W] each
    return torch.stack(chans, dim=-1).permute(1, 0, 2, 3, 4)


class MSPEDSpikingPatchEmbedConvSfn(nn.Module):
    """sfn regroup -> SEW head -> MS conv /2 -> 2x MS resblocks -> PED
    projection /2; [B, bins, 2, H, W] -> [T, B, H/4, W/4, embed_dim]."""

    def __init__(self, img_size, patch_size=(1, 1, 2, 2), in_chans=10,
                 embed_dim=96, cfg: SpikingConfig = SpikingConfig(),
                 num_res=2):
        super().__init__()
        if cfg.s2d_embed or cfg.s2d_train:
            raise NotImplementedError("the s2d embed re-expressions are not "
                                      "ported")
        self.in_chans = in_chans
        self.num_steps = cfg.num_steps
        num_ch = in_chans * 2 // cfg.num_steps
        self.head = SpikingConvEncoderLayer(num_ch, embed_dim // 2, cfg,
                                            3, 1, 1)
        self.conv = MSSpikingConvEncoderLayer(embed_dim // 2, embed_dim, cfg,
                                              3, 2, 1, first_layer=True)
        self.residual_encoding = SpikingResidualStack(embed_dim, cfg, num_res)
        self.proj = SpikingPEDLayer(embed_dim, embed_dim, cfg,
                                    stride=tuple(patch_size[-2:]))
        h, w = (conv_output_size(n, 3, 2, 1) for n in img_size)
        self.patches_resolution = tuple(
            conv_output_size(n, 3, s, 1)
            for n, s in zip((h, w), patch_size[-2:]))

    def forward(self, x):
        x = sfn_regroup(x[:, :self.in_chans], self.num_steps)
        x = self.conv(self.head(x))
        return self.proj(self.residual_encoding(x))
