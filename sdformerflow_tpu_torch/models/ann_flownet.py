"""The ANN flow networks, mirrors of ``sdformerflow_tpu/models/
ann_flownet.py``: STTFlowNet (a Swin-3D encoder and a multi-res conv U-Net
decoder; ``STTFlowNet_4en`` is its 4-encoder variant) and MultiResUNet (a
plain conv U-Net).

Input: a signed voxel chunk ``[B, bins, H, W]``; output ``{"flow":
[coarse -> fine], "attn": None}``, each ``[B, 2, H, W]``.

Torch builds every parameter at construction, so what JAX derives from the
first input is fixed here from the config: the input size
(``swin.input_size``, padded to even as the forward pads) sets each
stage's effective window, and the input's bin count (``input_bins``)
selects STTFlowNet's input path and with it the number of time groups,
hence of ``proj{i}_{k}`` layers. An input of another bin count raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..ops.interpolate import resize_nearest
from ..ops.normalization import normalize_nonzero_std
from ..ops.pad import CropSize, skip_concat, skip_sum
from .ann_layers import (ConvLayer, ResidualBlock, TransposedConvLayer,
                         UpsampleConvLayer)
from .ann_patch_embed import ANN_PATCH_EMBEDS
from .ann_swin import LayerNorm, SwinStage
from .common import SwinConfig


class SwinTransformer3DBackbone(nn.Module):
    """Patch embed + Swin stages over ``[T, B, H, W, patch_t]`` time
    groups; returns the LayerNormed pre-merge features ``[B, T, H_i, W_i,
    C_i]`` of the stages in ``swin.out_indices``."""

    def __init__(self, swin: SwinConfig, embed_dim=96, num_groups=2):
        super().__init__()
        embed_cls = ANN_PATCH_EMBEDS[swin.patch_embed_type]
        self.patch_embed = embed_cls(
            img_size=tuple(swin.input_size), patch_size=tuple(swin.patch_size),
            embed_dim=embed_dim, num_groups=num_groups)
        self.out_indices = tuple(swin.out_indices)
        depths = swin.depths
        dpr = np.linspace(0, swin.drop_path_rate, sum(depths)).tolist()
        h, w = self.patch_embed.patches_resolution
        self.num_stages = len(depths)
        for i, depth in enumerate(depths):
            dim = int(embed_dim * 2 ** i)
            self.add_module(f"stage{i}", SwinStage(
                dim, depth, swin.num_heads[i], (num_groups, h, w),
                window_size=tuple(swin.window_size),
                mlp_ratio=swin.mlp_ratio, version=swin.arc_type,
                qk_scale=swin.qk_scale if swin.arc_type == "swinv1" else None,
                pretrained_window_size=tuple(swin.pretrained_window_size),
                drop_path_rates=tuple(
                    dpr[sum(depths[:i]):sum(depths[:i + 1])]),
                downsample=i < len(depths) - 1))
            if i in self.out_indices:
                self.add_module(f"norm{i}", LayerNorm(dim))
            h, w = (h + 1) // 2, (w + 1) // 2

    def forward(self, x):
        x = self.patch_embed(x)
        outs = []
        for i in range(self.num_stages):
            x, pre_merge = getattr(self, f"stage{i}")(x)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(pre_merge))
        return outs


class STTEncoder(nn.Module):
    """Backbone + per-stage, per-time-group Linear layers ``proj{i}_{k}``
    (C -> C / T) whose outputs are concatenated: [B, T, H, W, C] ->
    [B, H, W, C]."""

    def __init__(self, swin: SwinConfig, embed_dim=96, num_blocks=2):
        super().__init__()
        self.num_blocks = num_blocks
        self.swin3d = SwinTransformer3DBackbone(swin, embed_dim, num_blocks)
        self.out_channels = []
        for i, stage in enumerate(swin.out_indices):
            c = int(embed_dim * 2 ** stage)
            for k in range(num_blocks):
                self.add_module(f"proj{i}_{k}",
                                nn.Linear(c, c // num_blocks))
            self.out_channels.append(num_blocks * (c // num_blocks))

    def forward(self, x):
        outs = []
        for i, f in enumerate(self.swin3d(x)):
            if f.shape[1] != self.num_blocks:
                raise ValueError(f"{f.shape[1]} time groups, the encoder "
                                 f"was built for {self.num_blocks}")
            outs.append(torch.cat([getattr(self, f"proj{i}_{k}")(f[:, k])
                                   for k in range(self.num_blocks)], dim=-1))
        return outs


def _decoder_channels(base, num_encoders):
    """(decoder output channels) coarse -> fine, as the reference's
    BaseUNet builds them."""
    out_sizes = [int(base * 2 ** i) for i in range(num_encoders)]
    return list(reversed([base] + out_sizes[:-1]))


class _MultiResDecoder(nn.Module):
    """The residual bottleneck, decoders and prediction heads of both
    U-Nets, as children ``resblock{i}``, ``decoder{i}``, ``pred{i}`` of the
    U-Net itself (the flax tree's names)."""

    def _build_decoder(self, skip_channels, dec_out, *, num_residual_blocks,
                       num_output_channels, kernel_size, skip_type, norm,
                       use_upsample_conv, final_activation):
        n = len(skip_channels)
        self.num_encoders, self.num_residual_blocks = n, num_residual_blocks
        self.concat = skip_type == "concat"
        c = skip_channels[-1]
        for i in range(num_residual_blocks):
            self.add_module(f"resblock{i}", ResidualBlock(c, 1, "relu", norm))
        dec_cls = UpsampleConvLayer if use_upsample_conv \
            else TransposedConvLayer
        for i in range(n):
            if self.concat:
                c += skip_channels[n - i - 1]
                if i > 0:
                    c += num_output_channels
            self.add_module(f"decoder{i}", dec_cls(
                c, dec_out[i], kernel_size, activation="relu", norm=norm))
            self.add_module(f"pred{i}", ConvLayer(
                dec_out[i], num_output_channels, 1,
                activation=final_activation, norm=None))
            c = dec_out[i]

    def _decode(self, blocks):
        skip = skip_concat if self.concat else skip_sum
        x = blocks[-1]
        for i in range(self.num_residual_blocks):
            x = getattr(self, f"resblock{i}")(x)
        predictions = []
        for i in range(self.num_encoders):
            x = skip(x, blocks[self.num_encoders - i - 1], dim=-1)
            if i > 0:
                x = skip(predictions[-1], x, dim=-1)
            x = getattr(self, f"decoder{i}")(x)
            predictions.append(getattr(self, f"pred{i}")(x))
        return predictions


class STTMultiResUNet(_MultiResDecoder):
    """Swin encoder (``encoders``) + residual blocks + multi-res conv
    decoder; returns the predictions [B, h, w, 2], coarse -> fine."""

    def __init__(self, swin: SwinConfig, base_num_channels=96,
                 num_encoders=3, num_residual_blocks=2, num_output_channels=2,
                 kernel_size=3, skip_type="concat", norm=None,
                 use_upsample_conv=True, final_activation=None,
                 num_blocks=2):
        super().__init__()
        if len(swin.out_indices) != num_encoders:
            raise ValueError(f"{len(swin.out_indices)} encoder outputs for "
                             f"{num_encoders} encoders")
        self.encoders = STTEncoder(swin, base_num_channels, num_blocks)
        self._build_decoder(
            self.encoders.out_channels,
            _decoder_channels(base_num_channels, num_encoders),
            num_residual_blocks=num_residual_blocks,
            num_output_channels=num_output_channels, kernel_size=kernel_size,
            skip_type=skip_type, norm=norm,
            use_upsample_conv=use_upsample_conv,
            final_activation=final_activation)

    def forward(self, x):
        return self._decode(self.encoders(x))


class STTFlowNet(nn.Module):
    """The top-level ANN flow net (``STTFlowNet``: 3 encoders;
    ``STTFlowNet_4en``: 4).

    ``input_bins`` is the bin count of the chunks it will take: ``num_bins``
    (the chunk is split into ``num_bins / patch_t`` time groups) or
    ``2 * num_bins``, the two-window path (the last group of the first
    chunk as a reference frame, then the groups of the second chunk; each
    chunk standardized over its nonzero entries when ``norm_input``, over
    the whole batch: every rank's rows with a data-parallel ``group``, set
    by the steps). The standardization mixes the batch's rows in eval too:
    ``couples_rows``."""

    group = None

    def __init__(self, swin: SwinConfig, num_bins=20, base_num_channels=96,
                 kernel_size=3, num_encoders=3, use_upsample_conv=True,
                 norm: Optional[str] = None,
                 final_activation: Optional[str] = None,
                 norm_input: bool = False, encoding: str = "voxel",
                 input_bins: Optional[int] = None):
        super().__init__()
        patch_t = swin.patch_size[0]
        if num_bins % patch_t:
            raise ValueError(f"num_bins {num_bins} is not a multiple of the "
                             f"temporal patch {patch_t}")
        self.num_bins, self.norm_input = num_bins, norm_input
        self.encoding = encoding
        self.input_bins = num_bins if input_bins is None else input_bins
        if self.input_bins not in (num_bins, 2 * num_bins):
            raise ValueError(f"input_bins {self.input_bins}: STTFlowNet "
                             f"takes {num_bins} or {2 * num_bins} bins")
        self.num_split = num_bins // patch_t
        self.couples_rows = bool(norm_input) and self.input_bins != num_bins
        num_blocks = self.num_split + (self.input_bins != num_bins)
        h, w = swin.input_size
        crop = CropSize(w, h, {"h": 2, "w": 2})
        sw = swin.replace(input_size=(crop.height_crop, crop.width_crop))
        self.sttmultires_unet = STTMultiResUNet(
            sw, base_num_channels=base_num_channels,
            num_encoders=num_encoders, kernel_size=kernel_size, norm=norm,
            use_upsample_conv=use_upsample_conv,
            final_activation=final_activation, num_blocks=num_blocks)

    def forward(self, x):
        B, bins, H, Wd = x.shape
        if bins != self.input_bins:
            raise ValueError(f"STTFlowNet built for {self.input_bins}-bin "
                             f"chunks got {bins} bins")
        if bins != self.num_bins:
            chunk1, chunk2 = x[:, :self.num_bins], x[:, self.num_bins:]
            if self.norm_input:
                chunk1 = normalize_nonzero_std(chunk1, group=self.group)
                chunk2 = normalize_nonzero_std(chunk2, group=self.group)
            size = self.num_bins // self.num_split
            groups = [chunk1.split(size, dim=1)[-1]] \
                + list(chunk2.split(size, dim=1))
        else:
            groups = x.split(bins // self.num_split, dim=1)
        x = torch.stack(groups, dim=0).permute(0, 1, 3, 4, 2)
        crop = CropSize(Wd, H, {"h": 2, "w": 2})
        odd = bool(H % 2 or Wd % 2)
        if odd:
            x = crop.pad(x)
        flows = []
        for p in self.sttmultires_unet(x):
            flow = resize_nearest(p, (x.shape[2], x.shape[3]))
            if odd:
                flow = crop.crop(flow)
            flows.append(flow.permute(0, 3, 1, 2))
        return {"flow": flows, "attn": None}


class MultiResUNetFlow(_MultiResDecoder):
    """Plain conv multi-res U-Net with the flow output: stride-2 conv
    encoders ``encoder{i}``, a residual bottleneck, the multi-res
    prediction decoder; each prediction nearest-upsampled to the input."""

    def __init__(self, num_bins=10, base_num_channels=32, num_encoders=4,
                 num_residual_blocks=2, num_output_channels=2, kernel_size=5,
                 skip_type="concat", norm: Optional[str] = None,
                 use_upsample_conv=True,
                 final_activation: Optional[str] = None):
        super().__init__()
        self.num_bins = num_bins
        out_sizes = [int(base_num_channels * 2 ** (i + 1))
                     for i in range(num_encoders)]
        c = num_bins
        for i, out_size in enumerate(out_sizes):
            self.add_module(f"encoder{i}", ConvLayer(
                c, out_size, kernel_size, stride=2, activation="relu",
                norm=norm))
            c = out_size
        in_sizes = [int(base_num_channels * 2 ** i)
                    for i in range(num_encoders)]
        self._build_decoder(
            out_sizes, list(reversed(in_sizes)),
            num_residual_blocks=num_residual_blocks,
            num_output_channels=num_output_channels, kernel_size=kernel_size,
            skip_type=skip_type, norm=norm,
            use_upsample_conv=use_upsample_conv,
            final_activation=final_activation)

    def forward(self, x):
        B, bins, H, Wd = x.shape
        if bins != self.num_bins:
            raise ValueError(f"MultiResUNet built for {self.num_bins} bins "
                             f"got {bins}")
        x = x.permute(0, 2, 3, 1)
        blocks = []
        for i in range(self.num_encoders):
            x = getattr(self, f"encoder{i}")(x)
            blocks.append(x)
        return {"flow": [resize_nearest(p, (H, Wd)).permute(0, 3, 1, 2)
                         for p in self._decode(blocks)], "attn": None}
