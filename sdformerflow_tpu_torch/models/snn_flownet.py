"""Spiking Swin-3D backbone, spikeformer multi-res U-Net and the top-level
SDformerFlow network: the MS / transpose-decoder subset of
``sdformerflow_tpu/models/snn_flownet.py``.

Input: per-polarity voxel chunk ``[B, bins, 2, H, W]`` (see
``ops.normalization.encode_input``). Output: ``{"flow": [coarse -> fine],
"attn": None}``, each flow ``[B, 2, H, W]``: spikes summed over T, then
nearest-upsampled to the input resolution.
"""

from __future__ import annotations

import numpy as np
import torch.nn as nn

from ..ops.interpolate import resize_nearest
from ..ops.pad import skip_concat
from .common import SpikingConfig, SwinConfig
from .spiking_layers import (MSResBlock, MSSpikingPredLayer,
                             MSSpikingTransposeDecoderLayer)
from .spiking_patch_embed import MSPEDSpikingPatchEmbedConvSfn
from .spiking_swin import SpikingSwinStage


class SpikingSwinTransformer3D(nn.Module):
    """Patch embed + spiking Swin stages; returns the per-stage time-major
    pre-merge features ``[T, B, H_i, W_i, C_i]``."""

    def __init__(self, swin: SwinConfig, cfg: SpikingConfig, in_chans=10,
                 embed_dim=96):
        super().__init__()
        if swin.patch_embed_type != "MS_PED_Spiking_PatchEmbed_Conv_sfn":
            raise NotImplementedError(
                f"patch embed {swin.patch_embed_type!r} is not ported")
        if tuple(swin.out_indices) != tuple(range(len(swin.depths))):
            raise NotImplementedError("only out_indices = every stage is "
                                      "ported")
        self.patch_embed = MSPEDSpikingPatchEmbedConvSfn(
            img_size=tuple(swin.input_size), patch_size=tuple(swin.patch_size),
            in_chans=in_chans, embed_dim=embed_dim, cfg=cfg)
        self.num_stages = len(swin.depths)
        h, w = self.patch_embed.patches_resolution
        depths = swin.depths
        dpr = np.linspace(0, swin.drop_path_rate, sum(depths)).tolist()
        for i, depth in enumerate(depths):
            self.add_module(f"stage{i}", SpikingSwinStage(
                dim=embed_dim * 2 ** i, depth=depth,
                num_heads=swin.num_heads[i], cfg=cfg,
                input_resolution=(cfg.num_steps, h, w),
                window_size=tuple(swin.window_size),
                mlp_ratio=swin.mlp_ratio,
                drop_path_rates=tuple(
                    dpr[sum(depths[:i]):sum(depths[:i + 1])]),
                downsample=i < len(depths) - 1))
            h, w = -(-h // 2), -(-w // 2)  # merge pads odd sizes

    def forward(self, x, pre_embedded: bool = False):
        if not pre_embedded:   # else x is already the embed's output
            x = self.patch_embed(x)
        outs = []
        for i in range(self.num_stages):
            x, pre_merge = getattr(self, f"stage{i}")(x)
            outs.append(pre_merge)
        return outs


class SpikingformerMultiResUNet(nn.Module):
    """Spikeformer encoder + MS transpose-conv decoder; returns the per-scale
    predictions ``[T, B, h_i, w_i, 2]`` (coarse -> fine)."""

    def __init__(self, swin: SwinConfig, cfg: SpikingConfig, num_bins=10,
                 base_num_channels=96, num_encoders=4, num_residual_blocks=2,
                 num_output_channels=2, kernel_size=3):
        super().__init__()
        if len(swin.depths) != num_encoders:
            raise ValueError("the backbone needs one stage per encoder")
        self.num_encoders = num_encoders
        self.num_residual_blocks = num_residual_blocks
        self.encoders = SpikingSwinTransformer3D(
            swin, cfg, in_chans=num_bins, embed_dim=base_num_channels)
        out_sizes = [base_num_channels * 2 ** i for i in range(num_encoders)]
        for i in range(num_residual_blocks):
            self.add_module(f"resblock{i}", MSResBlock(out_sizes[-1], cfg))
        # decoder channel plan: outputs [base*2^(n-2), ..., base, base]; the
        # input is the skip concat (+ the previous prediction from i = 1)
        decoder_out = list(reversed([base_num_channels] + out_sizes[:-1]))
        x_ch = out_sizes[-1]
        for i in range(num_encoders):
            in_ch = x_ch + out_sizes[num_encoders - i - 1]
            if i > 0:
                in_ch += num_output_channels
            self.add_module(f"decoder{i}", MSSpikingTransposeDecoderLayer(
                in_ch, decoder_out[i], cfg, kernel_size))
            self.add_module(f"pred{i}", MSSpikingPredLayer(
                decoder_out[i], num_output_channels, cfg, 1))
            x_ch = decoder_out[i]

    def forward(self, x, pre_embedded: bool = False):
        blocks = self.encoders(x, pre_embedded)
        x = blocks[-1]
        for i in range(self.num_residual_blocks):
            x = getattr(self, f"resblock{i}")(x)
        predictions = []
        for i in range(self.num_encoders):
            x = skip_concat(x, blocks[self.num_encoders - i - 1])
            if i > 0:
                x = skip_concat(predictions[-1], x)
            x = getattr(self, f"decoder{i}")(x)
            predictions.append(getattr(self, f"pred{i}")(x))
        return predictions


class SpikingformerFlowNet(nn.Module):
    """SDformerFlow: U-Net predictions summed over T and nearest-upsampled
    to the input resolution. Registry name MS_SpikingformerFlowNet_en4 (MS,
    4 encoders, transpose-conv decoders)."""

    def __init__(self, swin: SwinConfig, cfg: SpikingConfig, num_bins=10,
                 base_num_channels=96, kernel_size=3, num_encoders=4,
                 use_upsample_conv=False, ms=True):
        super().__init__()
        if not ms or use_upsample_conv:
            raise NotImplementedError("only the MS transpose-decoder "
                                      "SDformerFlow is ported")
        self.cfg = cfg
        self.sttmultires_unet = SpikingformerMultiResUNet(
            swin, cfg, num_bins=num_bins, base_num_channels=base_num_channels,
            num_encoders=num_encoders, kernel_size=kernel_size)

    def forward(self, x, pre_embedded=None):
        """``x`` [B, bins, 2, H, W]; ``pre_embedded``, if given, is the patch
        embed's output [T, B, H/4, W/4, C] computed elsewhere
        (``ops/hopper_embed.py:fused_embed_forward``), and ``x`` then only
        sets the output resolution."""
        H, W = x.shape[-2:]
        preds = (self.sttmultires_unet(x) if pre_embedded is None
                 else self.sttmultires_unet(pre_embedded, True))
        flows = [resize_nearest(p.sum(dim=0), (H, W)).permute(0, 3, 1, 2)
                 for p in preds]
        return {"flow": flows, "attn": None}
