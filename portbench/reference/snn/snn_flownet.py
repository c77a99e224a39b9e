"""Spiking Swin-3D backbone, the spikeformer multi-res U-Net, the top-level
SDformerFlow networks and the plain spiking U-Net: a mirror of
``sdformerflow_tpu/models/snn_flownet.py``.

Input: per-polarity voxel chunk ``[B, bins, 2, H, W]`` (see
``ops.normalization.encode_input``). Output: ``{"flow": [coarse -> fine],
"attn": None}``, each flow ``[B, 2, H, W]``: spikes summed over T, then
nearest-upsampled to the input resolution. The spikeformer networks take
``log=True`` (JAX ``snn_flownet.py:146-192,212-239``): ``"attn"`` is then
the list of each stage's attention map (``models/spiking_swin.py``,
``SpikingSwinStage(collect_attention=True)``).
"""

from __future__ import annotations

import numpy as np
import torch.nn as nn

from .interpolate import resize_nearest
from .pad import skip_concat, skip_sum
from .common import SpikingConfig, SwinConfig
from .spiking_layers import (MSResBlock, MSSpikingConvEncoderLayer,
                             MSSpikingDecoderLayer, MSSpikingPredLayer,
                             MSSpikingTransposeDecoderLayer, SEWResBlock,
                             SpikingConvEncoderLayer, SpikingDecoderLayer,
                             SpikingNorm, SpikingPredLayer,
                             SpikingTransposeDecoderLayer)
from .spiking_patch_embed import (MSPEDSpikingPatchEmbedConvSfn,
                                  MSSpikingPatchEmbedConvLocal,
                                  SpikingPatchEmbedConv,
                                  SpikingPatchEmbedConvSfn,
                                  SpikingPatchEmbedLocal,
                                  SpikingPatchEmbedSfn, chunk_regroup,
                                  sfn_regroup)
from .spiking_swin import SpikingSwinStage


def _ms(cls, use_ms):
    return lambda **kw: cls(use_ms=use_ms, **kw)


PATCH_EMBEDS = {
    "Spiking_PatchEmbedLocal": _ms(SpikingPatchEmbedLocal, False),
    "MS_Spiking_PatchEmbedLocal": _ms(SpikingPatchEmbedLocal, True),
    "Spiking_PatchEmbed_sfn": _ms(SpikingPatchEmbedSfn, False),
    "MS_Spiking_PatchEmbed_sfn": _ms(SpikingPatchEmbedSfn, True),
    "Spiking_PatchEmbed_Conv": _ms(SpikingPatchEmbedConv, False),
    "MS_Spiking_PatchEmbed_Conv": _ms(SpikingPatchEmbedConv, True),
    "Spiking_PatchEmbed_Conv_sfn": _ms(SpikingPatchEmbedConvSfn, False),
    "MS_Spiking_PatchEmbed_Conv_sfn": _ms(SpikingPatchEmbedConvSfn, True),
    "MS_Spiking_PatchEmbed_Conv_Local": MSSpikingPatchEmbedConvLocal,
    "MS_PED_Spiking_PatchEmbed_Conv_sfn": MSPEDSpikingPatchEmbedConvSfn,
}


class SpikingSwinTransformer3D(nn.Module):
    """Patch embed + spiking Swin stages; returns the time-major pre-merge
    features ``[T, B, H_i, W_i, C_i]`` of the stages in ``out_indices``,
    each through its LN / GN ``norm{i}`` where the norm is one of those."""

    def __init__(self, swin: SwinConfig, cfg: SpikingConfig, in_chans=10,
                 embed_dim=96, spikformer_norm="BN", ms=True):
        super().__init__()
        if swin.patch_embed_type not in PATCH_EMBEDS:
            raise KeyError(f"unknown patch embed {swin.patch_embed_type!r}; "
                           f"available: {sorted(PATCH_EMBEDS)}")
        self.patch_embed = PATCH_EMBEDS[swin.patch_embed_type](
            img_size=tuple(swin.input_size), patch_size=tuple(swin.patch_size),
            in_chans=in_chans, embed_dim=embed_dim, cfg=cfg)
        self.num_stages = len(swin.depths)
        self.out_indices = tuple(swin.out_indices)
        h, w = self.patch_embed.patches_resolution
        D = self.patch_embed.out_steps
        depths = swin.depths
        dpr = np.linspace(0, swin.drop_path_rate, sum(depths)).tolist()
        for i, depth in enumerate(depths):
            dim = embed_dim * 2 ** i
            self.add_module(f"stage{i}", SpikingSwinStage(
                dim=dim, depth=depth, num_heads=swin.num_heads[i], cfg=cfg,
                input_resolution=(D, h, w),
                window_size=tuple(swin.window_size),
                mlp_ratio=swin.mlp_ratio, version=swin.arc_type,
                qk_scale=swin.qk_scale,
                pretrained_window_size=tuple(swin.pretrained_window_size),
                norm=spikformer_norm,
                drop_path_rates=tuple(
                    dpr[sum(depths[:i]):sum(depths[:i + 1])]),
                downsample=i < len(depths) - 1, ms=ms))
            if i in self.out_indices and spikformer_norm in ("LN", "GN"):
                self.add_module(f"norm{i}", SpikingNorm(
                    dim, spikformer_norm, cfg.num_steps, cfg.v_th))
            h, w = -(-h // 2), -(-w // 2)  # merge pads odd sizes

    def forward(self, x, pre_embedded: bool = False,
                collect_attention: bool = False):
        """The stages' outputs; with ``collect_attention`` also the list of
        each stage's attention map."""
        if not pre_embedded:   # else x is already the embed's output
            x = self.patch_embed(x)
        outs, attns = [], []
        for i in range(self.num_stages):
            stage = getattr(self, f"stage{i}")
            if collect_attention:
                x, pre_merge, attn = stage(x, collect_attention=True)
                attns.append(attn)
            else:
                x, pre_merge = stage(x)
            if i in self.out_indices:
                norm = getattr(self, f"norm{i}", None)
                outs.append(pre_merge if norm is None else norm(pre_merge))
        if collect_attention:
            return outs, attns
        return outs


def _decoder_classes(ms: bool, use_upsample_conv: bool):
    """(decoder, prediction head) classes of a U-Net."""
    if use_upsample_conv:
        dec = MSSpikingDecoderLayer if ms else SpikingDecoderLayer
    else:
        dec = MSSpikingTransposeDecoderLayer if ms \
            else SpikingTransposeDecoderLayer
    return dec, (MSSpikingPredLayer if ms else SpikingPredLayer)


class _SpikingDecoder(nn.Module):
    """The U-Nets' common tail: ``resblock{i}`` on the deepest block, then
    per scale the skip join of the block (and, from the second scale, of
    the previous prediction), ``decoder{i}`` and ``pred{i}``. Channel plan:
    decoder outputs ``reversed(in_sizes)``."""

    def _build_decoder(self, cfg, block_channels, in_sizes,
                       num_residual_blocks, num_output_channels, kernel_size,
                       skip_type, use_upsample_conv, ms):
        self.num_encoders = len(block_channels)
        self.num_residual_blocks = num_residual_blocks
        self.skip = skip_concat if skip_type == "concat" else skip_sum
        res_cls = MSResBlock if ms else SEWResBlock
        dec_cls, pred_cls = _decoder_classes(ms, use_upsample_conv)
        x_ch = block_channels[-1]
        for i in range(num_residual_blocks):
            self.add_module(f"resblock{i}", res_cls(x_ch, cfg))
        n = self.num_encoders
        decoder_out = list(reversed(in_sizes))
        for i in range(n):
            in_ch = x_ch
            if skip_type == "concat":
                in_ch += block_channels[n - i - 1]
                if i > 0:
                    in_ch += num_output_channels
            self.add_module(f"decoder{i}", dec_cls(
                in_ch, decoder_out[i], cfg, kernel_size))
            self.add_module(f"pred{i}", pred_cls(
                decoder_out[i], num_output_channels, cfg, 1))
            x_ch = decoder_out[i]

    def _decode(self, blocks):
        x = blocks[-1]
        for i in range(self.num_residual_blocks):
            x = getattr(self, f"resblock{i}")(x)
        n = self.num_encoders
        predictions = []
        for i in range(n):
            x = self.skip(x, blocks[n - i - 1])
            if i > 0:
                x = self.skip(predictions[-1], x)
            x = getattr(self, f"decoder{i}")(x)
            predictions.append(getattr(self, f"pred{i}")(x))
        return predictions


def _flows(preds, hw):
    """Per-scale predictions [T, B, h, w, 2] -> flows [B, 2, H, W]."""
    return [resize_nearest(p.sum(dim=0), hw).permute(0, 3, 1, 2)
            for p in preds]


class SpikingformerMultiResUNet(_SpikingDecoder):
    """Spikeformer encoder + spiking conv multi-res decoder; returns the
    per-scale predictions ``[T, B, h_i, w_i, 2]`` (coarse -> fine)."""

    def __init__(self, swin: SwinConfig, cfg: SpikingConfig, num_bins=10,
                 base_num_channels=96, num_encoders=4, num_residual_blocks=2,
                 num_output_channels=2, kernel_size=3, skip_type="concat",
                 use_upsample_conv=False, ms=True):
        super().__init__()
        if len(swin.out_indices) != num_encoders:
            raise ValueError("the backbone needs one output per encoder")
        self.encoders = SpikingSwinTransformer3D(
            swin, cfg, in_chans=num_bins, embed_dim=base_num_channels,
            spikformer_norm=cfg.spike_norm, ms=ms)
        out_sizes = [base_num_channels * 2 ** i for i in range(num_encoders)]
        self._build_decoder(
            cfg, [base_num_channels * 2 ** i for i in swin.out_indices],
            [base_num_channels] + out_sizes[:-1], num_residual_blocks,
            num_output_channels, kernel_size, skip_type, use_upsample_conv,
            ms)

    def forward(self, x, pre_embedded: bool = False, log: bool = False):
        """The predictions; with ``log`` also the stages' attention
        maps."""
        if not log:
            return self._decode(self.encoders(x, pre_embedded))
        blocks, attns = self.encoders(x, pre_embedded,
                                      collect_attention=True)
        return self._decode(blocks), attns


class SpikingformerFlowNet(nn.Module):
    """SDformerFlow: U-Net predictions summed over T and nearest-upsampled
    to the input resolution. Registry names SpikingformerFlowNet (SEW, 3
    encoders), MS_SpikingformerFlowNet (MS, 3) and
    MS_SpikingformerFlowNet_en4 (MS, 4: the paper's SDformerFlow)."""

    def __init__(self, swin: SwinConfig, cfg: SpikingConfig, num_bins=10,
                 base_num_channels=96, kernel_size=3, num_encoders=4,
                 use_upsample_conv=False, ms=True):
        super().__init__()
        self.cfg = cfg
        self.sttmultires_unet = SpikingformerMultiResUNet(
            swin, cfg, num_bins=num_bins, base_num_channels=base_num_channels,
            num_encoders=num_encoders, kernel_size=kernel_size,
            use_upsample_conv=use_upsample_conv, ms=ms)

    def forward(self, x, pre_embedded=None, log: bool = False):
        """``x`` [B, bins, 2, H, W]; ``pre_embedded``, if given, is the patch
        embed's output [T, B, H/4, W/4, C] computed elsewhere
        (``ops/hopper_embed.py:fused_embed_forward``), and ``x`` then only
        sets the output resolution. ``log``: ``"attn"`` holds the stages'
        attention maps."""
        out = (self.sttmultires_unet(x, log=log) if pre_embedded is None
               else self.sttmultires_unet(pre_embedded, True, log=log))
        preds, attns = out if log else (out, None)
        return {"flow": _flows(preds, tuple(x.shape[-2:])), "attn": attns}


class SpikingMultiResUNetFlow(_SpikingDecoder):
    """The plain spiking U-Net (stride-2 conv encoders, no transformer; the
    reference's SpikingMultiResUNet) with the flow-output contract; the
    input regrouped by ``sfn_regroup`` (``input_sfn``) or
    ``chunk_regroup``."""

    def __init__(self, cfg: SpikingConfig, num_bins=10, base_num_channels=32,
                 num_encoders=4, num_residual_blocks=2, num_output_channels=2,
                 kernel_size=5, skip_type="concat", use_upsample_conv=True,
                 input_sfn=True, ms=False):
        super().__init__()
        self.cfg = cfg
        self.num_bins, self.input_sfn = num_bins, input_sfn
        out_sizes = [base_num_channels * 2 ** (i + 1)
                     for i in range(num_encoders)]
        in_sizes = [base_num_channels * 2 ** i for i in range(num_encoders)]
        ch = 2 * num_bins // cfg.num_steps
        for i, out_size in enumerate(out_sizes):
            if ms:
                enc = MSSpikingConvEncoderLayer(ch, out_size, cfg,
                                                kernel_size, 2,
                                                kernel_size // 2,
                                                first_layer=i == 0)
            else:
                enc = SpikingConvEncoderLayer(ch, out_size, cfg, kernel_size,
                                              2, kernel_size // 2)
            self.add_module(f"encoder{i}", enc)
            ch = out_size
        self._build_decoder(cfg, out_sizes, in_sizes, num_residual_blocks,
                            num_output_channels, kernel_size, skip_type,
                            use_upsample_conv, ms)

    def forward(self, x):
        hw = tuple(x.shape[-2:])
        regroup = sfn_regroup if self.input_sfn else chunk_regroup
        x = regroup(x[:, :self.num_bins], self.cfg.num_steps)
        blocks = []
        for i in range(self.num_encoders):
            x = getattr(self, f"encoder{i}")(x)
            blocks.append(x)
        return {"flow": _flows(self._decode(blocks), hw), "attn": None}
