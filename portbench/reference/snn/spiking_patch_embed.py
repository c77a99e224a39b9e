"""The spiking patch embeds, mirrors of
``sdformerflow_tpu/models/spiking_patch_embed.py``: event voxels
``[B, bins, 2, H, W]`` -> time-major spikes ``[T, B, H', W', C]``.

Two regroupings turn the bin / polarity axes into the time axis:
``sfn_regroup`` (channel i is polarity i % 2 of bins (i // 2) * T ..
(i // 2 + 1) * T) and ``chunk_regroup`` (the flattened (bin, polarity)
pairs cut into T groups of channels). The ten ``PATCH_EMBEDS`` names of
``models/snn_flownet.py`` build these classes:

- :class:`MSPEDSpikingPatchEmbedConvSfn` (the en4 flagship) with its base
  branch, its ``cfg.s2d_embed`` branch (the eval-only space-to-depth
  re-expression of the full-resolution head, ``ops/s2d.py``; its weights
  come from ``training/s2d_embed.py``) and its ``cfg.s2d_train`` branch
  (the same re-expression in both modes on reference-shaped parameters,
  JAX ``spiking_patch_embed.py:189-341,364-378``);
- :class:`SpikingPatchEmbedConvSfn`, :class:`SpikingPatchEmbedSfn`,
  :class:`SpikingPatchEmbedConv` and :class:`SpikingPatchEmbedLocal`, each
  SEW or MS (``use_ms``), and :class:`MSSpikingPatchEmbedConvLocal`.

Each embed has ``patches_resolution`` (its output's H', W', from the conv
geometry) and ``out_steps`` (its output's time axis: T, or the number of
temporal blocks of :class:`MSSpikingPatchEmbedConvLocal`), which the swin
stages are built for. The embeds whose full-resolution head is followed by
a stride-2 conv compute that part in :meth:`band` (its children ``head``
and ``conv``), which ``training/remat.py`` checkpoints as one region so
that no full-resolution activation is kept for the backward.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .s2d import s2d_kernel_s1, s2d_kernel_s2, space_to_depth, tile4
from .common import SpikingConfig
from .spiking_layers import (Conv2d, MSSpikingConvEncoderLayer,
                             SpikingConvEncoderLayer, SpikingEmbeddingLayer,
                             SpikingNeuron, SpikingPEDLayer,
                             SpikingResidualStack, TorchBatchNorm,
                             _channels_last, conv_output_size, norm_is_folded,
                             norm_spike, spiking_norm, unnormed)


def sfn_regroup(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """[B, bins, 2, H, W] -> [T, B, H, W, num_ch], num_ch = 2 * bins // T:
    channel i is polarity i % 2 of bins (i // 2) * T .. (i // 2 + 1) * T."""
    B, bins, P, H, W = x.shape
    num_ch = bins * 2 // num_steps
    chans = [x[:, (i // 2) * num_steps:(i // 2 + 1) * num_steps, i % 2]
             for i in range(num_ch)]                 # [B, T, H, W] each
    return torch.stack(chans, dim=-1).permute(1, 0, 2, 3, 4)


def chunk_regroup(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """[B, bins, 2, H, W] -> [T, B, H, W, 2 * bins // T]: consecutive
    (bin, polarity) pairs as the channels of each step."""
    B, bins, P, H, W = x.shape
    x = x.reshape(B, num_steps, bins * P // num_steps, H, W)
    return x.permute(1, 0, 3, 4, 2)


def _out_size(img_size, strides):
    """H', W' after 3x3 padding-1 convs of ``strides`` in turn."""
    hw = tuple(img_size)
    for s in strides:
        hw = tuple(conv_output_size(n, 3, t, 1) for n, t in zip(hw, s))
    return hw


def _head_or_ms(in_ch, out_ch, cfg, stride, use_ms):
    """An MS first layer (no input spike) or a SEW conv layer."""
    if use_ms:
        return MSSpikingConvEncoderLayer(in_ch, out_ch, cfg, 3, stride, 1,
                                         first_layer=True)
    return SpikingConvEncoderLayer(in_ch, out_ch, cfg, 3, stride, 1)


class SpikingPatchEmbedLocal(nn.Module):
    """The "Local" embed: head at stride 1 and full width -> 4 residual
    blocks -> the spiking projection at the patch stride (JAX
    ``spiking_patch_embed.py:56-122``). The input's (bin, polarity) pairs
    are chunked onto T steps at the reference head width
    ``in_chans * 2 // (T - 1)``. ``spiking_proj=False`` takes JAX's form
    of the reference's unreachable plain-conv branch: ``proj`` is one 3x3
    conv (patch stride, padding 1, bias) applied to each of the T steps."""

    def __init__(self, img_size, patch_size=(1, 1, 2, 2), in_chans=10,
                 embed_dim=96, cfg: SpikingConfig = SpikingConfig(),
                 use_ms=False, num_res=4, spiking_proj=True):
        super().__init__()
        self.in_chans, self.num_steps = in_chans, cfg.num_steps
        self.out_steps = cfg.num_steps
        self.head_in = max(in_chans * 2 // max(cfg.num_steps - 1, 1), 1)
        self.head = _head_or_ms(self.head_in, embed_dim, cfg, 1, use_ms)
        self.residual_encoding = SpikingResidualStack(embed_dim, cfg,
                                                      num_res, use_ms)
        if spiking_proj:
            self.proj = SpikingEmbeddingLayer(embed_dim, embed_dim, cfg,
                                              stride=tuple(patch_size[-2:]),
                                              use_ms=use_ms)
        else:
            self.proj = Conv2d(embed_dim, embed_dim, 3,
                               stride=tuple(patch_size[-2:]), padding=1)
        self.patches_resolution = _out_size(img_size, [patch_size[-2:]])

    def forward(self, x):
        x = x[:, :self.in_chans]
        T, c = self.num_steps, self.head_in
        B, bins, P, H, W = x.shape
        flat = x.reshape(B, bins * P, H, W)[:, :T * c]
        xt = flat.reshape(B, T, c, H, W).permute(1, 0, 3, 4, 2)
        return self.proj(self.residual_encoding(self.head(xt)))


class SpikingPatchEmbedConvSfn(nn.Module):
    """sfn regroup -> SEW head -> MS or SEW conv /2 -> residual blocks ->
    embedding projection /patch (JAX ``spiking_patch_embed.py:124-161``)."""

    def __init__(self, img_size, patch_size=(1, 1, 2, 2), in_chans=10,
                 embed_dim=96, cfg: SpikingConfig = SpikingConfig(),
                 use_ms=False, num_res=2):
        super().__init__()
        self.in_chans, self.num_steps = in_chans, cfg.num_steps
        self.out_steps = cfg.num_steps
        num_ch = in_chans * 2 // cfg.num_steps
        self.head = SpikingConvEncoderLayer(num_ch, embed_dim // 2, cfg,
                                            3, 1, 1)
        self.conv = _head_or_ms(embed_dim // 2, embed_dim, cfg, 2, use_ms)
        self.residual_encoding = SpikingResidualStack(embed_dim, cfg,
                                                      num_res, use_ms)
        self.proj = SpikingEmbeddingLayer(embed_dim, embed_dim, cfg,
                                          stride=tuple(patch_size[-2:]),
                                          use_ms=use_ms)
        self.patches_resolution = _out_size(img_size,
                                            [(2, 2), patch_size[-2:]])

    def band(self, x):
        """The full-resolution band: regroup -> head -> conv /2."""
        x = sfn_regroup(x[:, :self.in_chans], self.num_steps)
        return self.conv(self.head(x))

    def forward(self, x):
        return self.proj(self.residual_encoding(self.band(x)))


class SpikingPatchEmbedSfn(nn.Module):
    """sfn regroup -> head (stride 1, full width; MS or SEW) -> residual
    blocks -> embedding projection (JAX ``spiking_patch_embed.py:412-447``)."""

    def __init__(self, img_size, patch_size=(1, 1, 2, 2), in_chans=10,
                 embed_dim=96, cfg: SpikingConfig = SpikingConfig(),
                 use_ms=False, num_res=2):
        super().__init__()
        self.in_chans, self.num_steps = in_chans, cfg.num_steps
        self.out_steps = cfg.num_steps
        num_ch = in_chans * 2 // cfg.num_steps
        self.head = _head_or_ms(num_ch, embed_dim, cfg, 1, use_ms)
        self.residual_encoding = SpikingResidualStack(embed_dim, cfg,
                                                      num_res, use_ms)
        self.proj = SpikingEmbeddingLayer(embed_dim, embed_dim, cfg,
                                          stride=tuple(patch_size[-2:]),
                                          use_ms=use_ms)
        self.patches_resolution = _out_size(img_size, [patch_size[-2:]])

    def forward(self, x):
        x = sfn_regroup(x[:, :self.in_chans], self.num_steps)
        return self.proj(self.residual_encoding(self.head(x)))


class SpikingPatchEmbedConv(nn.Module):
    """chunk regroup -> SEW head -> MS or SEW conv /2 -> residual blocks (4
    MS, 2 SEW) -> embedding projection (JAX
    ``spiking_patch_embed.py:450-488``)."""

    def __init__(self, img_size, patch_size=(1, 1, 2, 2), in_chans=10,
                 embed_dim=96, cfg: SpikingConfig = SpikingConfig(),
                 use_ms=False):
        super().__init__()
        self.in_chans, self.num_steps = in_chans, cfg.num_steps
        self.out_steps = cfg.num_steps
        num_ch = in_chans * 2 // cfg.num_steps
        self.head = SpikingConvEncoderLayer(num_ch, embed_dim // 2, cfg,
                                            3, 1, 1)
        self.conv = _head_or_ms(embed_dim // 2, embed_dim, cfg, 2, use_ms)
        self.residual_encoding = SpikingResidualStack(
            embed_dim, cfg, 4 if use_ms else 2, use_ms)
        self.proj = SpikingEmbeddingLayer(embed_dim, embed_dim, cfg,
                                          stride=tuple(patch_size[-2:]),
                                          use_ms=use_ms)
        self.patches_resolution = _out_size(img_size,
                                            [(2, 2), patch_size[-2:]])

    def band(self, x):
        """The full-resolution band: regroup -> head -> conv /2."""
        x = chunk_regroup(x[:, :self.in_chans], self.num_steps)
        return self.conv(self.head(x))

    def forward(self, x):
        return self.proj(self.residual_encoding(self.band(x)))


class MSSpikingPatchEmbedConvLocal(nn.Module):
    """Per temporal block: the bins cut into ``in_chans // T`` groups of
    [T, B, H, W, 2], each through one shared SEW head -> MS conv /2 -> MS
    residual blocks -> MS projection, summed over its T; the groups stack
    on the output's time axis (JAX ``spiking_patch_embed.py:491-529``), so
    ``out_steps`` is the number of groups."""

    def __init__(self, img_size, patch_size=(1, 1, 2, 2), in_chans=10,
                 embed_dim=96, cfg: SpikingConfig = SpikingConfig(),
                 num_res=2):
        super().__init__()
        self.in_chans, self.num_steps = in_chans, cfg.num_steps
        self.out_steps = in_chans // cfg.num_steps
        self.head = SpikingConvEncoderLayer(2, embed_dim // 2, cfg, 3, 1, 1)
        self.conv = _head_or_ms(embed_dim // 2, embed_dim, cfg, 2, True)
        self.residual_encoding = SpikingResidualStack(embed_dim, cfg,
                                                      num_res, True)
        self.proj = SpikingEmbeddingLayer(embed_dim, embed_dim, cfg,
                                          stride=tuple(patch_size[-2:]),
                                          use_ms=True)
        self.patches_resolution = _out_size(img_size,
                                            [(2, 2), patch_size[-2:]])

    def forward(self, x):
        x = x[:, :self.in_chans]
        T = self.num_steps
        outs = []
        for i in range(self.out_steps):
            xi = x[:, i * T:(i + 1) * T].permute(1, 0, 3, 4, 2)
            xi = self.proj(self.residual_encoding(self.conv(self.head(xi))))
            outs.append(xi.sum(dim=0))     # collapse the block's own T
        return torch.stack(outs)


class _S2DExitConvLayer(nn.Module):
    """Block-space exit of the embed's stride-2 MS conv (``cfg.s2d_embed``,
    the JAX module of the same name): a 2x2 stride-1 conv with asymmetric
    (1, 0) padding on the s2d tensor, emitting the half-resolution output in
    the normal layout, then BN - the exact image of the 3x3 stride-2 conv
    under ``ops/s2d.py:s2d_kernel_s2``. Child names match
    ``MSSpikingConvEncoderLayer`` (``conv``, ``norm``)."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig):
        super().__init__()
        self.norm = spiking_norm(out_channels, cfg)
        self.conv = Conv2d(in_channels, out_channels, 2, stride=1,
                           padding=0, bias=unnormed(self.norm))

    def forward(self, x):
        # channels-last [..., H, W, C]: one row on top, one column on the left
        return self.norm(self.conv(F.pad(x, (0, 0, 1, 0, 1, 0))))


class _S2DConv(Conv2d):
    """A conv with the REFERENCE-SHAPED kernel ``[co, ci, 3, 3]`` (and
    bias ``[co]``) expanded to block space at each call (``cfg.s2d_train``):
    ``kind="s1"`` the :func:`s2d_kernel_s1` image (stride-1 SAME in block
    space, block-space output, bias tiled by 4), ``kind="s2"`` the
    :func:`s2d_kernel_s2` image (2x2 stride-1 conv after (1, 0) padding,
    the normal half-resolution output). The expansion is a copy of slices,
    so autograd sums each reference tap's gradient over its block
    placements: the reference kernel's gradient. Names and shapes are
    ``conv2d``'s, so the state_dict is the base model's."""

    def __init__(self, in_channels, out_channels, kind: str, bias=False):
        if kind not in ("s1", "s2"):
            raise ValueError(f"unknown s2d conv kind {kind!r}")
        super().__init__(in_channels, out_channels, 3, padding=1, bias=bias)
        self.kind = kind
        # the output's channels: (block, c) over 4 blocks in block space
        self.out_blocks = 4 if kind == "s1" else 1

    def conv(self, x, weight, bias):
        if self.kind == "s1":
            w = s2d_kernel_s1(weight)
            b = None if bias is None else tile4(bias)
            return _channels_last(lambda z: F.conv2d(z, w, b, padding=1), x)
        w = s2d_kernel_s2(weight)
        return _channels_last(lambda z: F.conv2d(z, w, bias),
                              F.pad(x, (0, 0, 1, 0, 1, 0)))


class _S2DBlockBatchNorm(TorchBatchNorm):
    """TorchBatchNorm over a block-space tensor ``[..., 4C]`` with
    reference-shaped per-channel parameters and statistics ``[C]``: in
    train mode channel c's moments are reduced over all 4 block positions
    together (the population the reference's BN reduces at full
    resolution; the running statistics' ``n = numel / C``), in eval mode
    the running statistics act on every block."""

    @staticmethod
    def _blocks(x):
        return x.reshape(*x.shape[:-1], 4, x.shape[-1] // 4)

    def forward(self, x):
        return super().forward(self._blocks(x)).reshape(x.shape)

    def eval_affine(self):
        return tuple(map(tile4, super().eval_affine()))

    def affine(self, x):
        """(a, c) over the block channels: :func:`tile4` of the per-channel
        affine, so autograd sums dscale and dshift over the 4 blocks."""
        if not self.training:
            return self.eval_affine()
        return tuple(map(tile4, super().affine(self._blocks(x))))


class _S2DSpikingNorm(nn.Module):
    """The ``SpikingNorm`` twin of a block-space site (BN, or TDBN with
    its scale initialised to ``v_th``): one :class:`_S2DBlockBatchNorm`
    named like flax's auto-named child."""

    fusable = True

    def __init__(self, channels: int, norm: str = "BN", v_th: float = 1.0):
        super().__init__()
        self.BatchNorm_0 = _S2DBlockBatchNorm(
            channels, scale_init=v_th if norm == "TDBN" else 1.0)

    def forward(self, x):
        return self.BatchNorm_0(x)

    def affine(self, x):
        return self.BatchNorm_0.affine(x)


class _S2DTrainHeadLayer(nn.Module):
    """The block-space SEW head (conv -> BN -> spike, the BN and the spike
    one fused K2 / K2b site at 4 x 48 channels in the en4) with the base
    head's reference-shaped parameters (``cfg.s2d_train``)."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig):
        super().__init__()
        norm = cfg.spike_norm
        self.norm = (spiking_norm(out_channels, cfg)
                     if norm is None or norm_is_folded(norm, cfg)
                     else _S2DSpikingNorm(out_channels, norm, cfg.v_th))
        self.conv = _S2DConv(in_channels, out_channels, "s1",
                             bias=unnormed(self.norm))
        self.sn = SpikingNeuron(cfg)

    def forward(self, x):
        return norm_spike(self.norm, self.sn, self.conv(x))


class _S2DTrainExitLayer(nn.Module):
    """The block-space exit of the stride-2 MS conv with the base layer's
    reference-shaped parameters (``cfg.s2d_train``); its output is in the
    normal layout, so its BN is the plain per-channel one."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig):
        super().__init__()
        self.norm = spiking_norm(out_channels, cfg)
        self.conv = _S2DConv(in_channels, out_channels, "s2",
                             bias=unnormed(self.norm))

    def forward(self, x):
        return self.norm(self.conv(x))


class MSPEDSpikingPatchEmbedConvSfn(nn.Module):
    """sfn regroup -> SEW head -> MS conv /2 -> 2x MS resblocks -> PED
    projection /2; [B, bins, 2, H, W] -> [T, B, H/4, W/4, embed_dim].

    With ``cfg.s2d_embed`` the head and the MS conv run in 2x2 block space
    (head ``[4 * 48, 4 * ci, 3, 3]``, exit :class:`_S2DExitConvLayer`): eval
    only, on BN, with weights rearranged by ``training/s2d_embed.py``. With
    ``cfg.s2d_train`` they run in block space in both modes on the base
    model's parameters (:class:`_S2DTrainHeadLayer`,
    :class:`_S2DTrainExitLayer`): the same state_dict, so a base
    checkpoint loads unchanged; it excludes ``cfg.s2d_embed``."""

    def __init__(self, img_size, patch_size=(1, 1, 2, 2), in_chans=10,
                 embed_dim=96, cfg: SpikingConfig = SpikingConfig(),
                 num_res=2):
        super().__init__()
        if cfg.s2d_train and cfg.s2d_embed:
            raise ValueError("cfg.s2d_train and cfg.s2d_embed are mutually "
                             "exclusive re-expressions")
        if ((cfg.s2d_train or cfg.s2d_embed)
                and cfg.spike_norm not in (None, "BN", "TDBN")):
            raise ValueError("the s2d re-expressions require a "
                             "running-statistics BN embed (BN / TDBN), got "
                             f"{cfg.spike_norm!r}")
        self.in_chans = in_chans
        self.num_steps = self.out_steps = cfg.num_steps
        self.s2d, self.s2d_train = cfg.s2d_embed, cfg.s2d_train
        num_ch = in_chans * 2 // cfg.num_steps
        if self.s2d_train:
            self.head = _S2DTrainHeadLayer(num_ch, embed_dim // 2, cfg)
            self.conv = _S2DTrainExitLayer(embed_dim // 2, embed_dim, cfg)
        elif self.s2d:
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
        self.residual_encoding = SpikingResidualStack(embed_dim, cfg, num_res,
                                                      use_ms=True)
        self.proj = SpikingPEDLayer(embed_dim, embed_dim, cfg,
                                    stride=tuple(patch_size[-2:]))
        h, w = (conv_output_size(n, 3, 2, 1) for n in img_size)
        self.patches_resolution = tuple(
            conv_output_size(n, 3, s, 1)
            for n, s in zip((h, w), patch_size[-2:]))

    def band(self, x):
        """The full-resolution band (in block space with ``s2d_embed`` or
        ``s2d_train``): regroup -> head -> MS conv /2."""
        x = sfn_regroup(x[:, :self.in_chans], self.num_steps)
        if self.s2d and self.training:
            raise ValueError("cfg.s2d_embed is inference-only (train-mode"
                             " BN statistics would be per block-channel)")
        if self.s2d or self.s2d_train:
            x = space_to_depth(x)
        return self.conv(self.head(x))

    def forward(self, x):
        return self.proj(self.residual_encoding(self.band(x)))
