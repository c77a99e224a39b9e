"""Spiking 3D shifted-window transformer, the MS (SDformerFlow) subset of
``sdformerflow_tpu/models/spiking_swin.py``, in eval and train mode.

Stages run time-major ``[D, B, H, W, C]``. The attention is the spiking-QK
window attention in the JAX package's forms, picked by its condition. At an
even window count, in eval mode the pair-local interior is K1
(``ops/hopper_attn.py``) for a CUDA tensor, its plain twin for a CPU
tensor; K1 has no backward (nor has the Pallas kernel it replaces), so
train mode runs the pair-local module form
(``spiking_swin.py:330-358,371-376``). At an odd window count both modes
run the raw-refold module form (``:360-370``). The module forms' PSN sites
are fused PSN sites (K2/K2b) like every other. Reference quirks kept: raw
row-major refolds in the window partition and in the raw-refold attention,
the shift mask ignored by the QK attention, drop-path on the attention
branch only.

Under ``cfg.fold_bn`` the q/k branches, the MLP, the patch merging and
``proj_bn`` lose their BN and their linears gain a bias, as in JAX. JAX
also turns its fused attention off there (``spiking_swin.py:323-328``),
because its kernel applies the BN affine itself; the port keeps K1, whose
affine then is the unit scale with the folded bias as the shift
(:meth:`SpikingQKWindowAttention3D.kernel_params`): the same function.

A torch module owns its parameters at construction, so each block is built
for the stage resolution the config implies (the clamped window decides the
positional encoding's shape, as the flax module decided it from its input);
a block called on another resolution raises.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import windows as W
from ..ops.hopper_attn import QKAttnParams, fused_qk_attention
from .common import SpikingConfig
from .spiking_layers import (SpikingNeuron, drop_path, folded, require_bn,
                             spiking_norm)


class _QKBranch(nn.Module):
    """linear (no bias; with the folded BN's bias under ``cfg.fold_bn``) ->
    BN -> PSN, with the optional pre-spike positional encoding of k stored
    in the reference layout (1, nh, N, hd)."""

    def __init__(self, dim, cfg: SpikingConfig, pe_shape=None):
        super().__init__()
        self.bn = spiking_norm(dim, cfg)
        self.linear = nn.Linear(dim, dim, bias=folded(self.bn))
        if pe_shape is not None:
            self.positional_encoding = nn.Parameter(torch.zeros(pe_shape))
        self.sn = SpikingNeuron(cfg)

    def forward(self, x):
        """The branch's spikes on time-major windows [T, B_, wh, ww, C]."""
        y = self.linear(x)
        if not hasattr(self, "positional_encoding"):
            return self.sn(y, affine=self.bn.affine(y))
        T, _, H, Wd, C = y.shape
        y = self.bn(y) + self.positional_encoding.reshape(T, 1, H, Wd, C)
        return self.sn(y)


class SpikingQKWindowAttention3D(nn.Module):
    """Linear-complexity spiking QK attention on time-major windows
    [2, B_, wh, ww, C], PSN and BN, temporal window 2 (anything else raises
    NotImplementedError). The form follows the JAX module's condition
    (``spiking_swin.py:323-331``): at an even window count K1 in eval and
    the pair-local form in train; at an odd one the raw-refold form in
    both."""

    def __init__(self, dim, window_size, num_heads, cfg: SpikingConfig):
        super().__init__()
        require_bn(cfg)
        if window_size[0] != 2:
            raise NotImplementedError(
                f"temporal window {window_size[0]}: only wd == 2 is ported")
        if cfg.neuron_type.lower() != "psn":
            raise NotImplementedError("only PSN neurons are ported")
        self.dim, self.num_heads = dim, num_heads
        acfg = cfg.replace(num_steps=window_size[0])
        n_all = window_size[0] * window_size[1] * window_size[2]
        self.proj_sn = SpikingNeuron(acfg)
        self.q = _QKBranch(dim, acfg)
        self.k = _QKBranch(dim, acfg,
                           pe_shape=(1, num_heads, n_all, dim // num_heads))
        self.sn2_q = SpikingNeuron(acfg)
        # attention-telemetry neuron: kept so weights carry across one to
        # one; the eval forward never fires it (as in the fused JAX path)
        self.attn_sn = SpikingNeuron(acfg)
        self.proj = nn.Linear(dim, dim, bias=True)
        self.proj_bn = spiking_norm(dim, acfg)

    def kernel_params(self) -> QKAttnParams:
        """K1's parameters: each BN site's eval affine or, where folding
        moved it into the linear, the unit scale with ``shift`` (the q / k
        linear's bias; 0 after ``proj``, whose own bias K1 adds)."""
        def affine(norm, shift):
            if not folded(norm):
                return norm.eval_affine()
            c = shift.to(torch.promote_types(shift.dtype, torch.float32))
            return torch.ones_like(c), c

        aq, cq = affine(self.q.bn, self.q.linear.bias)
        ak, ck = affine(self.k.bn, self.k.linear.bias)
        ap, cp = affine(self.proj_bn, torch.zeros_like(self.proj.bias))
        return QKAttnParams(
            w_in=self.proj_sn.weight, b_in=self.proj_sn.bias,
            wq=self.q.linear.weight.t(), aq=aq, cq=cq,
            w_q=self.q.sn.weight, b_q=self.q.sn.bias,
            wk=self.k.linear.weight.t(), ak=ak, ck=ck,
            pe=self.k.positional_encoding.reshape(2, -1, self.dim),
            w_k=self.k.sn.weight, b_k=self.k.sn.bias,
            w_t=self.sn2_q.weight, b_t=self.sn2_q.bias,
            wp=self.proj.weight.t(), bp=self.proj.bias, ap=ap, cp=cp)

    def forward(self, x):
        T, B_, Hw, Ww, C = x.shape
        if B_ % 2:
            return self._raw_refold(x)
        if not self.training:
            return fused_qk_attention(x, self.kernel_params(), self.num_heads)
        # train: the pair-local module form; attn_sn is not fired (its
        # output never reaches the loss, so its grads stay None)
        nh = self.num_heads
        hd = C // nh
        x = self.proj_sn(x)
        q, k = self.q(x), self.k(x)
        att = self.sn2_q(q.reshape(T, B_, Hw, Ww, nh, hd).sum(-1))
        a = (k.reshape(T, B_, Hw, Ww, nh, hd) * att[..., None]).reshape(
            T, B_, Hw, Ww, C)

        def regroup(ah):  # [B_, h, w, C] -> [2, B_ / 2, h, w, C]
            v = ah.reshape(B_ // 2, nh, 2, Hw, Ww, hd).permute(2, 0, 3, 4, 1, 5)
            return v.reshape(2, B_ // 2, Hw, Ww, C)

        out = torch.cat([regroup(a[0]), regroup(a[1])], dim=1)
        return self.proj_bn(self.proj(out))

    def _raw_refold(self, x):
        """The reference's raw-refold form (``spiking_swin.py:360-370``),
        the JAX package's branch at an odd window count, in eval and in
        train: q keeps its time axis, k folds time into tokens, and the
        row-major refolds scramble heads as the reference does. attn_sn is
        not fired, as in the other forms."""
        T, B_, Hw, Ww, C = x.shape
        nh = self.num_heads
        hd = C // nh
        x = self.proj_sn(x)
        q = self.q(x).reshape(T, B_, nh, -1, hd)
        k = self.k(x).reshape(B_, nh, -1, hd)
        att = self.sn2_q(q.sum(-1, keepdim=True))     # [T, B_, nh, HW, 1]
        attn = k * att.reshape(B_, nh, -1, 1)         # [B_, nh, T HW, hd]
        out = attn.reshape(B_, nh, T, Hw, Ww, hd).permute(2, 0, 3, 4, 1, 5)
        out = out.reshape(T, B_, Hw, Ww, C)
        return self.proj_bn(self.proj(out))


class SpikingMlp(nn.Module):
    """MS MLP: spike -> fc1 -> BN -> spike -> fc2 -> BN (the middle BN and
    spike run as one K2 pass)."""

    def __init__(self, dim, hidden_dim, cfg: SpikingConfig):
        super().__init__()
        require_bn(cfg)
        self.sn1 = SpikingNeuron(cfg)
        self.bn1 = spiking_norm(hidden_dim, cfg)
        self.fc1 = nn.Linear(dim, hidden_dim, bias=folded(self.bn1))
        self.sn2 = SpikingNeuron(cfg)
        self.bn2 = spiking_norm(dim, cfg)
        self.fc2 = nn.Linear(hidden_dim, dim, bias=folded(self.bn2))

    def forward(self, x):
        x = self.fc1(self.sn1(x))
        x = self.sn2(x, affine=self.bn1.affine(x))
        return self.bn2(self.fc2(x))


class SpikingSwinBlock3D(nn.Module):
    """MS block: QK window attention + MS MLP, SEW "ADD" joins, on
    time-major [D, B, H, W, C] at ``input_resolution`` = (D, H, W). In
    train mode the attention branch takes drop-path at ``drop_path_rate``,
    drawn from ``drop_path_generator`` (None: torch's default generator of
    the input's device)."""

    def __init__(self, dim, num_heads, cfg: SpikingConfig, input_resolution,
                 window_size=(2, 7, 7), shift_size=(0, 0, 0), mlp_ratio=4.0,
                 drop_path_rate=0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.drop_path_generator = None
        self.input_resolution = tuple(input_resolution)
        self.window_size, self.shift_size = W.get_window_size(
            self.input_resolution, window_size, shift_size)
        self.attn = SpikingQKWindowAttention3D(dim, self.window_size,
                                               num_heads, cfg)
        self.mlp = SpikingMlp(dim, int(dim * mlp_ratio), cfg)

    def _ssa(self, x):
        D, B, H, Wd, C = x.shape
        if (D, H, Wd) != self.input_resolution:
            raise ValueError(f"block built for {self.input_resolution}, got "
                             f"{(D, H, Wd)}")
        ws, ss = self.window_size, self.shift_size
        x, _ = W.pad_to_windows_tm(x, ws)
        Dp, _, Hp, Wp, _ = x.shape
        shifted = any(s > 0 for s in ss)
        if shifted:
            x = torch.roll(x, (-ss[0], -ss[1], -ss[2]), dims=(0, 2, 3))
        y = self.attn(W.window_partition_v2_tm(x, ws))
        y = W.window_reverse_tm(y, ws, B, Dp, Hp, Wp)
        if shifted:
            y = torch.roll(y, ss, dims=(0, 2, 3))
        return y[:D, :, :H, :Wd, :]

    def forward(self, x):
        y = self._ssa(x)
        if self.training and self.drop_path_rate > 0.0:
            y = drop_path(y, self.drop_path_rate,
                          generator=self.drop_path_generator)
        x = y + x
        return self.mlp(x) + x  # no drop-path on the MLP branch


class SpikingPatchMerging(nn.Module):
    """MS merge: 2x2 space-to-channel -> spike -> Linear 4C -> 2C -> BN."""

    def __init__(self, dim, cfg: SpikingConfig):
        super().__init__()
        require_bn(cfg)
        self.sn = SpikingNeuron(cfg)
        self.norm = spiking_norm(2 * dim, cfg)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=folded(self.norm))

    def forward(self, x):
        D, B, H, Wd, C = x.shape
        if H % 2 or Wd % 2:
            x = F.pad(x, (0, 0, 0, Wd % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.norm(self.reduction(self.sn(x)))


class SpikingSwinStage(nn.Module):
    """``depth`` MS blocks (alternating shift, block i at drop-path rate
    ``drop_path_rates[i]``, 0 past its end) + optional merge; returns
    (downsampled, pre-merge features)."""

    def __init__(self, dim, depth, num_heads, cfg: SpikingConfig,
                 input_resolution, window_size=(2, 7, 7), mlp_ratio=4.0,
                 drop_path_rates=(), downsample=True):
        super().__init__()
        self.depth = depth
        shift = tuple(w // 2 for w in window_size)
        for i in range(depth):
            self.add_module(f"block{i}", SpikingSwinBlock3D(
                dim, num_heads, cfg, input_resolution,
                window_size=window_size,
                shift_size=(0, 0, 0) if i % 2 == 0 else shift,
                mlp_ratio=mlp_ratio,
                drop_path_rate=(drop_path_rates[i]
                                if i < len(drop_path_rates) else 0.0)))
        if downsample:
            self.downsample = SpikingPatchMerging(dim, cfg)

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        pre_merge = x
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return x, pre_merge
