"""Spiking 3D shifted-window transformer, the MS (SDformerFlow) eval subset
of ``sdformerflow_tpu/models/spiking_swin.py``.

Stages run time-major ``[D, B, H, W, C]``. The attention is the spiking-QK
window attention in the JAX package's pair-local form: K1
(``ops/hopper_attn.py``) for a CUDA tensor, its plain twin for a CPU tensor.
Reference quirks kept: raw row-major refolds in the window partition, the
shift mask ignored by the QK attention, no drop-path (eval).

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
from .spiking_layers import (SpikingNeuron, SpikingNorm, require_bn,
                             require_eval)


class _QKBranch(nn.Module):
    """linear (no bias) -> BN -> PSN, with the optional pre-spike positional
    encoding of k stored in the reference layout (1, nh, N, hd)."""

    def __init__(self, dim, cfg: SpikingConfig, pe_shape=None):
        super().__init__()
        self.linear = nn.Linear(dim, dim, bias=False)
        self.bn = SpikingNorm(dim)
        if pe_shape is not None:
            self.positional_encoding = nn.Parameter(torch.zeros(pe_shape))
        self.sn = SpikingNeuron(cfg)


class SpikingQKWindowAttention3D(nn.Module):
    """Linear-complexity spiking QK attention on time-major windows
    [2, B_, wh, ww, C]. Eval, PSN, BN, temporal window 2 and an even window
    count only; anything else raises NotImplementedError."""

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
        self.proj_bn = SpikingNorm(dim)

    def kernel_params(self) -> QKAttnParams:
        aq, cq = self.q.bn.eval_affine()
        ak, ck = self.k.bn.eval_affine()
        ap, cp = self.proj_bn.eval_affine()
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
        require_eval(self)
        return fused_qk_attention(x, self.kernel_params(), self.num_heads)


class SpikingMlp(nn.Module):
    """MS MLP: spike -> fc1 -> BN -> spike -> fc2 -> BN (the middle BN and
    spike run as one K2 pass)."""

    def __init__(self, dim, hidden_dim, cfg: SpikingConfig):
        super().__init__()
        require_bn(cfg)
        self.sn1 = SpikingNeuron(cfg)
        self.fc1 = nn.Linear(dim, hidden_dim, bias=False)
        self.bn1 = SpikingNorm(hidden_dim)
        self.sn2 = SpikingNeuron(cfg)
        self.fc2 = nn.Linear(hidden_dim, dim, bias=False)
        self.bn2 = SpikingNorm(dim)

    def forward(self, x):
        x = self.sn2(self.fc1(self.sn1(x)), affine=self.bn1.eval_affine())
        return self.bn2(self.fc2(x))


class SpikingSwinBlock3D(nn.Module):
    """MS block: QK window attention + MS MLP, SEW "ADD" joins, on
    time-major [D, B, H, W, C] at ``input_resolution`` = (D, H, W)."""

    def __init__(self, dim, num_heads, cfg: SpikingConfig, input_resolution,
                 window_size=(2, 7, 7), shift_size=(0, 0, 0), mlp_ratio=4.0):
        super().__init__()
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
        x = self._ssa(x) + x
        return self.mlp(x) + x


class SpikingPatchMerging(nn.Module):
    """MS merge: 2x2 space-to-channel -> spike -> Linear 4C -> 2C -> BN."""

    def __init__(self, dim, cfg: SpikingConfig):
        super().__init__()
        require_bn(cfg)
        self.sn = SpikingNeuron(cfg)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = SpikingNorm(2 * dim)

    def forward(self, x):
        D, B, H, Wd, C = x.shape
        if H % 2 or Wd % 2:
            x = F.pad(x, (0, 0, 0, Wd % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.norm(self.reduction(self.sn(x)))


class SpikingSwinStage(nn.Module):
    """``depth`` MS blocks (alternating shift) + optional merge; returns
    (downsampled, pre-merge features)."""

    def __init__(self, dim, depth, num_heads, cfg: SpikingConfig,
                 input_resolution, window_size=(2, 7, 7), mlp_ratio=4.0,
                 downsample=True):
        super().__init__()
        self.depth = depth
        shift = tuple(w // 2 for w in window_size)
        for i in range(depth):
            self.add_module(f"block{i}", SpikingSwinBlock3D(
                dim, num_heads, cfg, input_resolution,
                window_size=window_size,
                shift_size=(0, 0, 0) if i % 2 == 0 else shift,
                mlp_ratio=mlp_ratio))
        if downsample:
            self.downsample = SpikingPatchMerging(dim, cfg)

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        pre_merge = x
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return x, pre_merge
