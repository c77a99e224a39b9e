"""ANN spatiotemporal Swin-3D (v1 and v2 window attention), mirrors of
``sdformerflow_tpu/models/ann_swin.py``.

Features are channels-last ``[B, D, H, W, C]``, windows ``[B*nW, N, C]``;
the attention is plain tensor algebra (no TPU kernel lies on this path).

- v1: softmax attention with a learned relative-position-bias table,
  sliced ``rel_idx[:N, :N]``;
- v2: cosine attention (``q * rsqrt(|q|^2 + 1e-12)``), a learned
  ``logit_scale`` clipped at log(100), and the continuous position bias
  MLP (3 -> 512 -> heads) through ``16 * sigmoid``.

A block builds its attention at the *effective* window, which
``get_window_size`` shrinks where a stage is smaller than the window, so it
needs the stage's (D, H, W) at construction (a v1 table's shape depends on
it); a call at another effective window raises. The shift masks, the
position indices and the v2 coordinates are constants of the geometry,
made at the first call of a geometry and kept on the module.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import windows as W
from .common import trunc_normal_02_
from .spiking_layers import drop_path


def _dense(in_features, out_features, bias=True) -> nn.Linear:
    lin = nn.Linear(in_features, out_features, bias=bias)
    trunc_normal_02_(lin.weight)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in >= float32 and returned in the input's
    dtype: flax takes LayerNorm statistics in float32 whatever the
    parameters' dtype, so a bf16 cast of the parameters keeps it right."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        cdt = torch.promote_types(x.dtype, torch.float32)
        return F.layer_norm(x.to(cdt), self.normalized_shape,
                            self.weight.to(cdt), self.bias.to(cdt),
                            self.eps).to(x.dtype)


class WindowAttention3D(nn.Module):
    """Window attention on ``[B_, N, C]`` at a fixed (effective)
    ``window_size``; ``version`` selects the v1 or v2 math."""

    def __init__(self, dim, window_size, num_heads, version="swinv1",
                 qkv_bias=True, qk_scale=None,
                 pretrained_window_size=(0, 0, 0)):
        super().__init__()
        self.dim, self.num_heads, self.version = dim, num_heads, version
        self.window_size = tuple(window_size)
        self.qk_scale = qk_scale
        self.qkv = _dense(dim, 3 * dim, qkv_bias)
        rel_idx = torch.from_numpy(W.relative_position_index(window_size))
        self.register_buffer("rel_idx", rel_idx, persistent=False)
        n_rel = int(np.prod([2 * w - 1 for w in window_size]))
        if version == "swinv1":
            self.relative_position_bias_table = nn.Parameter(
                trunc_normal_02_(torch.empty(n_rel, num_heads)))
        elif version == "swinv2":
            self.logit_scale = nn.Parameter(
                torch.full((num_heads, 1, 1), math.log(10.0)))
            self.cpb_fc1 = _dense(3, 512, True)
            self.cpb_fc2 = _dense(512, num_heads, False)
            coords = torch.from_numpy(W.relative_coords_table(
                window_size, pretrained_window_size))
            self.register_buffer("coords", coords, persistent=False)
        else:
            raise ValueError(f"unknown swin version {version!r}")
        self.proj = _dense(dim, dim, True)

    def position_bias(self, n: int) -> torch.Tensor:
        """[heads, n, n] additive bias, float32 (or float64)."""
        nh = self.num_heads
        if self.version == "swinv1":
            table = self.relative_position_bias_table
            table = table.to(torch.promote_types(table.dtype, torch.float32))
            idx = self.rel_idx[:n, :n].reshape(-1)
            return table[idx].reshape(n, n, nh).permute(2, 0, 1)
        w1, b1 = self.cpb_fc1.weight, self.cpb_fc1.bias
        cdt = torch.promote_types(w1.dtype, torch.float32)
        h = F.relu(F.linear(self.coords.to(cdt), w1.to(cdt), b1.to(cdt)))
        cpb = F.linear(h, self.cpb_fc2.weight.to(cdt)).reshape(-1, nh)
        nw = self.rel_idx.shape[0]
        bias = cpb[self.rel_idx.reshape(-1)].reshape(nw, nw, nh)
        return 16.0 * torch.sigmoid(bias.permute(2, 0, 1))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        B_, N, C = x.shape
        nh, hd = self.num_heads, C // self.num_heads
        qkv = self.qkv(x).reshape(B_, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]           # [B_, nh, N, hd]
        if self.version == "swinv1":
            scale = self.qk_scale or hd ** -0.5
            attn = (q * scale) @ k.transpose(-2, -1)
        else:
            qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
            kn = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
            attn = qn @ kn.transpose(-2, -1)
            scale = torch.exp(self.logit_scale.clamp(max=math.log(100.0)))
            attn = attn * scale.to(attn.dtype)
        attn = attn + self.position_bias(N).to(attn.dtype)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(B_ // nW, nW, nh, N, N) \
                + mask.to(attn.dtype)[None, :, None]
            attn = attn.reshape(-1, nh, N, N)
        attn = attn.softmax(dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim, hidden_dim):
        super().__init__()
        self.fc1 = _dense(dim, hidden_dim)
        self.fc2 = _dense(hidden_dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock3D(nn.Module):
    """LN -> (shifted) W-MSA -> drop-path residual -> LN -> MLP ->
    drop-path residual, on ``[B, D, H, W, C]`` of extent ``input_dhw``.

    In train mode both branches take drop-path at ``drop_path_rate``, one
    mask per sample each, drawn from ``drop_path_generator`` (None: torch's
    default generator), at the global batch with a data-parallel
    ``group`` (set by the steps)."""

    group = None

    def __init__(self, dim, num_heads, input_dhw, window_size=(2, 7, 7),
                 shift_size=(0, 0, 0), mlp_ratio=4.0, version="swinv1",
                 qkv_bias=True, qk_scale=None,
                 pretrained_window_size=(0, 0, 0), drop_path_rate=0.0):
        super().__init__()
        self.window_size, self.shift_size = (tuple(window_size),
                                             tuple(shift_size))
        self.drop_path_rate = drop_path_rate
        self.drop_path_generator = None
        eff_window, _ = W.get_window_size(tuple(input_dhw), window_size,
                                          shift_size)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention3D(
            dim, eff_window, num_heads, version=version, qkv_bias=qkv_bias,
            qk_scale=qk_scale, pretrained_window_size=pretrained_window_size)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _drop_path(self, y):
        if self.training and self.drop_path_rate > 0.0:
            return drop_path(y, self.drop_path_rate,
                             generator=self.drop_path_generator, batch_axis=0,
                             group=self.group)
        return y

    def _attend(self, x, mask):
        B, D, H, Wd, C = x.shape
        window, shift = W.get_window_size((D, H, Wd), self.window_size,
                                          self.shift_size)
        if window != self.attn.window_size:
            raise ValueError(
                f"block built for the window {self.attn.window_size} (its "
                f"stage's size at construction), but the input {(D, H, Wd)} "
                f"gives {window}: build the model at this input size")
        x, _ = W.pad_to_windows(self.norm1(x), window)
        _, Dp, Hp, Wp, _ = x.shape
        shifted = any(s > 0 for s in shift)
        if shifted:
            x = torch.roll(x, tuple(-s for s in shift), dims=(1, 2, 3))
        y = self.attn(W.window_partition(x, window), mask if shifted else None)
        y = W.window_reverse(y, window, B, Dp, Hp, Wp)
        if shifted:
            y = torch.roll(y, shift, dims=(1, 2, 3))
        return y[:, :D, :H, :Wd, :]

    def forward(self, x, mask):
        x = x + self._drop_path(self._attend(x, mask))
        return x + self._drop_path(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """2x2 space-to-channel (odd sizes zero-padded) -> LN(4C) ->
    Linear 4C -> 2C."""

    def __init__(self, dim):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = _dense(4 * dim, 2 * dim, False)

    def forward(self, x):
        H, Wd = x.shape[2], x.shape[3]
        if H % 2 or Wd % 2:
            x = F.pad(x, (0, 0, 0, Wd % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    """``depth`` blocks (every other one shifted by half a window) and an
    optional PatchMerging; ``forward`` returns (downsampled, pre-merge)."""

    def __init__(self, dim, depth, num_heads, input_dhw,
                 window_size=(2, 7, 7), mlp_ratio=4.0, version="swinv1",
                 qkv_bias=True, qk_scale=None,
                 pretrained_window_size=(0, 0, 0),
                 drop_path_rates: Sequence[float] = (), downsample=True):
        super().__init__()
        self.depth, self.window_size = depth, tuple(window_size)
        shift = tuple(w // 2 for w in window_size)
        self._masks: dict = {}
        for i in range(depth):
            self.add_module(f"block{i}", SwinBlock3D(
                dim, num_heads, input_dhw, window_size=window_size,
                shift_size=(0, 0, 0) if i % 2 == 0 else shift,
                mlp_ratio=mlp_ratio, version=version, qkv_bias=qkv_bias,
                qk_scale=qk_scale,
                pretrained_window_size=pretrained_window_size,
                drop_path_rate=(drop_path_rates[i]
                                if i < len(drop_path_rates) else 0.0)))
        self.downsample = PatchMerging(dim) if downsample else None

    def shift_mask(self, dhw: Tuple[int, int, int], device) -> torch.Tensor:
        """The [nW, N, N] shift mask of a (D, H, W) input, on ``device``."""
        key = (dhw, str(device))
        if key not in self._masks:
            shift = tuple(w // 2 for w in self.window_size)
            window, shift = W.get_window_size(dhw, self.window_size, shift)
            padded = [-(-n // w) * w for n, w in zip(dhw, window)]
            self._masks[key] = torch.from_numpy(
                W.compute_mask(*padded, window, shift)).to(device)
        return self._masks[key]

    def forward(self, x):
        mask = self.shift_mask(tuple(x.shape[1:4]), x.device)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, mask)
        pre_merge = x
        if self.downsample is not None:
            x = self.downsample(x)
        return x, pre_merge
