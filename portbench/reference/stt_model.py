"""A frozen, plain-PyTorch copy of the STTFlowNet model (the ANN flow net of
``configs/train_dsec_stt_voxel.yaml``): a Swin-3D v2 encoder over time
groups of a voxel chunk and a multi-res conv U-Net decoder.

The benchmark's plain reference: it imports no module of the program and
no JAX. The layer code is a copy of the program's model files as they stood
when the benchmark was written (``models/ann_*.py``, ``ops/windows.py``,
``ops/pad.py``, ``ops/interpolate.py`` and the norm and conv helpers), with
the data-parallel plumbing taken out. Convolutions and dense layers run
through :class:`Conv2d` and :class:`Linear`, which can round their operands
to float8 (e4m3, one scale a tensor) for the lower-precision control
(``precision.set_fp8``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import Quantizable

@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """The ``swin_transformer`` section of the model's config."""
    arc_type: str = "swinv2"
    patch_embed_type: str = "PatchEmbedLocal"
    input_size: Tuple[int, int] = (288, 384)
    patch_size: Tuple[int, ...] = (10, 4, 4)
    depths: Tuple[int, ...] = (2, 2, 6)
    num_heads: Tuple[int, ...] = (3, 6, 12)
    out_indices: Tuple[int, ...] = (0, 1, 2)
    window_size: Tuple[int, int, int] = (2, 9, 9)
    pretrained_window_size: Tuple[int, int, int] = (0, 0, 0)
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.2

    def replace(self, **kw) -> "SwinConfig":
        return dataclasses.replace(self, **kw)


def trunc_normal_02_(t: torch.Tensor) -> torch.Tensor:
    return torch.nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04)


def normalize_nonzero_std(x: torch.Tensor, group=None) -> torch.Tensor:
    """Standardize over the nonzero entries of the whole batch (zeros stay
    zero), with the unbiased std; a std of 0 leaves ``x`` as it is."""
    del group
    mask = x != 0
    count = mask.sum()
    mean = torch.where(mask, x, 0.0).sum() / count.clamp(min=1)
    var = torch.where(mask, (x - mean) ** 2, 0.0).sum() / (count - 1)
    std = torch.sqrt(var)
    ok = std > 0
    normed = torch.where(mask, (x - mean) / torch.where(ok, std, 1.0), x)
    return torch.where(ok, normed, x)


class TorchBatchNorm(nn.Module):
    """BatchNorm over the last axis in >= float32: batch statistics (biased
    variance) in train mode, updating the running ones with the unbiased
    variance; the running statistics in eval mode."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        cdt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(cdt)
        if self.training:
            dims = tuple(range(xf.dim() - 1))
            var, mean = torch.var_mean(xf, dim=dims, correction=0)
            n = xf.numel() / xf.shape[-1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * var * (n / max(n - 1.0, 1.0)))
        else:
            mean, var = self.running_mean.to(cdt), self.running_var.to(cdt)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.to(cdt) + self.bias.to(cdt)).to(x.dtype)


def _channels_last(conv, x):
    lead = x.shape[:-3]
    y = conv(x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[-2:], y.shape[1])


class Conv2d(nn.Conv2d, Quantizable):
    """``nn.Conv2d`` on channels-last ``[..., H, W, C]``."""

    def forward(self, x):
        def conv(z):
            z, w = self.operands(z, self.weight)
            return self._conv_forward(z, w, self.bias)
        return _channels_last(conv, x)


class Linear(nn.Linear, Quantizable):
    def forward(self, x):
        x, w = self.operands(x, self.weight)
        return F.linear(x, w, self.bias)


def conv2d(in_channels, out_channels, kernel_size, stride=1, padding=None,
           bias=True) -> Conv2d:
    if padding is None:
        padding = kernel_size // 2
    return Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding, bias=bias)


def conv_output_size(n: int, kernel_size: int, stride: int,
                     padding: int) -> int:
    return (n + 2 * padding - kernel_size) // stride + 1


def drop_path(x, rate: float, *, generator=None, batch_axis: int = 1,
              group=None):
    """Stochastic depth: keep each sample's branch with probability
    ``1 - rate`` (scaled by 1 / keep), the mask drawn uniform from
    ``generator``, one draw a sample."""
    del group
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = [1] * x.dim()
    shape[batch_axis] = x.shape[batch_axis]
    u = torch.rand(tuple(shape), generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


# ---- windows
def get_window_size(x_size, window_size, shift_size=None):
    """Clamp window/shift to the actual extent when the input is smaller."""
    use_window = list(window_size)
    use_shift = list(shift_size) if shift_size is not None else None
    for i, s in enumerate(x_size):
        if s <= window_size[i]:
            use_window[i] = s
            if use_shift is not None:
                use_shift[i] = 0
    if use_shift is None:
        return tuple(use_window)
    return tuple(use_window), tuple(use_shift)



def window_partition(x: torch.Tensor, window_size) -> torch.Tensor:
    """[B, D, H, W, C] -> [B*nW, wd*wh*ww, C]."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window_size
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, C)


def window_reverse(windows: torch.Tensor, window_size, B, D, H, W
                   ) -> torch.Tensor:
    """[B*nW, wd*wh*ww, C] (any layout reshapeable to it) ->
    [B, D, H, W, C]."""
    wd, wh, ww = window_size
    x = windows.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, -1)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, -1)


def pad_to_windows(x: torch.Tensor, window_size):
    """Zero-pad [B, D, H, W, C] so D/H/W are window multiples; returns
    (padded, (D, H, W))."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window_size
    pad_d = (wd - D % wd) % wd
    pad_h = (wh - H % wh) % wh
    pad_w = (ww - W % ww) % ww
    if pad_d or pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h, 0, pad_d))
    return x, (D, H, W)


def compute_mask(D, H, W, window_size, shift_size) -> np.ndarray:
    """Shifted-window attention mask [nW, N, N] of 0 / -100 (float32)."""
    img_mask = np.zeros((1, D, H, W, 1), np.float32)
    cnt = 0
    for d in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0]),
              slice(-shift_size[0], None)):
        for h in (slice(-window_size[1]),
                  slice(-window_size[1], -shift_size[1]),
                  slice(-shift_size[1], None)):
            for w in (slice(-window_size[2]),
                      slice(-window_size[2], -shift_size[2]),
                      slice(-shift_size[2], None)):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    wd, wh, ww = window_size
    m = img_mask.reshape(1, D // wd, wd, H // wh, wh, W // ww, ww, 1)
    m = m.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww)
    attn_mask = m[:, None, :] - m[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


def relative_position_index(window_size) -> np.ndarray:
    """Pairwise relative-position index [N, N] into a flattened bias table
    of (2wd-1)(2wh-1)(2ww-1) rows."""
    wd, wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh),
                                  np.arange(ww), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


def relative_coords_table(window_size, pretrained_window_size=(0, 0, 0)
                          ) -> np.ndarray:
    """Log-spaced relative coordinates for the swin-v2 CPB MLP:
    [1, 2wd-1, 2wh-1, 2ww-1, 3] float32.

    The reference's quirk is kept: ``table[:, :, :, i] /= (ws[i] - 1)``
    on the 5-D table divides W-offset slices 0-2 (across all three
    coordinates), not the coordinate channels. A divisor of 0 (a window
    of 1) is taken as 1.
    """
    wd, wh, ww = window_size
    rd = np.arange(-(wd - 1), wd, dtype=np.float32)
    rh = np.arange(-(wh - 1), wh, dtype=np.float32)
    rw = np.arange(-(ww - 1), ww, dtype=np.float32)
    table = np.stack(np.meshgrid(rd, rh, rw, indexing="ij"))
    table = table.transpose(1, 2, 3, 0)[None]
    ref = (pretrained_window_size if pretrained_window_size[0] > 0
           else window_size)
    for i in range(3):
        table[:, :, :, i] /= max(ref[i] - 1, 1)
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.astype(np.float32)

# ---- pad
def _pad_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Zero-pad (or crop, for negative deltas) x1's H/W to x2's, centered."""
    dy = x2.shape[-3] - x1.shape[-3]
    dx = x2.shape[-2] - x1.shape[-2]
    if dy == 0 and dx == 0:
        return x1
    lo_y, hi_y = dy // 2, dy - dy // 2
    lo_x, hi_x = dx // 2, dx - dx // 2
    h, w = x1.shape[-3], x1.shape[-2]
    x1 = x1[..., max(0, -lo_y):h - max(0, -hi_y),
            max(0, -lo_x):w - max(0, -hi_x), :]
    return F.pad(x1, (0, 0, max(0, lo_x), max(0, hi_x),
                      max(0, lo_y), max(0, hi_y)))


def skip_concat(x1: torch.Tensor, x2: torch.Tensor, dim: int = -1
                ) -> torch.Tensor:
    """Pad x1 to x2's spatial size, then concatenate along ``dim``."""
    return torch.cat([_pad_match(x1, x2), x2], dim=dim)


def optimal_crop_size(max_size: int, factor: int, safety_margin: int = 0
                      ) -> int:
    """Smallest multiple of ``factor`` that is >= max_size."""
    crop = int(factor * math.ceil(max_size / factor))
    return crop + safety_margin * factor


class CropSize:
    """Pad [..., H, W, C] up to sizes divisible by ``factor`` (centered) and
    crop back after the network."""

    def __init__(self, width, height, factor):
        self.height, self.width = height, width
        self.height_crop = optimal_crop_size(height, factor["h"])
        self.width_crop = optimal_crop_size(width, factor["w"])
        self.padding_top = math.ceil(0.5 * (self.height_crop - height))
        self.padding_bottom = math.floor(0.5 * (self.height_crop - height))
        self.padding_left = math.ceil(0.5 * (self.width_crop - width))
        self.padding_right = math.floor(0.5 * (self.width_crop - width))
        cx = math.floor(self.width_crop / 2)
        cy = math.floor(self.height_crop / 2)
        self.ix0 = cx - math.floor(width / 2)
        self.ix1 = cx + math.ceil(width / 2)
        self.iy0 = cy - math.floor(height / 2)
        self.iy1 = cy + math.ceil(height / 2)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        return F.pad(x, (0, 0, self.padding_left, self.padding_right,
                         self.padding_top, self.padding_bottom))

    def crop(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., self.iy0:self.iy1, self.ix0:self.ix1, :]

# ---- interp
def _src_index(n_in: int, n_out: int, device) -> torch.Tensor:
    ratio = torch.tensor(n_in / n_out, dtype=torch.float32, device=device)
    pos = torch.arange(n_out, dtype=torch.float32, device=device) * ratio
    return torch.floor(pos).long().clamp(0, n_in - 1)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of [..., H, W, C] to [..., out_h, out_w, C]."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    x = x.index_select(-3, _src_index(h, oh, x.device))
    return x.index_select(-2, _src_index(w, ow, x.device))


def resize_bilinear(x: torch.Tensor, out_hw,
                    antialias: bool = False) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C] to [..., out_h, out_w, C]."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = F.interpolate(x.reshape(-1, h, w, c).permute(0, 3, 1, 2),
                      size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=antialias)
    return y.permute(0, 2, 3, 1).reshape(*lead, *out_hw, c)

# ---- layers
_ACTS = {"relu": F.relu}


def apply_activation(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    return x if name is None else _ACTS[name](x)


class Norm2d(nn.Module):
    """BN (``BatchNorm_0``, torch running-statistics semantics) over the
    channels of ``[..., H, W, C]``; ``None`` is the identity."""

    def __init__(self, norm: Optional[str], channels: int,
                 momentum: float = 0.1):
        super().__init__()
        if norm == "BN":
            self.BatchNorm_0 = TorchBatchNorm(channels, momentum=momentum)
        elif norm is not None:
            raise ValueError(f"unknown norm {norm!r}")
        self.norm = norm

    def forward(self, x):
        if self.norm == "BN":
            return self.BatchNorm_0(x)
        return x


class ConvLayer(nn.Module):
    """conv -> (BN) -> activation."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        self.activation = activation
        self.conv2d = conv2d(in_channels, out_channels, kernel_size, stride,
                             bias=norm != "BN")
        self.norm_layer = Norm2d(norm, out_channels)

    def forward(self, x):
        return apply_activation(self.norm_layer(self.conv2d(x)),
                                self.activation)


class UpsampleConvLayer(nn.Module):
    """bilinear x2 -> conv -> (norm) -> activation."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 activation: Optional[str] = "relu",
                 norm: Optional[str] = None, scale_factor: int = 2):
        super().__init__()
        self.activation, self.scale_factor = activation, scale_factor
        self.conv2d = conv2d(in_channels, out_channels, kernel_size, 1,
                             bias=norm != "BN")
        self.norm_layer = Norm2d(norm, out_channels)

    def forward(self, x):
        h, w = x.shape[-3], x.shape[-2]
        x = resize_bilinear(x, (h * self.scale_factor, w * self.scale_factor))
        return apply_activation(self.norm_layer(self.conv2d(x)),
                                self.activation)


class ResidualBlock(nn.Module):
    """conv3x3 -> (norm) -> act -> conv3x3 -> (norm) -> + x -> act."""

    def __init__(self, channels, stride=1, activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        self.activation = activation
        self.conv1 = conv2d(channels, channels, 3, stride, bias=norm != "BN")
        self.bn1 = Norm2d(norm, channels)
        self.conv2 = conv2d(channels, channels, 3, 1, bias=norm != "BN")
        self.bn2 = Norm2d(norm, channels)

    def forward(self, x):
        out = apply_activation(self.bn1(self.conv1(x)), self.activation)
        out = self.bn2(self.conv2(out)) + x
        return apply_activation(out, self.activation)

# ---- embed

class ResidualFeatureGenerator(nn.Module):
    """``num_blocks`` BN residual blocks named ``resblock1``..."""

    def __init__(self, dim, num_blocks=4, norm="BN"):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"resblock{i + 1}",
                            ResidualBlock(dim, 1, "relu", norm))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"resblock{i + 1}")(x)
        return x


def _proj(dim, patch_size) -> Conv2d:
    """3x3 conv at stride ``patch_size[-2:]``, padding 1."""
    return Conv2d(dim, dim, 3, stride=tuple(patch_size[-2:]), padding=1)


def _patches(img_size, patch_size, pre_stride=1) -> Tuple[int, int]:
    h, w = (conv_output_size(n, 3, pre_stride, 1) for n in img_size)
    return (conv_output_size(h, 3, patch_size[-2], 1),
            conv_output_size(w, 3, patch_size[-1], 1))


class PatchEmbedLocal(nn.Module):
    """head conv -> 4 residual blocks -> strided proj, per time group."""

    def __init__(self, img_size, patch_size=(2, 4, 4), embed_dim=96,
                 num_groups=2):
        super().__init__()
        del num_groups
        self.patches_resolution = _patches(img_size, patch_size)
        self.head = conv2d(patch_size[0], embed_dim, 3, 1)
        self.residual_encoding = ResidualFeatureGenerator(embed_dim)
        self.proj = _proj(embed_dim, patch_size)

    def forward(self, x):
        x = self.proj(self.residual_encoding(self.head(x)))
        return x.transpose(0, 1)


ANN_PATCH_EMBEDS = {
    "PatchEmbedLocal": PatchEmbedLocal,
}

# ---- swin


def _dense(in_features, out_features, bias=True) -> Linear:
    lin = Linear(in_features, out_features, bias=bias)
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
    """Swin-v2 window attention on ``[B_, N, C]`` at a fixed (effective)
    ``window_size``: cosine scores under a learned logit scale, plus the
    continuous position bias of a 2-layer MLP."""

    def __init__(self, dim, window_size, num_heads, version="swinv2",
                 qkv_bias=True, pretrained_window_size=(0, 0, 0)):
        super().__init__()
        self.dim, self.num_heads, self.version = dim, num_heads, version
        self.window_size = tuple(window_size)
        self.qkv = _dense(dim, 3 * dim, qkv_bias)
        rel_idx = torch.from_numpy(relative_position_index(window_size))
        self.register_buffer("rel_idx", rel_idx, persistent=False)
        if version != "swinv2":
            raise ValueError(f"the reference has swinv2 only, not {version!r}")
        self.logit_scale = nn.Parameter(
            torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_fc1 = _dense(3, 512, True)
        self.cpb_fc2 = _dense(512, num_heads, False)
        coords = torch.from_numpy(relative_coords_table(
            window_size, pretrained_window_size))
        self.register_buffer("coords", coords, persistent=False)
        self.proj = _dense(dim, dim, True)

    def position_bias(self, n: int) -> torch.Tensor:
        """[heads, n, n] additive bias, float32 (or float64)."""
        nh = self.num_heads
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
                 shift_size=(0, 0, 0), mlp_ratio=4.0, version="swinv2",
                 qkv_bias=True,
                 pretrained_window_size=(0, 0, 0), drop_path_rate=0.0):
        super().__init__()
        self.window_size, self.shift_size = (tuple(window_size),
                                             tuple(shift_size))
        self.drop_path_rate = drop_path_rate
        self.drop_path_generator = None
        eff_window, _ = get_window_size(tuple(input_dhw), window_size,
                                          shift_size)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention3D(
            dim, eff_window, num_heads, version=version, qkv_bias=qkv_bias,
            pretrained_window_size=pretrained_window_size)
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
        window, shift = get_window_size((D, H, Wd), self.window_size,
                                          self.shift_size)
        if window != self.attn.window_size:
            raise ValueError(
                f"block built for the window {self.attn.window_size} (its "
                f"stage's size at construction), but the input {(D, H, Wd)} "
                f"gives {window}: build the model at this input size")
        x, _ = pad_to_windows(self.norm1(x), window)
        _, Dp, Hp, Wp, _ = x.shape
        shifted = any(s > 0 for s in shift)
        if shifted:
            x = torch.roll(x, tuple(-s for s in shift), dims=(1, 2, 3))
        y = self.attn(window_partition(x, window), mask if shifted else None)
        y = window_reverse(y, window, B, Dp, Hp, Wp)
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
                 window_size=(2, 7, 7), mlp_ratio=4.0, version="swinv2",
                 qkv_bias=True,
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
                pretrained_window_size=pretrained_window_size,
                drop_path_rate=(drop_path_rates[i]
                                if i < len(drop_path_rates) else 0.0)))
        self.downsample = PatchMerging(dim) if downsample else None

    def shift_mask(self, dhw: Tuple[int, int, int], device) -> torch.Tensor:
        """The [nW, N, N] shift mask of a (D, H, W) input, on ``device``."""
        key = (dhw, str(device))
        if key not in self._masks:
            shift = tuple(w // 2 for w in self.window_size)
            window, shift = get_window_size(dhw, self.window_size, shift)
            padded = [-(-n // w) * w for n, w in zip(dhw, window)]
            self._masks[key] = torch.from_numpy(
                compute_mask(*padded, window, shift)).to(device)
        return self._masks[key]

    def forward(self, x):
        mask = self.shift_mask(tuple(x.shape[1:4]), x.device)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, mask)
        pre_merge = x
        if self.downsample is not None:
            x = self.downsample(x)
        return x, pre_merge

# ---- flow

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
                                Linear(c, c // num_blocks))
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
        if not (use_upsample_conv and self.concat):
            raise ValueError("the reference has the upsample-conv decoders "
                             "with concatenated skips only")
        dec_cls = UpsampleConvLayer
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
        skip = skip_concat
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
