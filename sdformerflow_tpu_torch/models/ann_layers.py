"""ANN conv primitives on channels-last ``[..., H, W, C]``, mirrors of
``sdformerflow_tpu/models/ann_layers.py``: ``ConvLayer``,
``TransposedConvLayer``, ``UpsampleConvLayer``, ``ResidualBlock``.

Leading axes are batch (the patch embeds run ``[T, B, H, W, C]`` through
one conv). Module names follow the flax tree (``conv2d``, ``norm_layer``,
``conv1``/``bn1``, ...), so ``training/from_jax.py`` maps leaf names only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interpolate import resize_bilinear
from .spiking_layers import TorchBatchNorm, TorchConvTranspose, conv2d

_ACTS = {
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def apply_activation(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    return x if name is None else _ACTS[name](x)


class InstanceNorm(nn.Module):
    """flax ``GroupNorm`` with one group per channel: per sample and channel
    over (H, W) of ``[..., H, W, C]``, epsilon 1e-6, the variance as
    ``E[x^2] - E[x]^2`` (flax's fast variance), in >= float32."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        cdt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(cdt)
        mean = xf.mean(dim=(-3, -2), keepdim=True)
        var = ((xf * xf).mean(dim=(-3, -2), keepdim=True)
               - mean * mean).clamp(min=0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.to(cdt) + self.bias.to(cdt)).to(x.dtype)


class Norm2d(nn.Module):
    """BN (``BatchNorm_0``, torch running-statistics semantics) or IN
    (``GroupNorm_0``) over the channels of ``[..., H, W, C]``; ``None`` is
    the identity."""

    def __init__(self, norm: Optional[str], channels: int,
                 momentum: float = 0.1):
        super().__init__()
        if norm == "BN":
            self.BatchNorm_0 = TorchBatchNorm(channels, momentum=momentum)
        elif norm == "IN":
            self.GroupNorm_0 = InstanceNorm(channels)
        elif norm is not None:
            raise ValueError(f"unknown norm {norm!r}")
        self.norm = norm

    def forward(self, x):
        if self.norm == "BN":
            return self.BatchNorm_0(x)
        if self.norm == "IN":
            return self.GroupNorm_0(x)
        return x


class ConvLayer(nn.Module):
    """conv -> (BN/IN) -> activation."""

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


class TransposedConvLayer(nn.Module):
    """x2 transposed conv (torch geometry) -> (norm) -> activation."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        self.activation = activation
        self.transposed_conv2d = TorchConvTranspose(
            in_channels, out_channels, kernel_size, stride=2,
            padding=kernel_size // 2, output_padding=1, bias=norm != "BN")
        self.norm_layer = Norm2d(norm, out_channels)

    def forward(self, x):
        return apply_activation(self.norm_layer(self.transposed_conv2d(x)),
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
