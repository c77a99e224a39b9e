"""Spiking layers, the PSN / BN eval subset of
``sdformerflow_tpu/models/spiking_layers.py``.

Features are time-major channels-last ``[T, B, H, W, C]``; convolutions run
on the ``(T, B)``-flattened batch in NCHW views of that layout (channels-last
memory, so cuDNN reads it without a copy). Module and parameter names follow
the flax tree one to one (``training/from_jax.py`` maps leaf names and
layouts only). Eval mode only: a module in training mode raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.hopper_attn import bn_eval_affine
from ..ops.hopper_psn import fused_affine_psn
from .common import SpikingConfig


def require_eval(module: nn.Module):
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: only eval mode is ported "
            "(call model.eval())")


class SpikingNeuron(nn.Module):
    """PSN neuron over [T, ...]: ``H(W[T, T] @ x + b)``; with ``affine=(a,
    c)`` the per-channel affine ``a * x + c`` of a preceding eval BN is
    applied in the same pass (K2's fused form)."""

    def __init__(self, cfg: SpikingConfig):
        super().__init__()
        if cfg.neuron_type.lower() != "psn":
            raise NotImplementedError(
                f"neuron_type {cfg.neuron_type!r}: only PSN is ported")
        T = cfg.num_steps
        bound = math.sqrt(1.0 / T)  # kaiming_uniform(a=sqrt(5)) on [T, T]
        self.weight = nn.Parameter(torch.empty(T, T).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.full((T, 1), -1.0))

    def forward(self, x, affine=None):
        if x.shape[0] != self.weight.shape[0]:
            raise ValueError(f"PSN built for T={self.weight.shape[0]} but "
                             f"input has T={x.shape[0]}")
        scale, shift = affine if affine is not None else (None, None)
        return fused_affine_psn(x, self.weight, self.bias, scale=scale,
                                shift=shift)


class TorchBatchNorm(nn.Module):
    """Eval BatchNorm with running statistics, computed in >= float32
    (float64 stays float64) and returned in the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        require_eval(self)
        cdt = torch.promote_types(x.dtype, torch.float32)
        y = ((x.to(cdt) - self.running_mean.to(cdt))
             * torch.rsqrt(self.running_var.to(cdt) + self.eps))
        y = y * self.weight.to(cdt) + self.bias.to(cdt)
        return y.to(x.dtype)

    def eval_affine(self):
        """(a, c) with ``forward(x) == a * x + c`` up to rounding."""
        require_eval(self)
        return bn_eval_affine(self.weight, self.bias, self.running_mean,
                              self.running_var, self.eps)


class SpikingNorm(nn.Module):
    """``SpikingNorm(norm='BN')``: one TorchBatchNorm named like flax's
    auto-named child."""

    def __init__(self, channels: int, norm: str = "BN"):
        super().__init__()
        if norm != "BN":
            raise NotImplementedError(f"norm {norm!r}: only BN is ported")
        self.BatchNorm_0 = TorchBatchNorm(channels)

    def forward(self, x):
        return self.BatchNorm_0(x)

    def eval_affine(self):
        return self.BatchNorm_0.eval_affine()


def _channels_last(conv, x):
    """Apply an NCHW ``conv`` to channels-last ``[..., H, W, C]`` (leading
    dims are batch) through permuted views."""
    lead = x.shape[:-3]
    y = conv(x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[-2:], y.shape[1])


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on channels-last ``[..., H, W, C]``."""

    def forward(self, x):
        return _channels_last(super().forward, x)


class TorchConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` on channels-last ``[..., H, W, C]``: the
    geometry the JAX module reproduces (zero-insert, pad
    ``(k-1-p, k-1-p+output_padding)``, flipped kernel)."""

    def forward(self, x):
        return _channels_last(super().forward, x)


def conv2d(in_channels, out_channels, kernel_size, stride=1, padding=None,
           bias=True) -> Conv2d:
    """k x k conv with torch padding ``kernel_size // 2`` by default."""
    if padding is None:
        padding = kernel_size // 2
    return Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding, bias=bias)


def require_bn(cfg: SpikingConfig):
    if cfg.spike_norm != "BN":
        raise NotImplementedError(
            f"spike_norm {cfg.spike_norm!r}: only BN is ported")


class SpikingConvEncoderLayer(nn.Module):
    """SEW ordering: conv -> BN -> spike (BN and spike in one K2 pass)."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 kernel_size=3, stride=1, padding=None):
        super().__init__()
        require_bn(cfg)
        self.conv = conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, bias=False)
        self.norm = SpikingNorm(out_channels)
        self.sn = SpikingNeuron(cfg)

    def forward(self, x):
        return self.sn(self.conv(x), affine=self.norm.eval_affine())


class MSSpikingConvEncoderLayer(nn.Module):
    """MS ordering: spike -> conv -> BN; ``first_layer`` skips the spike."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 kernel_size=3, stride=1, padding=None, first_layer=False):
        super().__init__()
        require_bn(cfg)
        self.first_layer = first_layer
        if not first_layer:
            self.sn = SpikingNeuron(cfg)
        self.conv = conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, bias=False)
        self.norm = SpikingNorm(out_channels)

    def forward(self, x):
        if not self.first_layer:
            x = self.sn(x)
        return self.norm(self.conv(x))


class MSSpikingTransposeDecoderLayer(nn.Module):
    """MS transpose-conv decoder: spike -> deconv (x2) -> BN."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 kernel_size=3, scale=2):
        super().__init__()
        require_bn(cfg)
        if scale != 2:
            raise NotImplementedError("only the x2 transpose decoder is "
                                      "ported")
        self.sn = SpikingNeuron(cfg)
        self.deconv = TorchConvTranspose(
            in_channels, out_channels, kernel_size, stride=2,
            padding=kernel_size // 2, output_padding=1, bias=False)
        self.norm = SpikingNorm(out_channels)

    def forward(self, x):
        return self.norm(self.deconv(self.sn(x)))


class MSSpikingPredLayer(nn.Module):
    """MS prediction head: spike -> conv (bias, no norm)."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 kernel_size=1):
        super().__init__()
        self.sn = SpikingNeuron(cfg)
        self.conv = conv2d(in_channels, out_channels, kernel_size, 1,
                           kernel_size // 2, bias=True)

    def forward(self, x):
        return self.conv(self.sn(x))


class MSResBlock(nn.Module):
    """Membrane-shortcut residual block: (spike -> conv -> BN) x2, ADD.
    The norms are plain BN whatever the config (reference quirk)."""

    def __init__(self, channels, cfg: SpikingConfig,
                 connect_function: str = "ADD"):
        super().__init__()
        require_bn(cfg)
        if connect_function != "ADD":
            raise NotImplementedError(
                f"connect_function {connect_function!r}: only ADD is ported")
        self.sn1 = SpikingNeuron(cfg)
        self.conv1 = conv2d(channels, channels, 3, 1, 1, bias=False)
        self.norm1 = SpikingNorm(channels)
        self.sn2 = SpikingNeuron(cfg)
        self.conv2 = conv2d(channels, channels, 3, 1, 1, bias=False)
        self.norm2 = SpikingNorm(channels)

    def forward(self, x):
        y = self.norm1(self.conv1(self.sn1(x)))
        y = self.norm2(self.conv2(self.sn2(y)))
        return y + x


class SpikingResidualStack(nn.Module):
    """``num_blocks`` MS residual blocks named ``res{i}``."""

    def __init__(self, channels, cfg: SpikingConfig, num_blocks=2):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"res{i}", MSResBlock(channels, cfg))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"res{i}")(x)
        return x


class SpikingPEDLayer(nn.Module):
    """Patch embedding with deformed shortcut: stride-2 1x1 conv residual +
    (spike -> stride-2 3x3 conv -> BN)."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 stride=(2, 2), kernel_size=3):
        super().__init__()
        require_bn(cfg)
        self.conv_res = Conv2d(in_channels, out_channels, 1, stride=2,
                               padding=0, bias=False)
        self.sn = SpikingNeuron(cfg)
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           stride=tuple(stride), padding=1, bias=False)
        self.norm = TorchBatchNorm(out_channels)

    def forward(self, x):
        return self.norm(self.conv(self.sn(x))) + self.conv_res(x)


def conv_output_size(n: int, kernel_size: int, stride: int,
                     padding: int) -> int:
    return (n + 2 * padding - kernel_size) // stride + 1

