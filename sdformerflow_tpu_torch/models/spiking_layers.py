"""Spiking layers, the PSN / BN subset of
``sdformerflow_tpu/models/spiking_layers.py``, in eval and train mode.

Features are time-major channels-last ``[T, B, H, W, C]``; convolutions run
on the ``(T, B)``-flattened batch in NCHW views of that layout (channels-last
memory, so cuDNN reads it without a copy). Module and parameter names follow
the flax tree one to one (``training/from_jax.py`` maps leaf names and
layouts only). A BN followed by a PSN runs as one fused site (K2 forward,
K2b backward): the BN becomes the per-channel affine ``(a, c)`` of its
running statistics in eval mode, and of the batch statistics, with their
gradient, in train mode.

``cfg.fold_bn`` (JAX ``norm_is_folded``, ``spiking_layers.py:44-47``)
removes every foldable BN site: its norm becomes :class:`FoldedNorm` and
its partner conv / linear / deconv gains a bias, at the places JAX does;
the weights come from ``training/bn_folding.py:fold_model``. A fused
BN -> PSN site then runs K2 with no affine.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.hopper_attn import bn_eval_affine
from ..ops.hopper_psn import affine_psn
from .common import SpikingConfig


class SpikingNeuron(nn.Module):
    """PSN neuron over [T, ...]: ``H(W[T, T] @ x + b)`` with the config's
    surrogate gradient; with ``affine=(a, c)`` the per-channel affine
    ``a * x + c`` of a preceding BN is applied in the same pass (K2's fused
    form, K2b in the backward)."""

    def __init__(self, cfg: SpikingConfig):
        super().__init__()
        if cfg.neuron_type.lower() != "psn":
            raise NotImplementedError(
                f"neuron_type {cfg.neuron_type!r}: only PSN is ported")
        T = cfg.num_steps
        self.surrogate, self.alpha = cfg.surrogate, cfg.surrogate_alpha
        bound = math.sqrt(1.0 / T)  # kaiming_uniform(a=sqrt(5)) on [T, T]
        self.weight = nn.Parameter(torch.empty(T, T).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.full((T, 1), -1.0))

    def forward(self, x, affine=None):
        if x.shape[0] != self.weight.shape[0]:
            raise ValueError(f"PSN built for T={self.weight.shape[0]} but "
                             f"input has T={x.shape[0]}")
        scale, shift = affine if affine is not None else (None, None)
        return affine_psn(x, self.weight, self.bias, scale=scale, shift=shift,
                          surrogate=self.surrogate, alpha=self.alpha)


class TorchBatchNorm(nn.Module):
    """BatchNorm with torch running-statistics semantics, computed in
    >= float32 (float64 stays float64) and returned in the input's dtype.

    Train mode normalizes with the biased batch variance and updates the
    running statistics as ``r <- (1 - momentum) r + momentum stat`` with the
    unbiased variance (n = numel / C), unless ``update_running_stats`` is
    False (validation on batch statistics). Eval mode uses the running
    statistics.
    """

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.update_running_stats = True
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _batch_stats(self, xf):
        """(mean, biased var) over every axis but the last, updating the
        running statistics."""
        var, mean = torch.var_mean(xf, dim=tuple(range(xf.dim() - 1)),
                                   correction=0)
        if self.update_running_stats:
            with torch.no_grad():
                n = xf.numel() / xf.shape[-1]
                m = self.momentum
                for buf, stat in ((self.running_mean, mean),
                                  (self.running_var,
                                   var * (n / max(n - 1.0, 1.0)))):
                    buf.copy_((1 - m) * buf.to(xf.dtype) + m * stat)
        return mean, var

    def forward(self, x):
        cdt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(cdt)
        if self.training:
            mean, var = self._batch_stats(xf)
        else:
            mean, var = self.running_mean.to(cdt), self.running_var.to(cdt)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.to(cdt) + self.bias.to(cdt)
        return y.to(x.dtype)

    def eval_affine(self):
        """(a, c) of the running statistics: ``forward(x) == a * x + c``
        in eval mode, up to rounding."""
        return bn_eval_affine(self.weight, self.bias, self.running_mean,
                              self.running_var, self.eps)

    def affine(self, x):
        """(a, c) with ``forward(x) == a * x + c`` up to rounding, for a
        fused BN -> PSN site: in train mode from ``x``'s batch statistics
        (updating the running statistics, gradients flowing to the weight,
        the bias and through the statistics to ``x``)."""
        if not self.training:
            return self.eval_affine()
        cdt = torch.promote_types(x.dtype, torch.float32)
        mean, var = self._batch_stats(x.to(cdt))
        a = self.weight.to(cdt) * torch.rsqrt(var + self.eps)
        return a, self.bias.to(cdt) - mean * a


class FoldedNorm(nn.Module):
    """A BN site that folding removed (its affine is in the partner layer's
    weight and bias): the identity, with no affine for a fused PSN site.
    It holds no parameter, so the folded model's state_dict has no entry
    of the norm."""

    def forward(self, x):
        return x

    def affine(self, x):
        return None


# norm kinds whose eval affine folds into the adjacent conv / linear
# (running-statistics BN; only BN is ported)
_FOLDABLE_NORMS = ("BN", "tdBN", "TDBN")


def norm_is_folded(norm, cfg: SpikingConfig) -> bool:
    """True when ``cfg.fold_bn`` removes this norm site from the graph."""
    return cfg.fold_bn and norm in _FOLDABLE_NORMS


def spiking_norm(channels: int, cfg: SpikingConfig, norm=None):
    """The norm of a BN site: :class:`SpikingNorm` of ``norm`` (default the
    config's), or :class:`FoldedNorm` when ``cfg.fold_bn`` folds it."""
    norm = cfg.spike_norm if norm is None else norm
    return FoldedNorm() if norm_is_folded(norm, cfg) else SpikingNorm(
        channels, norm)


def folded(norm: nn.Module) -> bool:
    """Whether a site's partner layer carries a bias for its folded norm."""
    return isinstance(norm, FoldedNorm)


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

    def affine(self, x):
        return self.BatchNorm_0.affine(x)


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
        self.norm = spiking_norm(out_channels, cfg)
        self.conv = conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, bias=folded(self.norm))
        self.sn = SpikingNeuron(cfg)

    def forward(self, x):
        x = self.conv(x)
        return self.sn(x, affine=self.norm.affine(x))


class MSSpikingConvEncoderLayer(nn.Module):
    """MS ordering: spike -> conv -> BN; ``first_layer`` skips the spike."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 kernel_size=3, stride=1, padding=None, first_layer=False):
        super().__init__()
        require_bn(cfg)
        self.first_layer = first_layer
        if not first_layer:
            self.sn = SpikingNeuron(cfg)
        self.norm = spiking_norm(out_channels, cfg)
        self.conv = conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, bias=folded(self.norm))

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
        self.norm = spiking_norm(out_channels, cfg)
        self.deconv = TorchConvTranspose(
            in_channels, out_channels, kernel_size, stride=2,
            padding=kernel_size // 2, output_padding=1,
            bias=folded(self.norm))

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
        self.norm1 = spiking_norm(channels, cfg, "BN")
        self.conv1 = conv2d(channels, channels, 3, 1, 1,
                            bias=folded(self.norm1))
        self.sn2 = SpikingNeuron(cfg)
        self.norm2 = spiking_norm(channels, cfg, "BN")
        self.conv2 = conv2d(channels, channels, 3, 1, 1,
                            bias=folded(self.norm2))

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
        # conv_res has no norm of its own: it keeps no bias when folded
        self.conv_res = Conv2d(in_channels, out_channels, 1, stride=2,
                               padding=0, bias=False)
        self.sn = SpikingNeuron(cfg)
        # a plain TorchBatchNorm whatever the config: foldable
        self.norm = FoldedNorm() if cfg.fold_bn else TorchBatchNorm(
            out_channels)
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           stride=tuple(stride), padding=1,
                           bias=folded(self.norm))

    def forward(self, x):
        return self.norm(self.conv(self.sn(x))) + self.conv_res(x)


def conv_output_size(n: int, kernel_size: int, stride: int,
                     padding: int) -> int:
    return (n + 2 * padding - kernel_size) // stride + 1


def drop_path(x, rate: float, *, generator=None, batch_axis: int = 1):
    """Stochastic depth: keep each sample's whole branch with probability
    ``1 - rate`` (scaled by 1 / keep) or zero it. The mask is drawn per
    sample on ``batch_axis``, shared over time and space, from
    ``generator`` (uniform < keep, the JAX ``bernoulli``)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = [1] * x.dim()
    shape[batch_axis] = x.shape[batch_axis]
    u = torch.rand(shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
