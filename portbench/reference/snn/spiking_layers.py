"""Spiking layers, mirrors of ``sdformerflow_tpu/models/spiking_layers.py``:
the neuron factory over every neuron type, the norm zoo, and the SEW and MS
conv layers, in eval and train mode.

Features are time-major channels-last ``[T, B, H, W, C]``; convolutions run
on the ``(T, B)``-flattened batch in NCHW views of that layout (channels-last
memory, so cuDNN reads it without a copy). Module and parameter names follow
the flax tree one to one (``training/from_jax.py`` maps leaf names and
layouts only).

A norm followed by a neuron is one site (:func:`norm_spike`). Where the
neuron is a PSN and the norm a running-statistics BN (BN, TDBN) or none,
the site is one fused pass (K2 forward, K2b backward,
``ops/hopper_psn.py``): the BN becomes the per-channel affine ``(a, c)`` of
its running statistics in eval mode, and of the batch statistics, with their
gradient, in train mode. Any other pair runs the norm as its own pass, then
the neuron: the IF / LIF / SLTT-LIF / PLIF / GLIF recurrences are loops
over T (``ops/neurons.py``), and BNTT's per-step statistics, BN_notrack's
batch statistics and GN / IN / LN are no per-channel affine.

``cfg.fold_bn`` (JAX ``norm_is_folded``, ``spiking_layers.py:44-47``)
removes every foldable BN site (BN, TDBN): its norm becomes
:class:`FoldedNorm` and its partner conv / linear / deconv gains a bias, at
the places JAX does; the weights come from
``training/bn_folding.py:fold_model``. A fused BN -> PSN site then runs K2
with no affine.

The neuron telemetry (JAX's ``spike_rate`` and ``membrane`` sows,
``spiking_layers.py:50-83``): inside ``with collect_sites(model) as
sites:`` every neuron site of ``model`` records, for each call, its firing
rate and, with ``cfg.store_v_seq``, its membrane statistics, as device
tensors under the keys ``scripts/eval_dsec.py`` writes. At a fused K2 site
the membrane is K2's potential output; at a recurrent neuron the loop's
``return_v``. Outside a collection nothing is recorded.
"""

from __future__ import annotations

import contextlib
import math
import re

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import neurons
from .interpolate import resize_bilinear
from .plain import affine_psn, bn_eval_affine, multihost
from .surrogate import get_surrogate
from .common import SpikingConfig

NEURON_TYPES = ("if", "lif", "slttlif", "plif", "psn", "glif")


class GLIF(nn.Module):
    """GLIF's learnable logits (``ops/neurons.py:GLIFParams``), one
    parameter each, named like the fields of JAX's packed ``glif`` tree."""

    def __init__(self, T: int, generator=None):
        super().__init__()
        init = neurons.glif_init(generator, T, init_tau=0.25,
                                 init_v_threshold=0.5, init_conduct=0.5)
        for name, value in init._asdict().items():
            setattr(self, name, nn.Parameter(value))

    def params(self) -> neurons.GLIFParams:
        return neurons.GLIFParams(*(getattr(self, f)
                                    for f in neurons.GLIFParams._fields))


def spike_rate(out: torch.Tensor) -> torch.Tensor:
    """A site's firing rate, ``mean(out != 0)`` in float32 (a 0-d device
    tensor)."""
    return (out != 0).to(torch.float32).mean()


def membrane_stats(v: torch.Tensor) -> torch.Tensor:
    """[T, 3]: the (mean, std, max) over every axis but time of the
    float32 potential, the population std (``jnp.std``, ddof 0)."""
    v = v.to(torch.float32)
    dims = tuple(range(1, v.dim()))
    return torch.stack([v.mean(dim=dims), v.std(dim=dims, correction=0),
                        v.amax(dim=dims)], dim=-1)


class _Site:
    """One neuron's share of a collection: its scope (the flax path,
    "/"-joined) and the collection's records. A ``muted`` site records
    nothing (a rematerialized block's recompute, ``training/remat.py``)."""

    muted = False

    def __init__(self, scope: str, sites: dict):
        self.scope, self.sites = scope, sites
        self.calls: dict = {}

    def record(self, kind: str, value: torch.Tensor):
        """Add one call's ``value`` under ``<scope>/<kind>/[i]``, i the
        site's calls of that kind before it (flax's sow tuple)."""
        if self.muted:
            return
        i = self.calls.get(kind, 0)
        self.calls[kind] = i + 1
        self.sites[f"{self.scope}/{kind}/[{i}]"] = value


def site_order(key: str):
    """The order JAX's tree flatten gives the keys: path components
    sorted, a ``[i]`` index by its number."""
    return [(0, int(p[1:-1]), "") if re.fullmatch(r"\[\d+\]", p)
            else (1, 0, p) for p in key.split("/")]


@contextlib.contextmanager
def collect_sites(model: nn.Module):
    """Collect the telemetry of ``model``'s neurons while the block runs:
    yields a dict that each neuron call fills, ``{"<path>/spike_rate/[i]":
    rate}`` and, with ``cfg.store_v_seq``, ``{"<path>/membrane/[i]": [T,
    3]}``, where ``<path>`` is the module's name with "/" for "." (the
    flax path, so the keys are those ``scripts/eval_dsec.py`` writes) and
    ``i`` counts the site's calls; at the end of the block the keys are in
    JAX's flatten order (:func:`site_order`). The values stay on the
    device. The MS attention runs its module form while collecting, firing
    ``attn_sn`` (``models/spiking_swin.py``)."""
    sites: dict = {}
    neurons = [(name, m) for name, m in model.named_modules()
               if isinstance(m, SpikingNeuron)]
    for name, m in neurons:
        if m.telemetry is not None:
            raise RuntimeError(f"{name} is already being collected")
        m.telemetry = _Site(name.replace(".", "/"), sites)
    try:
        yield sites
    finally:
        for _, m in neurons:
            m.telemetry = None
        ordered = sorted(sites.items(), key=lambda kv: site_order(kv[0]))
        sites.clear()
        sites.update(ordered)


class SpikingNeuron(nn.Module):
    """The config's neuron over [T, ...] with its surrogate gradient.

    PSN: ``H(W[T, T] @ x + b)``; with ``affine=(a, c)`` the per-channel
    affine ``a * x + c`` of a preceding BN is applied in the same pass (K2's
    fused form, K2b in the backward). IF / LIF / SLTT-LIF / PLIF (parameter
    ``w``) / GLIF (parameters under ``glif``): the recurrences of
    ``ops/neurons.py``, which take no affine.

    Inside :func:`collect_sites` each call records its firing rate and,
    with ``cfg.store_v_seq``, its membrane statistics (the PSN's potential
    ``h``, K2's second output at a fused site; the recurrences' membrane
    each step fired from)."""

    def __init__(self, cfg: SpikingConfig):
        super().__init__()
        self.kind = cfg.neuron_type.lower()
        if self.kind not in NEURON_TYPES:
            raise ValueError(f"unknown neuron_type {cfg.neuron_type!r}")
        self.cfg = cfg
        self.telemetry = None   # a _Site while collect_sites runs
        T = cfg.num_steps
        if self.kind == "psn":
            bound = math.sqrt(1.0 / T)  # kaiming_uniform(a=sqrt(5)) on [T, T]
            self.weight = nn.Parameter(
                torch.empty(T, T).uniform_(-bound, bound))
            self.bias = nn.Parameter(torch.full((T, 1), -1.0))
        elif self.kind == "plif":
            self.w = nn.Parameter(torch.tensor(neurons.plif_init_w(cfg.tau)))
        elif self.kind == "glif":
            self.glif = GLIF(T)

    def forward(self, x, affine=None):
        site = self.telemetry
        want_v = site is not None and self.cfg.store_v_seq
        out = self._fire(x, affine, want_v)
        if want_v:
            out, v = out
            site.record("membrane", membrane_stats(v))
        if site is not None:
            site.record("spike_rate", spike_rate(out))
        return out

    def _fire(self, x, affine, return_v):
        cfg = self.cfg
        if self.kind == "psn":
            if x.shape[0] != self.weight.shape[0]:
                raise ValueError(f"PSN built for T={self.weight.shape[0]} "
                                 f"but input has T={x.shape[0]}")
            scale, shift = affine if affine is not None else (None, None)
            kw = dict(return_v=True) if return_v else {}
            return affine_psn(x, self.weight, self.bias, scale=scale,
                              shift=shift, surrogate=cfg.surrogate,
                              alpha=cfg.surrogate_alpha, **kw)
        if affine is not None:
            raise ValueError(f"a {self.kind} neuron takes no fused affine")
        sg = get_surrogate(cfg.surrogate, cfg.surrogate_alpha)
        reset = dict(v_th=cfg.v_th, v_reset=cfg.v_reset, surrogate_fn=sg,
                     detach_reset=cfg.detach_reset, return_v=return_v)
        if self.kind == "if":
            return neurons.if_neuron(x, **reset)
        if self.kind == "lif":
            return neurons.lif_neuron(x, tau=cfg.tau, **reset)
        if self.kind == "slttlif":
            return neurons.sltt_lif_neuron(x, tau=cfg.tau, **reset)
        if self.kind == "plif":
            return neurons.plif_neuron(x, self.w, **reset)
        return neurons.glif_neuron(x, self.glif.params(), surrogate_fn=sg,
                                   return_v=return_v)


class TorchBatchNorm(nn.Module):
    """BatchNorm with torch running-statistics semantics, computed in
    >= float32 (float64 stays float64) and returned in the input's dtype.

    Train mode normalizes with the biased batch variance and updates the
    running statistics as ``r <- (1 - momentum) r + momentum stat`` with the
    unbiased variance (n = numel / C), unless ``update_running_stats`` is
    False (validation on batch statistics). Eval mode uses the running
    statistics. With a data-parallel ``group`` (set by the steps,
    ``training/train_step.py``) the batch statistics and n are those of
    every rank's rows (``parallel/multihost.py:batch_moments``).
    """

    fusable = True
    group = None

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1, scale_init: float = 1.0):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.update_running_stats = True
        self.weight = nn.Parameter(torch.full((features,), scale_init))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _batch_stats(self, xf):
        """(mean, biased var) over every axis but the last, updating the
        running statistics."""
        mean, var, n = multihost.batch_moments(
            xf, range(xf.dim() - 1), self.group)
        if self.update_running_stats:
            with torch.no_grad():
                unbiased = n / (max(n - 1.0, 1.0) if isinstance(n, float)
                                else (n - 1.0).clamp(min=1.0))
                m = self.momentum
                for buf, stat in ((self.running_mean, mean),
                                  (self.running_var, var * unbiased)):
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


class NoNorm(nn.Module):
    """A site with no norm (``spike_norm`` None, or a norm kind the site
    does not apply): the identity, with no affine for a fused PSN site and
    no parameter."""

    fusable = True

    def forward(self, x):
        return x

    def affine(self, x):
        return None


class FoldedNorm(NoNorm):
    """A BN site that folding removed (its affine is in the partner layer's
    weight and bias): the identity, with no affine for a fused PSN site.
    It holds no parameter, so the folded model's state_dict has no entry
    of the norm."""


# norm kinds whose eval affine folds into the adjacent conv / linear
# (running-statistics BN; BN_notrack uses batch statistics in eval too and
# BNTT has per-step statistics: neither folds)
_FOLDABLE_NORMS = ("BN", "tdBN", "TDBN")
NORM_TYPES = ("BN", "BN_notrack", "TDBN", "BNTT", "GN", "IN", "LN")


def norm_is_folded(norm, cfg: SpikingConfig) -> bool:
    """True when ``cfg.fold_bn`` removes this norm site from the graph."""
    return cfg.fold_bn and norm in _FOLDABLE_NORMS


def spiking_norm(channels: int, cfg: SpikingConfig, norm="cfg"):
    """The norm of a site: :class:`SpikingNorm` of ``norm`` (default the
    config's ``spike_norm``), :class:`FoldedNorm` when ``cfg.fold_bn``
    folds it, :class:`NoNorm` for None."""
    norm = cfg.spike_norm if norm == "cfg" else norm
    if norm is None:
        return NoNorm()
    if norm_is_folded(norm, cfg):
        return FoldedNorm()
    return SpikingNorm(channels, norm, cfg.num_steps, cfg.v_th)


def folded(norm: nn.Module) -> bool:
    """Whether a site's partner linear carries a bias for its folded
    norm."""
    return isinstance(norm, FoldedNorm)


def unnormed(norm: nn.Module) -> bool:
    """Whether a site's partner conv carries a bias: its norm was folded
    or there is none (JAX ``use_bias=norm is None or folded``)."""
    return isinstance(norm, NoNorm)


def norm_spike(norm: nn.Module, sn: SpikingNeuron, x):
    """``sn(norm(x))``: one fused pass where ``sn`` is a PSN and ``norm``
    a per-channel affine (a running-statistics BN, a folded BN or none),
    else the norm as its own pass."""
    if sn.kind == "psn" and norm.fusable:
        return sn(x, affine=norm.affine(x))
    return sn(norm(x))


class GroupNorm(nn.Module):
    """flax ``GroupNorm(num_groups, epsilon=1e-5, reduction_axes=(-3, -2,
    -1))`` on ``[..., H, W, C]``: per leading index and group over (H, W,
    the group's channels), the variance as ``E[x^2] - E[x]^2`` (flax's
    fast variance), in >= float32."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        cdt = torch.promote_types(x.dtype, torch.float32)
        C = x.shape[-1]
        xg = x.to(cdt).reshape(*x.shape[:-1], self.groups, C // self.groups)
        axes = (-4, -3, -1)
        mean = xg.mean(dim=axes, keepdim=True)
        var = ((xg * xg).mean(dim=axes, keepdim=True)
               - mean * mean).clamp(min=0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight.to(cdt) + self.bias.to(cdt)).to(x.dtype)


class SpikingNorm(nn.Module):
    """The norm zoo over [T, B, H, W, C] (JAX ``SpikingNorm``,
    ``spiking_layers.py:189-235``), children named like flax's:

    - BN: one TorchBatchNorm ``BatchNorm_0`` over the (T, B)-flattened
      batch; TDBN: the same with its scale initialised to ``alpha * v_th``;
    - BNTT: a TorchBatchNorm ``bn_t{i}`` (eps 1e-4) per time step;
    - BN_notrack: batch statistics in both modes, parameters ``scale`` and
      ``bias`` (computed in >= float32; JAX computes in the input's dtype),
      over every rank's rows with a data-parallel ``group``;
    - GN / IN / LN: :class:`GroupNorm` ``GroupNorm_0`` with C // 16, C and 1
      groups (eps 1e-5).
    """

    group = None

    def __init__(self, channels: int, norm: str = "BN", num_steps: int = 10,
                 v_th: float = 1.0, alpha: float = 1.0):
        super().__init__()
        if norm not in NORM_TYPES:
            raise ValueError(f"unknown norm {norm!r}")
        self.norm, self.num_steps = norm, num_steps
        # batch statistics in eval too: a batch's rows mix
        self.couples_rows = norm == "BN_notrack"
        if norm in ("BN", "TDBN"):
            self.BatchNorm_0 = TorchBatchNorm(
                channels, scale_init=alpha * v_th if norm == "TDBN" else 1.0)
        elif norm == "BNTT":
            for i in range(num_steps):
                self.add_module(f"bn_t{i}", TorchBatchNorm(channels,
                                                           eps=1e-4))
        elif norm == "BN_notrack":
            self.scale = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            groups = {"GN": max(channels // 16, 1), "IN": channels,
                      "LN": 1}[norm]
            self.GroupNorm_0 = GroupNorm(channels, groups)

    @property
    def fusable(self) -> bool:
        return self.norm in ("BN", "TDBN")

    def forward(self, x):
        if self.fusable:
            return self.BatchNorm_0(x)
        if self.norm == "BNTT":
            return torch.stack([getattr(self, f"bn_t{i}")(x[i])
                                for i in range(self.num_steps)])
        if self.norm == "BN_notrack":
            cdt = torch.promote_types(x.dtype, torch.float32)
            xf = x.to(cdt)
            mean, var, _ = multihost.batch_moments(xf, range(x.dim() - 1),
                                                   self.group)
            y = (xf - mean) / torch.sqrt(var + 1e-5) * self.scale.to(cdt) \
                + self.bias.to(cdt)
            return y.to(x.dtype)
        return self.GroupNorm_0(x)

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
    """``nn.Conv2d`` on channels-last ``[..., H, W, C]``; :meth:`conv` is
    the same conv with another weight and bias (a tensor-parallel shard,
    ``parallel/sharding_rules.py``)."""

    def conv(self, x, weight, bias):
        return _channels_last(lambda z: self._conv_forward(z, weight, bias),
                              x)

    def forward(self, x):
        return self.conv(x, self.weight, self.bias)


class TorchConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` on channels-last ``[..., H, W, C]``: the
    geometry the JAX module reproduces (zero-insert, pad
    ``(k-1-p, k-1-p+output_padding)``, flipped kernel); :meth:`conv` as
    :class:`Conv2d`'s."""

    def conv(self, x, weight, bias):
        return _channels_last(lambda z: F.conv_transpose2d(
            z, weight, bias, self.stride, self.padding, self.output_padding,
            self.groups, self.dilation), x)

    def forward(self, x):
        return self.conv(x, self.weight, self.bias)


def conv2d(in_channels, out_channels, kernel_size, stride=1, padding=None,
           bias=True) -> Conv2d:
    """k x k conv with torch padding ``kernel_size // 2`` by default."""
    if padding is None:
        padding = kernel_size // 2
    return Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding, bias=bias)


class SpikingConvEncoderLayer(nn.Module):
    """SEW ordering: conv -> norm -> spike."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 kernel_size=3, stride=1, padding=None):
        super().__init__()
        self.norm = spiking_norm(out_channels, cfg)
        self.conv = conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, bias=unnormed(self.norm))
        self.sn = SpikingNeuron(cfg)

    def forward(self, x):
        return norm_spike(self.norm, self.sn, self.conv(x))


class MSSpikingConvEncoderLayer(nn.Module):
    """MS ordering: spike -> conv -> norm; ``first_layer`` skips the spike."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 kernel_size=3, stride=1, padding=None, first_layer=False):
        super().__init__()
        self.first_layer = first_layer
        if not first_layer:
            self.sn = SpikingNeuron(cfg)
        self.norm = spiking_norm(out_channels, cfg)
        self.conv = conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, bias=unnormed(self.norm))

    def forward(self, x):
        if not self.first_layer:
            x = self.sn(x)
        return self.norm(self.conv(x))


def _upsample(x, scale: int):
    """Bilinear x``scale`` of [T, B, H, W, C] (one batched resize; the
    reference loops over T)."""
    return resize_bilinear(x, (x.shape[-3] * scale, x.shape[-2] * scale))


class SpikingDecoderLayer(nn.Module):
    """SEW decoder: bilinear x``scale`` upsample -> conv -> norm -> spike."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 kernel_size=3, scale=2):
        super().__init__()
        self.scale = scale
        self.norm = spiking_norm(out_channels, cfg)
        self.deconv = conv2d(in_channels, out_channels, kernel_size,
                             bias=unnormed(self.norm))
        self.sn = SpikingNeuron(cfg)

    def forward(self, x):
        return norm_spike(self.norm, self.sn,
                          self.deconv(_upsample(x, self.scale)))


class MSSpikingDecoderLayer(nn.Module):
    """MS decoder: bilinear x2 upsample -> spike -> conv -> norm (x2
    whatever ``scale``, as in JAX)."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 kernel_size=3, scale=2):
        super().__init__()
        self.sn = SpikingNeuron(cfg)
        self.norm = spiking_norm(out_channels, cfg)
        self.deconv = conv2d(in_channels, out_channels, kernel_size,
                             bias=unnormed(self.norm))

    def forward(self, x):
        return self.norm(self.deconv(self.sn(_upsample(x, 2))))


def _transpose_conv(in_channels, out_channels, kernel_size, scale, norm):
    """A decoder's x``scale`` transposed conv: ``kernel_size`` with padding
    ``kernel_size // 2`` at x2, the reference's ConvTranspose2d(7, stride
    4, padding 2) at x4, output_padding 1 in both."""
    k, p = (kernel_size, kernel_size // 2) if scale == 2 else (7, 2)
    return TorchConvTranspose(in_channels, out_channels, k, stride=scale,
                              padding=p, output_padding=1,
                              bias=unnormed(norm))


class SpikingTransposeDecoderLayer(nn.Module):
    """SEW transpose-conv decoder: deconv (x``scale``) -> norm -> spike."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 kernel_size=3, scale=2):
        super().__init__()
        self.norm = spiking_norm(out_channels, cfg)
        self.deconv = _transpose_conv(in_channels, out_channels, kernel_size,
                                      scale, self.norm)
        self.sn = SpikingNeuron(cfg)

    def forward(self, x):
        return norm_spike(self.norm, self.sn, self.deconv(x))


class MSSpikingTransposeDecoderLayer(nn.Module):
    """MS transpose-conv decoder: spike -> deconv (x``scale``) -> norm."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 kernel_size=3, scale=2):
        super().__init__()
        self.sn = SpikingNeuron(cfg)
        self.norm = spiking_norm(out_channels, cfg)
        self.deconv = _transpose_conv(in_channels, out_channels, kernel_size,
                                      scale, self.norm)

    def forward(self, x):
        return self.norm(self.deconv(self.sn(x)))


class SpikingPredLayer(nn.Module):
    """SEW prediction head: a bare conv (bias, no norm, no spike)."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 kernel_size=1):
        super().__init__()
        self.conv = conv2d(in_channels, out_channels, kernel_size, 1,
                           kernel_size // 2, bias=True)

    def forward(self, x):
        return self.conv(x)


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


class MSSepConv(nn.Module):
    """Inverted separable conv with MS spikes (JAX ``MSSepConv``,
    ``spiking_layers.py:631-665``): spike -> 1x1 ``pwconv1`` (to ``med =
    expansion_ratio * dim``) -> norm -> spike (one site) -> depthwise
    ``kernel_size`` ``dwconv`` -> 1x1 ``pwconv2`` (back to ``dim``) -> norm.
    The depthwise conv has no adjacent norm: its bias stays tied to the
    config's norm whether or not the norms are folded."""

    def __init__(self, dim, cfg: SpikingConfig, kernel_size=7,
                 expansion_ratio=2):
        super().__init__()
        med = int(expansion_ratio * dim)
        self.sn1 = SpikingNeuron(cfg)
        self.norm1 = spiking_norm(med, cfg)
        self.pwconv1 = conv2d(dim, med, 1, bias=unnormed(self.norm1))
        self.sn2 = SpikingNeuron(cfg)
        self.dwconv = Conv2d(med, med, kernel_size,
                             padding=kernel_size // 2, groups=med,
                             bias=cfg.spike_norm is None)
        self.norm2 = spiking_norm(dim, cfg)
        self.pwconv2 = conv2d(med, dim, 1, bias=unnormed(self.norm2))

    def forward(self, x):
        x = norm_spike(self.norm1, self.sn2, self.pwconv1(self.sn1(x)))
        return self.norm2(self.pwconv2(self.dwconv(x)))


class MSSpikingSepConvEncoderBlock(nn.Module):
    """The Sep-conv residual, then (spike -> 3x3 conv -> norm) x2 as a
    second residual (JAX ``spiking_layers.py:668-695``); the first norm and
    the second spike are one site."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig):
        super().__init__()
        self.sep = MSSepConv(in_channels, cfg)
        self.sn1 = SpikingNeuron(cfg)
        self.norm1 = spiking_norm(out_channels, cfg)
        self.conv1 = conv2d(in_channels, out_channels, 3, 1, 1,
                            bias=unnormed(self.norm1))
        self.sn2 = SpikingNeuron(cfg)
        self.norm2 = spiking_norm(in_channels, cfg)
        self.conv2 = conv2d(out_channels, in_channels, 3, 1, 1,
                            bias=unnormed(self.norm2))

    def forward(self, x):
        x = self.sep(x) + x
        y = norm_spike(self.norm1, self.sn2, self.conv1(self.sn1(x)))
        return x + self.norm2(self.conv2(y))


class MSSpikingSepTransposeDecoderLayer(nn.Module):
    """spike -> 3x3 stride-2 ``deconv1`` -> norm -> spike (one site) -> 1x1
    stride-2 ``deconv2`` -> norm (JAX ``spiking_layers.py:698-725``): two
    x2 transposed convs, so x4 whatever ``scale``, as in JAX."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 kernel_size=3, scale=2):
        super().__init__()
        self.sn1 = SpikingNeuron(cfg)
        self.norm1 = spiking_norm(in_channels, cfg)
        self.deconv1 = TorchConvTranspose(
            in_channels, in_channels, kernel_size, stride=2,
            padding=kernel_size // 2, output_padding=1,
            bias=unnormed(self.norm1))
        self.sn2 = SpikingNeuron(cfg)
        self.norm2 = spiking_norm(out_channels, cfg)
        self.deconv2 = TorchConvTranspose(in_channels, out_channels, 1,
                                          stride=2, padding=0,
                                          output_padding=1,
                                          bias=unnormed(self.norm2))

    def forward(self, x):
        x = norm_spike(self.norm1, self.sn2, self.deconv1(self.sn1(x)))
        return self.norm2(self.deconv2(x))


class MSSpikingSepPredLayer(nn.Module):
    """spike -> 1x1 ``pwconv`` -> depthwise ``kernel_size`` ``dwconv``, both
    with bias and no norm (JAX ``spiking_layers.py:728-747``)."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 kernel_size=1):
        super().__init__()
        self.sn = SpikingNeuron(cfg)
        self.pwconv = conv2d(in_channels, out_channels, 1, bias=True)
        self.dwconv = Conv2d(out_channels, out_channels, kernel_size,
                             padding=kernel_size // 2, groups=out_channels,
                             bias=True)

    def forward(self, x):
        return self.dwconv(self.pwconv(self.sn(x)))


def _connect(out, identity, cnf: str, cfg: SpikingConfig):
    """A residual block's join of its output and its input."""
    if cnf == "ADD":
        return out + identity
    if cnf in ("MUL", "AND"):
        return out * identity
    if cnf == "OR":
        return get_surrogate(cfg.surrogate, cfg.surrogate_alpha)(
            out + identity)
    if cnf == "NMUL":
        return identity * (1.0 - out)
    raise NotImplementedError(cnf)


class _ResBlock(nn.Module):
    """Two conv / BN / spike stages and the ``connect_function`` join. The
    norms are plain BN whatever the config (a reference quirk), none if
    ``spike_norm`` is None."""

    def __init__(self, channels, cfg: SpikingConfig,
                 connect_function: str = "ADD"):
        super().__init__()
        self.cfg, self.connect_function = cfg, connect_function
        norm = None if cfg.spike_norm is None else "BN"
        for i in (1, 2):
            n = spiking_norm(channels, cfg, norm)
            self.add_module(f"sn{i}", SpikingNeuron(cfg))
            self.add_module(f"norm{i}", n)
            self.add_module(f"conv{i}", conv2d(channels, channels, 3, 1, 1,
                                               bias=unnormed(n)))

    def join(self, out, identity):
        return _connect(out, identity, self.connect_function, self.cfg)


class SEWResBlock(_ResBlock):
    """Spike-element-wise residual block: (conv -> BN -> spike) x2, then the
    join (the BN and the spike one fused site each)."""

    def forward(self, x):
        y = norm_spike(self.norm1, self.sn1, self.conv1(x))
        y = norm_spike(self.norm2, self.sn2, self.conv2(y))
        return self.join(y, x)


class MSResBlock(_ResBlock):
    """Membrane-shortcut residual block: (spike -> conv -> BN) x2, then the
    join."""

    def forward(self, x):
        y = self.norm1(self.conv1(self.sn1(x)))
        y = self.norm2(self.conv2(self.sn2(y)))
        return self.join(y, x)


class SpikingResidualStack(nn.Module):
    """``num_blocks`` residual blocks (MS or SEW) named ``res{i}``."""

    def __init__(self, channels, cfg: SpikingConfig, num_blocks=4,
                 use_ms=False, connect_function: str = "ADD"):
        super().__init__()
        self.num_blocks = num_blocks
        block = MSResBlock if use_ms else SEWResBlock
        for i in range(num_blocks):
            self.add_module(f"res{i}", block(channels, cfg,
                                             connect_function))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"res{i}")(x)
        return x


def _embed_norm(out_channels, cfg: SpikingConfig, use_norm: bool = True):
    """The embedding layers' norm: a plain TorchBatchNorm whatever the
    config (foldable), none without ``spike_norm``."""
    if not use_norm or cfg.spike_norm is None:
        return NoNorm()
    return FoldedNorm() if cfg.fold_bn else TorchBatchNorm(out_channels)


class SpikingEmbeddingLayer(nn.Module):
    """Patch-embedding conv (stride = the spatial patch, padding 1) with a
    plain BN: SEW conv -> BN -> spike (one fused site), MS spike -> conv
    -> BN."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 stride=(2, 2), kernel_size=3, use_ms=False, use_norm=True):
        super().__init__()
        self.use_ms = use_ms
        self.norm = _embed_norm(out_channels, cfg, use_norm)
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           stride=tuple(stride), padding=1,
                           bias=unnormed(self.norm))
        self.sn = SpikingNeuron(cfg)

    def forward(self, x):
        if self.use_ms:
            return self.norm(self.conv(self.sn(x)))
        return norm_spike(self.norm, self.sn, self.conv(x))


class SpikingPEDLayer(nn.Module):
    """Patch embedding with deformed shortcut: stride-2 1x1 conv residual +
    (spike -> stride-2 3x3 conv -> BN)."""

    def __init__(self, in_channels, out_channels, cfg: SpikingConfig,
                 stride=(2, 2), kernel_size=3):
        super().__init__()
        # conv_res has no norm of its own: its bias stays tied to the config
        self.conv_res = Conv2d(in_channels, out_channels, 1, stride=2,
                               padding=0, bias=cfg.spike_norm is None)
        self.sn = SpikingNeuron(cfg)
        self.norm = _embed_norm(out_channels, cfg)
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           stride=tuple(stride), padding=1,
                           bias=unnormed(self.norm))

    def forward(self, x):
        return self.norm(self.conv(self.sn(x))) + self.conv_res(x)


def conv_output_size(n: int, kernel_size: int, stride: int,
                     padding: int) -> int:
    return (n + 2 * padding - kernel_size) // stride + 1


def drop_path(x, rate: float, *, generator=None, batch_axis: int = 1,
              group=None):
    """Stochastic depth: keep each sample's whole branch with probability
    ``1 - rate`` (scaled by 1 / keep) or zero it. The mask is drawn per
    sample on ``batch_axis``, shared over time and space, from
    ``generator`` (uniform < keep, the JAX ``bernoulli``); with a
    data-parallel ``group`` at the global batch, of which this rank keeps
    its rows (``parallel/multihost.py:global_rows``)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = [1] * x.dim()
    shape[batch_axis] = x.shape[batch_axis]
    u = multihost.global_rows(
        lambda s: torch.rand(s, generator=generator, device=x.device),
        shape, batch_axis, group)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
