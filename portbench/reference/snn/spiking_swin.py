"""Spiking 3D shifted-window transformer, a mirror of
``sdformerflow_tpu/models/spiking_swin.py`` (SEW and MS blocks), in eval
and train mode.

Stages run time-major ``[D, B, H, W, C]``; the attention works on time-major
windows ``[wd, B_, wh, ww, C]``, and every neuron inside it runs at
``num_steps = wd`` (the clamped temporal window).

- MS blocks (the SDformerFlow path): the spiking-QK window attention in the
  JAX package's forms, picked by its condition. At a temporal window of 2
  and an even window count: in eval mode, for a PSN with running-statistics
  BN, the pair-local interior is K1 (``ops/hopper_attn.py``) for a CUDA
  tensor, its plain twin for a CPU tensor; else (train mode - K1 has no
  backward, nor has the Pallas kernel it replaces - or another neuron or
  norm) the pair-local module form (``spiking_swin.py:330-358,371-376``).
  Elsewhere (an odd window count, a temporal window other than 2) both modes
  run the raw-refold module form (``:360-370``). The shift mask is ignored,
  as in the reference. While the neurons' telemetry is collected
  (``spiking_layers.collect_sites``) or the attention map is asked for,
  the module forms run in eval too and fire the telemetry neuron
  ``attn_sn`` on the attention output, as JAX's module forms do (``:371``;
  its fused attention carries no telemetry either, ``:257-260``).
- SEW blocks: the spiking BN window attention (q, k and v branches, swin-v1
  ``q kᵀ`` with the relative-position bias table and no softmax, or swin-v2
  Hamming similarity with softmax, ``logit_scale`` and the cpb MLP), which
  applies the shift mask; its products are ``torch.matmul``, as JAX computes
  them outside any Pallas kernel.

Every PSN site after a running-statistics BN is a fused K2 / K2b site
(``models/spiking_layers.py:norm_spike``). Reference quirks kept: raw
row-major refolds in the window partition and in the attention, drop-path
on the attention branch only, swin-v1 scale 1 for psn / glif neurons.

Under ``cfg.fold_bn`` the foldable BN sites lose their BN and their linears
gain a bias, as in JAX. JAX also turns its fused attention off there
(``spiking_swin.py:323-328``), because its kernel applies the BN affine
itself; the port keeps K1, whose affine then is the unit scale with the
folded bias as the shift (:meth:`SpikingQKWindowAttention3D.kernel_params`):
the same function.

``collect_attention`` (a stage) re-runs its last block's attention on that
block's input and returns the attention map in window layout: the
``attn_sn`` spikes [wd, B_, wh, ww, C] of an MS block, the scores
[B_, nh, N, N] (the shift mask added) of a SEW block (JAX ``:585-587``).

A torch module owns its parameters at construction, so each block is built
for the stage resolution the config implies (the clamped window decides the
positional encoding's shape and the shift mask, as the flax module decided
them from its input); a block called on another resolution raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import windows as W
from .plain import multihost
from .common import SpikingConfig
from .spiking_layers import (NoNorm, SpikingNeuron, SpikingNorm, drop_path,
                             folded, norm_spike, spiking_norm)

# norms a linear -> norm -> spike branch applies (others: no norm there)
_BN_FAMILY = ("BN", "BNTT", "tdBN", "TDBN", "IN")


def branch_norm(dim, cfg: SpikingConfig, norm):
    """The norm after a linear of the attention, the MLP: a norm of
    ``_BN_FAMILY`` (or its fold), else none (the linear then has no
    bias)."""
    if norm in _BN_FAMILY:
        return spiking_norm(dim, cfg, norm)
    return NoNorm()


def pre_norm(dim, cfg: SpikingConfig, norm):
    """The LN / GN pre-norm of a block or an MLP (JAX ``norm1``,
    ``pre_norm``), or None."""
    if norm in ("LN", "GN"):
        return SpikingNorm(dim, norm, cfg.num_steps, cfg.v_th)
    return None


class _QKVBranch(nn.Module):
    """linear (bias only with a folded BN) -> norm -> spike, with the
    optional pre-spike positional encoding of k stored in the reference
    layout (1, nh, N, hd)."""

    def __init__(self, dim, cfg: SpikingConfig, norm, pe_shape=None):
        super().__init__()
        self.bn = branch_norm(dim, cfg, norm)
        self.linear = nn.Linear(dim, dim, bias=folded(self.bn))
        if pe_shape is not None:
            self.positional_encoding = nn.Parameter(torch.zeros(pe_shape))
        self.sn = SpikingNeuron(cfg)

    def forward(self, x):
        """The branch's spikes on time-major windows [T, B_, wh, ww, C]."""
        y = self.linear(x)
        if not hasattr(self, "positional_encoding"):
            return norm_spike(self.bn, self.sn, y)
        T, _, H, Wd, C = y.shape
        y = self.bn(y) + self.positional_encoding.reshape(T, 1, H, Wd, C)
        return self.sn(y)


def _refold_out(attn_v, T, Hw, Ww, C):
    """(B_, nh, N, hd) -> [T, B_, wh, ww, C] (the reference's refold)."""
    B_, nh, _, hd = attn_v.shape
    out = attn_v.reshape(B_, nh, T, Hw, Ww, hd).permute(2, 0, 3, 4, 1, 5)
    return out.reshape(T, B_, Hw, Ww, C)


class SpikingQKWindowAttention3D(nn.Module):
    """Linear-complexity spiking QK attention on time-major windows
    [wd, B_, wh, ww, C]: ``attn_token = spike(sum_c q)``, ``attn = k *
    attn_token``, no softmax, no mask. The form follows the JAX module's
    condition (``spiking_swin.py:323-331``): at wd == 2 and an even window
    count K1 in eval (PSN and running-statistics BN) and the pair-local
    form otherwise; elsewhere the raw-refold form in both modes."""

    def __init__(self, dim, window_size, num_heads, cfg: SpikingConfig,
                 norm="BN"):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        acfg = cfg.replace(num_steps=window_size[0])
        n_all = window_size[0] * window_size[1] * window_size[2]
        self.proj_sn = SpikingNeuron(acfg)
        self.q = _QKVBranch(dim, acfg, norm)
        self.k = _QKVBranch(dim, acfg, norm,
                            pe_shape=(1, num_heads, n_all, dim // num_heads))
        self.sn2_q = SpikingNeuron(acfg)
        # the attention-telemetry neuron: the module forms fire it while
        # collecting or asked for the map; K1 never does (as JAX's fused
        # path), and nothing downstream reads its spikes
        self.attn_sn = SpikingNeuron(acfg)
        self.proj = nn.Linear(dim, dim, bias=True)
        self.proj_bn = branch_norm(dim, acfg, norm)
        # K1 takes a PSN and each BN site's per-channel affine
        self.kernel_ok = acfg.neuron_type.lower() == "psn" and all(
            folded(n) or (isinstance(n, SpikingNorm) and n.fusable)
            for n in (self.q.bn, self.k.bn, self.proj_bn))

    def forward(self, x, mask=None, return_attention=False):
        """The attention output [T, B_, wh, ww, C]; with
        ``return_attention`` the pair ``(output, attn_sn spikes)``."""
        del mask  # reference quirk: the shift mask is ignored in this path
        T, B_, Hw, Ww, C = x.shape
        telemetry = return_attention or self.attn_sn.telemetry is not None
        if T != 2 or B_ % 2:
            return self._raw_refold(x, telemetry, return_attention)
        # the pair-local module form; attn_sn fires only for the telemetry
        # (its output never reaches the loss, so its grads stay None)
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
        return self._tail(out, telemetry, return_attention)

    def _tail(self, out, telemetry, return_attention):
        """attn_sn on the attention output (for the telemetry only), then
        proj and its norm."""
        scores = self.attn_sn(out) if telemetry else None
        out = self.proj_bn(self.proj(out))
        return (out, scores) if return_attention else out

    def _raw_refold(self, x, telemetry=False, return_attention=False):
        """The reference's raw-refold form (``spiking_swin.py:360-370``),
        the JAX package's branch at an odd window count or a temporal window
        other than 2, in eval and in train: q keeps its time axis, k folds
        time into tokens, and the row-major refolds scramble heads as the
        reference does. attn_sn fires for the telemetry only, as in the
        pair-local form."""
        T, B_, Hw, Ww, C = x.shape
        nh = self.num_heads
        hd = C // nh
        x = self.proj_sn(x)
        q = self.q(x).reshape(T, B_, nh, -1, hd)
        k = self.k(x).reshape(B_, nh, -1, hd)
        att = self.sn2_q(q.sum(-1, keepdim=True))     # [T, B_, nh, HW, 1]
        attn = k * att.reshape(B_, nh, -1, 1)         # [B_, nh, T HW, hd]
        return self._tail(_refold_out(attn, T, Hw, Ww, C), telemetry,
                          return_attention)


class SpikingBNWindowAttention3D(nn.Module):
    """SEW window attention on time-major windows [wd, B_, wh, ww, C]
    (JAX ``spiking_swin.py:84-168``): q, k and v branches (linear -> norm
    -> spike at ``num_steps = wd``) and the raw ``(T, B_, H, W, C) -> (B_,
    nh, N, hd)`` refold; swin-v1 ``(q * scale) kᵀ`` plus the
    relative-position bias (scale 1 for psn / glif, else ``qk_scale`` or
    ``hd ** -0.5``; no softmax), swin-v2 the Hamming similarity
    ``0.5 (1 + (2q - 1)(2k - 1)ᵀ / hd)``, softmax, times ``exp(min(
    logit_scale, log 100))``, plus ``16 sigmoid`` of the cpb MLP's bias;
    then the shift mask, ``attn @ v``, proj -> norm -> spike. JAX's SDSA
    switches: ``spike_input`` adds ``proj_sn_in``, a neuron at ``num_steps
    = wd`` on the input before the q / k / v branches; ``spike_output=False``
    returns proj -> norm unspiked (the norm then its own pass, skipped when
    folded) and has no ``proj_sn``."""

    def __init__(self, dim, window_size, num_heads, cfg: SpikingConfig,
                 version="swinv1", qk_scale=None,
                 pretrained_window_size=(0, 0, 0), norm="BN",
                 spike_input=False, spike_output=True):
        super().__init__()
        if version not in ("swinv1", "swinv2"):
            raise ValueError(f"unknown swin version {version!r}")
        self.dim, self.num_heads, self.version = dim, num_heads, version
        self.window_size = tuple(window_size)
        hd = dim // num_heads
        if cfg.neuron_type.lower() in ("psn", "glif"):
            self.scale = 1.0
        else:
            self.scale = qk_scale or hd ** -0.5
        acfg = cfg.replace(num_steps=window_size[0])
        self.spike_input, self.spike_output = spike_input, spike_output
        if spike_input:
            self.proj_sn_in = SpikingNeuron(acfg)
        self.q = _QKVBranch(dim, acfg, norm)
        self.k = _QKVBranch(dim, acfg, norm)
        self.v = _QKVBranch(dim, acfg, norm)
        self.register_buffer("rel_idx", torch.from_numpy(
            W.relative_position_index(self.window_size)), persistent=False)
        if version == "swinv1":
            n_rel = math.prod(2 * w - 1 for w in self.window_size)
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros(n_rel, num_heads))
        else:
            self.logit_scale = nn.Parameter(
                torch.full((num_heads, 1, 1), math.log(10.0)))
            self.cpb_fc1 = nn.Linear(3, 512, bias=True)
            self.cpb_fc2 = nn.Linear(512, num_heads, bias=False)
            self.register_buffer("coords", torch.from_numpy(
                W.relative_coords_table(self.window_size,
                                        tuple(pretrained_window_size))),
                persistent=False)
        self.proj = nn.Linear(dim, dim, bias=True)
        self.proj_bn = branch_norm(dim, acfg, norm)
        if spike_output:
            self.proj_sn = SpikingNeuron(acfg)

    def position_bias(self, n: int, dtype) -> torch.Tensor:
        """[nh, n, n]: the v1 table's rows, or 16 sigmoid of the cpb MLP."""
        nh = self.num_heads
        if self.version == "swinv1":
            idx = self.rel_idx[:n, :n].reshape(-1)
            bias = self.relative_position_bias_table[idx].reshape(n, n, nh)
            return bias.permute(2, 0, 1).to(dtype)
        w1 = self.cpb_fc1.weight
        h = F.relu(F.linear(self.coords.to(w1.dtype), w1, self.cpb_fc1.bias))
        cpb = F.linear(h, self.cpb_fc2.weight).reshape(-1, nh)
        nw = self.rel_idx.shape[0]
        bias = cpb[self.rel_idx.reshape(-1)].reshape(nw, nw, nh)
        return (16.0 * torch.sigmoid(bias.permute(2, 0, 1))).to(dtype)

    def forward(self, x, mask=None, return_attention=False):
        """The attention output [T, B_, wh, ww, C]; with
        ``return_attention`` the pair ``(output, scores [B_, nh, N, N])``."""
        T, B_, Hw, Ww, C = x.shape
        nh = self.num_heads
        hd = C // nh
        if self.spike_input:
            x = self.proj_sn_in(x)
        q = self.q(x).reshape(B_, nh, -1, hd)
        k = self.k(x).reshape(B_, nh, -1, hd)
        v = self.v(x).reshape(B_, nh, -1, hd)
        N = q.shape[2]
        if self.version == "swinv1":
            attn = (q * self.scale) @ k.transpose(-2, -1)
        else:
            ham = 0.5 * (1.0 + (2 * q - 1) @ (2 * k - 1).transpose(-2, -1)
                         / hd)
            attn = ham.softmax(dim=-1)
            attn = attn * torch.exp(self.logit_scale.clamp(
                max=math.log(100.0))).to(attn.dtype)
        attn = attn + self.position_bias(N, attn.dtype)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(B_ // nW, nW, nh, N, N) \
                + mask.to(attn.dtype)[None, :, None]
            attn = attn.reshape(-1, nh, N, N)
        out = self.proj(_refold_out(attn @ v, T, Hw, Ww, C))
        out = norm_spike(self.proj_bn, self.proj_sn, out) \
            if self.spike_output else self.proj_bn(out)
        return (out, attn) if return_attention else out


class SpikingMlp(nn.Module):
    """The spiking MLP on time-major [T, B, H, W, C], with the LN / GN
    ``pre_norm`` first. SEW: (fc -> norm -> spike) x2; MS: spike -> fc1 ->
    norm -> spike -> fc2 -> norm. Each norm -> spike pair is one site."""

    def __init__(self, dim, hidden_dim, cfg: SpikingConfig, norm="BN",
                 ms=True):
        super().__init__()
        self.ms = ms
        self.pre_norm = pre_norm(dim, cfg, norm)
        self.sn1 = SpikingNeuron(cfg)
        self.bn1 = branch_norm(hidden_dim, cfg, norm)
        self.fc1 = nn.Linear(dim, hidden_dim, bias=folded(self.bn1))
        self.sn2 = SpikingNeuron(cfg)
        self.bn2 = branch_norm(dim, cfg, norm)
        self.fc2 = nn.Linear(hidden_dim, dim, bias=folded(self.bn2))

    def forward(self, x):
        if self.pre_norm is not None:
            x = self.pre_norm(x)
        if self.ms:
            x = norm_spike(self.bn1, self.sn2, self.fc1(self.sn1(x)))
            return self.bn2(self.fc2(x))
        x = norm_spike(self.bn1, self.sn1, self.fc1(x))
        return norm_spike(self.bn2, self.sn2, self.fc2(x))


def _sew(x, y, cnf: str):
    """A block's residual join."""
    if cnf == "ADD":
        return x + y
    if cnf == "AND":
        return x * y
    if cnf == "IAND":
        return x * (1.0 - y)
    raise NotImplementedError(cnf)


class SpikingSwinBlock3D(nn.Module):
    """One spiking swin block on time-major [D, B, H, W, C] at
    ``input_resolution`` = (D, H, W): window attention (MS: QK; SEW: BN
    window attention with the shift mask) and the MLP, each joined by
    ``cnf``. In train mode the attention branch takes drop-path at
    ``drop_path_rate``, drawn from ``drop_path_generator`` (None: torch's
    default generator of the input's device), at the global batch with a
    data-parallel ``group``.

    The window partition refolds the whole batch (the reference's raw
    refold, ``ops/windows.py:window_partition_v2_tm``), so at batch > 1 the
    attention mixes rows: at a temporal window of 2 its PSN pairs row b
    with row b + B/2, and the pair-local form's output regroup then feeds
    each output row from two neighbouring input rows and their partners, a
    pattern that reaches every row of a batch of 4. Two switches keep that
    right:

    - ``group`` (a data-parallel group, set by the steps): the attention
      part (norm1 and the attention) runs on the global batch, gathered
      from every rank (``parallel/multihost.py:gather_rows``), and each
      rank keeps its rows, so R ranks compute what one process does on the
      whole batch; the norms of that part take the gathered batch's
      statistics locally (the block clears their group). Its compute and
      activations a rank grow with R;
    - ``rows_apart`` (set by ``make_eval_step(per_row=True)``, the batched
      server): each row is refolded on its own, so each row's output is its
      batch-1 output: one attention call over the rows' stacked windows in
      the MS pair-local form (K1 in eval; a temporal window of 2, an even
      window count), else one call a row.
    """

    group = None
    rows_apart = False

    def __init__(self, dim, num_heads, cfg: SpikingConfig, input_resolution,
                 window_size=(2, 7, 7), shift_size=(0, 0, 0), mlp_ratio=4.0,
                 version="swinv1", qk_scale=None,
                 pretrained_window_size=(0, 0, 0), norm="BN",
                 drop_path_rate=0.0, ms=True, cnf="ADD"):
        super().__init__()
        self.drop_path_rate, self.cnf = drop_path_rate, cnf
        self.drop_path_generator = None
        self.input_resolution = tuple(input_resolution)
        self.window_size, self.shift_size = W.get_window_size(
            self.input_resolution, window_size, shift_size)
        self.norm1 = pre_norm(dim, cfg, norm)
        if ms:
            self.attn = SpikingQKWindowAttention3D(dim, self.window_size,
                                                   num_heads, cfg, norm)
        else:
            self.attn = SpikingBNWindowAttention3D(
                dim, self.window_size, num_heads, cfg, version=version,
                qk_scale=qk_scale,
                pretrained_window_size=pretrained_window_size, norm=norm)
        self.shifted = any(s > 0 for s in self.shift_size)
        if self.shifted and not ms:
            D, H, Wd = self.input_resolution
            ws = self.window_size
            padded = [-(-n // w) * w for n, w in zip((D, H, Wd), ws)]
            self.register_buffer("attn_mask", torch.from_numpy(
                W.compute_mask(*padded, ws, self.shift_size)),
                persistent=False)
        self.mlp = SpikingMlp(dim, int(dim * mlp_ratio), cfg, norm=norm,
                              ms=ms)

    def _ssa(self, x, return_attention=False):
        D, B, H, Wd, C = x.shape
        if (D, H, Wd) != self.input_resolution:
            raise ValueError(f"block built for {self.input_resolution}, got "
                             f"{(D, H, Wd)}")
        # norm1 and the attention run on the whole batch, gathered under a
        # group: their statistics are local
        for part in (self.norm1, self.attn):
            for m in part.modules() if part is not None else ():
                if hasattr(m, "group"):
                    m.group = None
        if multihost.active(self.group) and not return_attention:
            full = multihost.gather_rows(x, 1, self.group)
            return multihost.own_rows(self._ssa_batch(full), 1, self.group)
        return self._ssa_batch(x, return_attention)

    def _ssa_batch(self, x, return_attention=False):
        D, B, H, Wd, C = x.shape
        if self.norm1 is not None:
            x = self.norm1(x)
        ws, ss = self.window_size, self.shift_size
        x, _ = W.pad_to_windows_tm(x, ws)
        Dp, _, Hp, Wp, _ = x.shape
        if self.shifted:
            x = torch.roll(x, (-ss[0], -ss[1], -ss[2]), dims=(0, 2, 3))
        apart = self.rows_apart and B > 1
        windows = W.window_partition_v2_tm(x, ws, per_row=apart)
        mask = getattr(self, "attn_mask", None)
        if not apart:
            y = self.attn(windows, mask, return_attention=return_attention)
        elif (isinstance(self.attn, SpikingQKWindowAttention3D)
              and ws[0] == 2 and (windows.shape[1] // B) % 2 == 0
              and not return_attention):
            # the pair-local form (K1 in eval) keeps each pair of windows
            # apart: one call over every row's windows, whose output holds
            # each time half of every row in turn
            y = self.attn(windows, mask)
            y = y.reshape(2, 2, B, -1, *y.shape[2:]).transpose(1, 2) \
                .reshape(y.shape)
        else:
            # the other forms refold windows of neighbouring rows
            # together: one call a row
            y = [self.attn(w, mask, return_attention=return_attention)
                 for w in windows.chunk(B, dim=1)]
            y = tuple(torch.cat(p, dim=1) for p in zip(*y)) \
                if return_attention else torch.cat(y, dim=1)
        if return_attention:
            return y[1]
        y = W.window_reverse_tm(y, ws, B, Dp, Hp, Wp, per_row=apart)
        if self.shifted:
            y = torch.roll(y, ss, dims=(0, 2, 3))
        return y[:D, :, :H, :Wd, :]

    def forward(self, x, return_attention=False):
        """The block's output; with ``return_attention`` only its
        attention map (the attention run on ``x``, window layout)."""
        if return_attention:
            return self._ssa(x, return_attention=True)
        y = self._ssa(x)
        if self.training and self.drop_path_rate > 0.0:
            y = drop_path(y, self.drop_path_rate,
                          generator=self.drop_path_generator,
                          group=self.group)
        x = _sew(y, x, self.cnf)
        # no drop-path on the MLP branch (reference parity)
        return _sew(self.mlp(x), x, self.cnf)


class SpikingPatchMerging(nn.Module):
    """2x2 space-to-channel, Linear 4C -> 2C, norm and spike on time-major
    [D, B, H, W, C]. SEW: reduce -> norm -> spike (one site); MS: spike ->
    reduce -> norm. The norm is the config's kind (any), the linear has a
    bias only when it is folded."""

    def __init__(self, dim, cfg: SpikingConfig, norm="BN", ms=True):
        super().__init__()
        self.ms = ms
        self.sn = SpikingNeuron(cfg)
        self.norm = spiking_norm(2 * dim, cfg, norm)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=folded(self.norm))

    def forward(self, x):
        D, B, H, Wd, C = x.shape
        if H % 2 or Wd % 2:
            x = F.pad(x, (0, 0, 0, Wd % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        if self.ms:
            return self.norm(self.reduction(self.sn(x)))
        return norm_spike(self.norm, self.sn, self.reduction(x))


class SpikingSwinStage(nn.Module):
    """``depth`` blocks (alternating shift, block i at drop-path rate
    ``drop_path_rates[i]``, 0 past its end) + optional merge; returns
    (downsampled, pre-merge features), and with ``collect_attention`` the
    last block's attention map on its input third."""

    def __init__(self, dim, depth, num_heads, cfg: SpikingConfig,
                 input_resolution, window_size=(2, 7, 7), mlp_ratio=4.0,
                 version="swinv1", qk_scale=None,
                 pretrained_window_size=(0, 0, 0), norm="BN",
                 drop_path_rates=(), downsample=True, ms=True):
        super().__init__()
        self.depth = depth
        shift = tuple(w // 2 for w in window_size)
        for i in range(depth):
            self.add_module(f"block{i}", SpikingSwinBlock3D(
                dim, num_heads, cfg, input_resolution,
                window_size=window_size,
                shift_size=(0, 0, 0) if i % 2 == 0 else shift,
                mlp_ratio=mlp_ratio, version=version, qk_scale=qk_scale,
                pretrained_window_size=pretrained_window_size, norm=norm,
                drop_path_rate=(drop_path_rates[i]
                                if i < len(drop_path_rates) else 0.0),
                ms=ms))
        if downsample:
            self.downsample = SpikingPatchMerging(dim, cfg, norm=norm, ms=ms)

    def forward(self, x, collect_attention=False):
        last_input = x
        for i in range(self.depth):
            last_input = x
            x = getattr(self, f"block{i}")(x)
        attn = None
        if collect_attention:
            # re-run the last block's attention on its input
            attn = getattr(self, f"block{self.depth - 1}")(
                last_input, return_attention=True)
        pre_merge = x
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        if collect_attention:
            return x, pre_merge, attn
        return x, pre_merge
