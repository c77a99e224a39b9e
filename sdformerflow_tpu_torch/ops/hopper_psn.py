"""The fused PSN site: K2 (forward, Triton) and K2b (backward, CUDA C++).

Replaces the Pallas TPU kernel ``sdformerflow_tpu/ops/pallas_psn.py``:
``fused_affine_psn``, a ``jax.custom_vjp`` whose forward ``_fwd_kernel``
computes ``spike = H(W[T, T] @ (x * scale + shift) + b)`` over the leading
time axis of ``x`` viewed as [T, N], and whose backward ``_bwd_kernel``
recomputes the potential and applies the ATan surrogate. Here
:class:`FusedAffinePSN` is that VJP: K2 forward, K2b backward, the small
parameter reductions in PyTorch between them, as they were in XLA. Every
PSN site of the port goes through :func:`affine_psn`.

K2, what bounds it on H100: memory. Each column reads T values and writes T
spikes with ~T^2 FMAs in between (~10 FMA per byte in bf16, far below the
card's ~295 operations per byte), so the kernel is one pass at device
bandwidth. The design: a program owns BLOCK columns; for each output step
t it accumulates ``b[t] + sum_s W[t, s] * x[s]`` over the T input rows with
both loops unrolled by ``tl.static_range`` (the repeated row loads hit L1),
applying the per-channel affine of the channels-last layout (channel =
column % C) as the rows are read, and stores 0/1 in the input's dtype. All
work is 1-D per column: a first version that reduced a [T, BLOCK] tile
across threads was 16x slower in bf16 on the card (PERF.md). Nothing but
x, the spikes and the T x T weights touches device memory.

K2b (``csrc/psn_bwd.cu``, its source note says what bounds it) recomputes
the potential in K2's order and writes ``gh = g * ATan'(h)`` (float32) and
``dx = scale * W^T gh`` (x's dtype) in one pass; the forward saves only x
and the parameters, as ``_fused_fwd`` saves its residuals.

K2's kernel also serves the two other TPU forms of the same function,
which differ from ``_fwd_kernel`` only in their block layout (a PSN mixes
over the leading T axis whatever the trailing layout): K2c here
(:func:`psn_spike_tm`, ``pallas_psn.py:psn_spike_tm`` on [T, M, C]) and
K4a in ``ops/hopper_embed.py`` (``pallas_embed.py:psn_spike_cs`` on
channels-second [T, C, H, W]), both with no affine, each through
:func:`launch_k2` and counted on its own entry.

Dispatch: a CUDA tensor launches the kernels (or the call raises), a CPU
tensor runs the plain twins :func:`psn_spike`, :func:`psn_spike_tm_plain`
and :func:`psn_backward_plain`. Triton is imported, and K2b built, only
when a kernel is launched.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple

import torch

from ..kernel_build import import_triton, load_cuda_library
from .neurons import psn_neuron
from .surrogate import surrogate_grad, surrogate_key

BLOCK = 1024
NUM_WARPS = 8


def _affine(x2, scale, shift, channels):
    """[T, N] columns -> ``x * scale + shift`` per channel (column % C)."""
    if scale is None:
        return x2
    T, cdt = x2.shape[0], x2.dtype
    xa = x2.reshape(T, -1, channels) * scale.to(cdt) + shift.to(cdt)
    return xa.reshape(T, -1)


def psn_spike(x_seq, weight, bias, *, scale=None, shift=None):
    """Plain PyTorch twin of K2: ``H(W @ (x * scale + shift) + b)`` over
    [T, ..., C] with an optional per-channel (last axis) affine; computed in
    >= float32, 0/1 spikes returned in ``x_seq``'s dtype."""
    if scale is None:
        return psn_neuron(x_seq, weight, bias)
    cdt = torch.promote_types(x_seq.dtype, torch.float32)
    xa = x_seq.to(cdt) * scale.to(cdt) + shift.to(cdt)
    return psn_neuron(xa, weight, bias).to(x_seq.dtype)


# triton.language, bound by _kernel() at the first launch: the kernel below
# is compiled by triton.jit, which resolves ``tl`` in this module's globals
tl = None


def _psn_fwd(x_ptr, w_ptr, b_ptr, scale_ptr, shift_ptr, out_ptr, N, C,
             T: tl.constexpr, BLOCK_N: tl.constexpr, HAS_AFFINE: tl.constexpr):
    offs = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
    mask = offs < N
    if HAS_AFFINE:
        ch = offs % C
        sc = tl.load(scale_ptr + ch, mask=mask, other=0.0)
        sh = tl.load(shift_ptr + ch, mask=mask, other=0.0)
    for t in tl.static_range(T):
        h = tl.zeros([BLOCK_N], tl.float32) + tl.load(b_ptr + t)
        for s in tl.static_range(T):
            xs = tl.load(x_ptr + s * N + offs, mask=mask,
                         other=0.0).to(tl.float32)
            if HAS_AFFINE:
                xs = xs * sc + sh
            h += tl.load(w_ptr + t * T + s) * xs
        tl.store(out_ptr + t * N + offs,
                 (h >= 0.0).to(out_ptr.dtype.element_ty), mask=mask)


@functools.cache
def _kernel():
    global tl
    triton = import_triton()
    import triton.language
    tl = triton.language
    return triton, triton.jit(_psn_fwd)


def _site_params(x_seq, weight, bias, scale, shift, kernel):
    """Kernel-ready float32 (W, b, scale, shift); raises on what the
    kernels do not take."""
    T, C = x_seq.shape[0], x_seq.shape[-1]
    if weight.shape != (T, T) or bias.numel() != T:
        raise ValueError(f"{kernel}: PSN weight/bias do not match T={T}")
    if (scale is None) != (shift is None):
        raise ValueError(f"{kernel}: give both scale and shift, or neither")
    w = weight.to(torch.float32).contiguous()
    b = bias.to(torch.float32).reshape(T).contiguous()
    if scale is not None:
        if scale.numel() != C or shift.numel() != C:
            raise ValueError(f"{kernel}: scale/shift must have C={C} values")
        scale = scale.to(torch.float32).reshape(C).contiguous()
        shift = shift.to(torch.float32).reshape(C).contiguous()
    if any(t is not None and t.device != x_seq.device
           for t in (w, b, scale, shift)):
        raise ValueError(f"{kernel}: parameters must be on the input's "
                         "device")
    return w, b, scale, shift


def launch_k2(x_seq, weight, bias, *, scale=None, shift=None, out_dtype=None,
              kernel="K2"):
    """Launch K2's Triton kernel on a CUDA tensor [T, ...] (per-channel
    affine on the last axis, or none) and return the 0/1 spikes in
    ``out_dtype`` (default: the input's). Raises on what it does not take;
    counts nothing: each entry that launches it keeps its own count."""
    if not x_seq.is_cuda:
        raise ValueError(f"{kernel} runs on CUDA tensors, got {x_seq.device}")
    out_dtype = out_dtype or x_seq.dtype
    for name, dt in (("input", x_seq.dtype), ("output", out_dtype)):
        if dt not in (torch.float32, torch.bfloat16, torch.float16):
            raise TypeError(f"{kernel} takes float32/bfloat16/float16, got "
                            f"{name} {dt}")
    tensors = [x_seq, weight, bias] + ([] if scale is None
                                       else [scale, shift])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{kernel} is forward-only: call it under "
                                  "torch.no_grad() or inference_mode()")
    T = x_seq.shape[0]
    C = x_seq.shape[-1]
    w, b, sc, sh = _site_params(x_seq, weight, bias, scale, shift, kernel)
    if sc is None:
        sc = sh = b  # unused: HAS_AFFINE is False
    x = x_seq.contiguous()
    N = x.numel() // T
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    triton, kern = _kernel()
    with torch.cuda.device(x.device):
        kern[(triton.cdiv(N, BLOCK),)](
            x, w, b, sc, sh, out, N, C, T=T, BLOCK_N=BLOCK,
            HAS_AFFINE=scale is not None,
            num_warps=NUM_WARPS)
    return out.reshape(x_seq.shape)


def fused_affine_psn(x_seq, weight, bias, *, scale=None, shift=None):
    """PSN spikes of [T, ..., C] (optional per-channel affine on the last
    axis): K2 for a CUDA tensor, :func:`psn_spike` for a CPU tensor.
    Forward only: call it through :func:`affine_psn` for a gradient."""
    if x_seq.device.type == "cpu":
        return psn_spike(x_seq, weight, bias, scale=scale, shift=shift)
    out = launch_k2(x_seq, weight, bias, scale=scale, shift=shift)
    fused_affine_psn.launches += 1
    return out


fused_affine_psn.launches = 0


# ------------------------------------------------------------------ K2c

def psn_spike_tm_plain(x_seq, weight, bias):
    """Plain twin of K2c: ``H(W @ x + b)`` over the time axis of [T, ..., C],
    computed in >= float32, 0/1 spikes in ``x_seq``'s dtype."""
    return psn_neuron(x_seq, weight, bias)


def psn_spike_tm(x_seq, weight, bias):
    """K2c, the layout-native PSN + heaviside of
    ``sdformerflow_tpu/ops/pallas_psn.py:psn_spike_tm`` on time-major
    [T, ..., C]: K2's kernel with no affine for a CUDA tensor (it takes any
    column count, so there is no fallback geometry), the plain twin for a
    CPU tensor. Counted on its own ``launches``."""
    if x_seq.device.type == "cpu":
        return psn_spike_tm_plain(x_seq, weight, bias)
    out = launch_k2(x_seq, weight, bias, kernel="K2c")
    psn_spike_tm.launches += 1
    return out


psn_spike_tm.launches = 0


# ------------------------------------------------------------------ K2b

def psn_backward_plain(x_seq, g, weight, bias, *, scale=None, shift=None,
                       surrogate="atan", alpha=2.0):
    """Plain PyTorch twin of K2b (``_fused_bwd``'s kernel outputs): the
    saved pre-affine input ``x_seq`` [T, ..., C] and the spikes' cotangent
    ``g`` -> (dx in ``x_seq``'s shape and dtype, gh [T, N] in >= float32).
    The potential is recomputed exactly as :func:`psn_spike` computes it."""
    T, C = x_seq.shape[0], x_seq.shape[-1]
    cdt = torch.promote_types(x_seq.dtype, torch.float32)
    w = weight.to(cdt)
    xa = _affine(x_seq.reshape(T, -1).to(cdt), scale, shift, C)
    h = w @ xa + bias.to(cdt).reshape(T, 1)
    gh = g.reshape(T, -1).to(cdt) * surrogate_grad(surrogate)(h, alpha)
    dx = w.t() @ gh
    if scale is not None:
        dx = (dx.reshape(T, -1, C) * scale.to(cdt)).reshape(T, -1)
    return dx.to(x_seq.dtype).reshape(x_seq.shape), gh


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STEPS = 16   # the time steps csrc/psn_bwd.cu is instantiated for


@functools.cache
def _bwd_kernel_fn():
    fn = load_cuda_library("psn_bwd.cu").psn_bwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int64]
                   + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_psn_backward(x_seq, g, weight, bias, *, scale=None, shift=None,
                       surrogate="atan", alpha=2.0):
    """(dx, gh) of one PSN site: K2b for CUDA tensors,
    :func:`psn_backward_plain` for CPU tensors. K2b takes the ATan surrogate
    only; x and g float32 or bfloat16."""
    if x_seq.device.type == "cpu":
        return psn_backward_plain(x_seq, g, weight, bias, scale=scale,
                                  shift=shift, surrogate=surrogate,
                                  alpha=alpha)
    if not x_seq.is_cuda:
        raise ValueError(f"K2b runs on CUDA tensors, got {x_seq.device}")
    if surrogate_key(surrogate) != "atan":
        raise NotImplementedError(f"K2b computes the ATan surrogate, not "
                                  f"{surrogate!r}")
    if x_seq.dtype not in _DTYPE_CODES:
        raise TypeError(f"K2b takes float32 or bfloat16, got {x_seq.dtype}")
    T, C = x_seq.shape[0], x_seq.shape[-1]
    if not 1 <= T <= MAX_STEPS:
        raise ValueError(f"K2b takes 1-{MAX_STEPS} time steps, got {T}")
    if g.shape != x_seq.shape or g.device != x_seq.device:
        raise ValueError(f"K2b: cotangent {tuple(g.shape)} on {g.device} "
                         f"does not match x {tuple(x_seq.shape)}")
    w, b, sc, sh = _site_params(x_seq, weight, bias, scale, shift, "K2b")
    x = x_seq.contiguous()
    gc = g.to(x.dtype).contiguous()
    N = x.numel() // T
    dx = torch.empty_like(x)
    gh = torch.empty((T, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _bwd_kernel_fn()(
            x.data_ptr(), gc.data_ptr(), w.data_ptr(), b.data_ptr(),
            None if sc is None else sc.data_ptr(),
            None if sh is None else sh.data_ptr(),
            dx.data_ptr(), gh.data_ptr(), N, T, C, _DTYPE_CODES[x.dtype],
            alpha / 2.0, math.pi / 2.0 * alpha,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2b (psn_bwd) launch failed: CUDA error {err}")
    fused_psn_backward.launches += 1
    return dx.reshape(x_seq.shape), gh


fused_psn_backward.launches = 0


# ------------------------------------------------------- the VJP itself

class PSNImpl(NamedTuple):
    """The forward and backward a :class:`FusedAffinePSN` site runs."""
    forward: Callable    # (x, W, b, *, scale, shift) -> spikes
    backward: Callable   # (x, g, W, b, *, scale, shift, surrogate, alpha)
    #                      -> (dx, gh)


KERNELS = PSNImpl(fused_affine_psn, fused_psn_backward)
PLAIN = PSNImpl(psn_spike, psn_backward_plain)


def _param_grads(x_seq, gh, weight, bias, scale, shift):
    """dW, db, dscale, dshift from gh [T, N], as ``_fused_bwd`` reduces
    them outside its kernel (pallas_psn.py:139-155), with scale/shift per
    channel: dscale = sum over T and columns of channel c of (W^T gh) x."""
    T, C = x_seq.shape[0], x_seq.shape[-1]
    cdt = gh.dtype
    x2 = x_seq.reshape(T, -1).to(cdt)
    dw = (gh @ _affine(x2, scale, shift, C).t()).to(weight.dtype)
    db = gh.sum(dim=1).reshape(bias.shape).to(bias.dtype)
    if scale is None:
        return dw, db, None, None
    dxa = (weight.to(cdt).t() @ gh).reshape(T, -1, C)
    dscale = (dxa * x2.reshape(T, -1, C)).sum(dim=(0, 1))
    dshift = dxa.sum(dim=(0, 1))
    return (dw, db, dscale.reshape(scale.shape).to(scale.dtype),
            dshift.reshape(shift.shape).to(shift.dtype))


class FusedAffinePSN(torch.autograd.Function):
    """``spike = H(W @ (x * scale + shift) + b)`` with the surrogate
    gradient: inputs x [T, ..., C], W [T, T], b [T] or [T, 1], per-channel
    scale/shift [C] (or None), the surrogate's name and alpha, and the
    :class:`PSNImpl` to run (:data:`KERNELS` dispatches by device)."""

    @staticmethod
    def forward(ctx, x_seq, weight, bias, scale, shift, surrogate, alpha,
                impl):
        ctx.save_for_backward(x_seq, weight, bias, scale, shift)
        ctx.surrogate, ctx.alpha, ctx.impl = surrogate, alpha, impl
        return impl.forward(x_seq, weight, bias, scale=scale, shift=shift)

    @staticmethod
    def backward(ctx, g):
        x_seq, weight, bias, scale, shift = ctx.saved_tensors
        dx, gh = ctx.impl.backward(x_seq, g, weight, bias, scale=scale,
                                   shift=shift, surrogate=ctx.surrogate,
                                   alpha=ctx.alpha)
        grads = _param_grads(x_seq, gh, weight, bias, scale, shift)
        return (dx, *grads, None, None, None)


def affine_psn(x_seq, weight, bias, *, scale=None, shift=None,
               surrogate="atan", alpha=2.0, impl=KERNELS):
    """A differentiable PSN site (:class:`FusedAffinePSN`). With no gradient
    to record (serving runs under ``inference_mode``) it calls the forward
    alone, sparing the host the Function's dispatch at every site."""
    if not torch.is_grad_enabled() or not any(
            t is not None and t.requires_grad
            for t in (x_seq, weight, bias, scale, shift)):
        return impl.forward(x_seq, weight, bias, scale=scale, shift=shift)
    return FusedAffinePSN.apply(x_seq, weight, bias, scale, shift,
                                surrogate, alpha, impl)
