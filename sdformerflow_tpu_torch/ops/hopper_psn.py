"""The fused PSN site: K2 (forward) and K2b (backward), CUDA C++ on Hopper.

Replaces the Pallas TPU kernel ``sdformerflow_tpu/ops/pallas_psn.py``:
``fused_affine_psn``, a ``jax.custom_vjp`` whose forward ``_fwd_kernel``
computes ``spike = H(W[T, T] @ (x * scale + shift) + b)`` over the leading
time axis of ``x`` viewed as [T, N], and whose backward ``_bwd_kernel``
recomputes the potential and applies the ATan surrogate, with the
parameter reductions left to XLA. Here :class:`FusedAffinePSN` is that VJP:
K2 forward, K2b backward. Both kernels live in one source,
``csrc/psn.cu``, which shares the potential's multiply-add order between
them and says what bounds them and what the design does about it. K2b
returns the whole VJP (dx, dW, db, dscale, dshift) from one pass over x and
the cotangent; the forward saves only x and the parameters, as
``_fused_fwd`` saves its residuals. Every PSN site of the port goes through
:func:`affine_psn`.

K2's kernel also serves the two other TPU forms of the same function,
which differ from ``_fwd_kernel`` only in their block layout (a PSN mixes
over the leading T axis whatever the trailing layout): K2c here
(:func:`psn_spike_tm`, ``pallas_psn.py:psn_spike_tm`` on [T, M, C]) and
K4a in ``ops/hopper_embed.py`` (``pallas_embed.py:psn_spike_cs`` on
channels-second [T, C, H, W]), both with no affine, each through
:func:`launch_k2` and counted on its own entry.

Dispatch: a CUDA tensor launches the kernels (or the call raises), a CPU
tensor runs the plain twins :func:`psn_spike`, :func:`psn_spike_tm_plain`
and :func:`psn_backward_plain`. The kernels are built when first launched.

K2 is also the custom op ``sdformerflow_torch::fused_affine_psn``
(:data:`fused_affine_psn_op`), with a fake form that gives its output's
shape and dtype. While ``torch.export`` traces, :func:`fused_affine_psn`
calls the op, so an exported program carries one op node per PSN site; the
op's real implementation dispatches by device like the eager call, which
goes straight to the launch. The train path's :class:`FusedAffinePSN`
(K2 with K2b) is not an op.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..kernel_build import load_cuda_library
from .neurons import psn_neuron
from .surrogate import surrogate_grad, surrogate_key


def _affine(x2, scale, shift, channels):
    """[T, N] columns -> ``x * scale + shift`` per channel (column % C)."""
    if scale is None:
        return x2
    T, cdt = x2.shape[0], x2.dtype
    xa = x2.reshape(T, -1, channels) * scale.to(cdt) + shift.to(cdt)
    return xa.reshape(T, -1)


def psn_spike(x_seq, weight, bias, *, scale=None, shift=None,
              return_v=False):
    """Plain PyTorch twin of K2: ``H(W @ (x * scale + shift) + b)`` over
    [T, ..., C] with an optional per-channel (last axis) affine; computed in
    >= float32, 0/1 spikes returned in ``x_seq``'s dtype. With
    ``return_v`` also the potential ``h`` (>= float32, ``x_seq``'s shape),
    the membrane ``psn_neuron(return_v=True)`` gives."""
    if scale is None:
        return psn_neuron(x_seq, weight, bias, return_v=return_v)
    cdt = torch.promote_types(x_seq.dtype, torch.float32)
    xa = x_seq.to(cdt) * scale.to(cdt) + shift.to(cdt)
    out = psn_neuron(xa, weight, bias, return_v=return_v)
    if return_v:
        return out[0].to(x_seq.dtype), out[1]
    return out.to(x_seq.dtype)


# dtype codes of csrc/psn.cu: x, g, dx and the spikes; W and b
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STEPS = 16   # the time steps csrc/psn.cu is instantiated for

# the C signatures of csrc/psn.cu's entry points (psn_fwd, psn_bwd,
# psn_bwd_workspace), in order; the last argument of the launches is the
# stream
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_F = ctypes.c_float
ARGTYPES = {
    "psn_fwd": [_P] * 7 + [_I64] + [_I] * 5 + [_P],
    "psn_bwd": [_P] * 9 + [_I64, _I64] + [_I] * 4 + [_F] * 2 + [_P],
    "psn_bwd_workspace": [_I64] + [_I] * 4,
}
RESTYPES = {"psn_fwd": _I, "psn_bwd": _I, "psn_bwd_workspace": _I64}


@functools.cache
def _lib():
    lib = load_cuda_library("psn.cu")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, RESTYPES[name]
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_site(x_seq, weight, bias, scale, shift, kernel):
    """Raise on what csrc/psn.cu does not take; returns (T, C, N).
    Checks dtypes and sizes before the device, so that a CPU tensor tells
    the same story."""
    T, C = x_seq.shape[0], x_seq.shape[-1]
    if x_seq.dtype not in _DTYPE_CODES:
        raise TypeError(f"{kernel} takes float32 or bfloat16, got "
                        f"{x_seq.dtype}")
    if not 1 <= T <= MAX_STEPS:
        raise ValueError(f"{kernel} takes 1-{MAX_STEPS} time steps, got {T}")
    if weight.shape != (T, T) or bias.numel() != T:
        raise ValueError(f"{kernel}: PSN weight/bias do not match T={T}")
    if weight.dtype not in _DTYPE_CODES or bias.dtype != weight.dtype:
        raise TypeError(f"{kernel} takes W and b both float32 or both "
                        f"bfloat16, got {weight.dtype} and {bias.dtype}")
    if (scale is None) != (shift is None):
        raise ValueError(f"{kernel}: give both scale and shift, or neither")
    if scale is not None:
        if scale.numel() != C or shift.numel() != C:
            raise ValueError(f"{kernel}: scale/shift must have C={C} values")
        if scale.dtype != torch.float32 or shift.dtype != torch.float32:
            raise TypeError(f"{kernel} takes a float32 scale and shift, got "
                            f"{scale.dtype} and {shift.dtype}")
    params = [weight, bias] + ([] if scale is None else [scale, shift])
    if not x_seq.is_cuda:
        raise ValueError(f"{kernel} runs on CUDA tensors, got {x_seq.device}")
    if any(t.device != x_seq.device or not t.is_contiguous() for t in params):
        raise ValueError(f"{kernel}: parameters must be contiguous, on the "
                         "input's device")
    return T, C, x_seq.numel() // T


def _launch(kernel, fn, args, device):
    """Call a csrc/psn.cu entry on ``device``'s current stream; raise if
    the launch failed."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def _forward_only(kernel, tensors):
    """Raise if a forward-only call would have to record a gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(f"{kernel} is forward-only: call it under "
                                  "torch.no_grad() or inference_mode()")


def k2_args(x, weight, bias, scale, shift, out, h=None):
    """The arguments of ``psn_fwd`` before the stream, for contiguous
    tensors that :func:`prepare_k2` has checked (``h``: the float32
    potential's output, or None)."""
    T, C = x.shape[0], x.shape[-1]
    return (x.data_ptr(), weight.data_ptr(), bias.data_ptr(), _ptr(scale),
            _ptr(shift), out.data_ptr(), _ptr(h), x.numel() // T, T, C,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype],
            _DTYPE_CODES[out.dtype])


def prepare_k2(x_seq, weight, bias, *, scale=None, shift=None,
               out_dtype=None, kernel="K2", return_v=False):
    """Check one K2 launch on CUDA tensors (x [T, ...] with an optional
    per-channel affine on the last axis, W and b float32 or bfloat16, scale
    and shift float32) and return ``(launch, out)``: each call of
    ``launch()`` runs the kernel once into ``out``, the 0/1 spikes in
    ``out_dtype`` (default: the input's), and raises if the launch fails;
    it counts nothing. With ``return_v`` ``out`` is ``(spikes, h)``, the
    kernel also writing the float32 potential ``h`` in ``x_seq``'s shape.
    ``chip_smoke.py`` times ``launch``, the kernel alone."""
    out_dtype = out_dtype or x_seq.dtype
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"{kernel} writes float32 or bfloat16, got "
                        f"{out_dtype}")
    _check_site(x_seq, weight, bias, scale, shift, kernel)
    _forward_only(kernel, (x_seq, weight, bias, scale, shift))
    x = x_seq.contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    h = (torch.empty(x.shape, dtype=torch.float32, device=x.device)
         if return_v else None)
    args = k2_args(x, weight, bias, scale, shift, out, h)
    fn = _lib().psn_fwd

    def launch():
        _launch(kernel, fn, args, x.device)
        return x, out, h   # alive as long as the closure

    return launch, ((out, h) if return_v else out)


def launch_k2(x_seq, weight, bias, *, scale=None, shift=None, out_dtype=None,
              kernel="K2", return_v=False):
    """Launch K2's kernel once (:func:`prepare_k2`) and return the spikes
    (with ``return_v``, the spikes and the float32 potential). Counts
    nothing: each entry that launches it keeps its own count."""
    launch, out = prepare_k2(x_seq, weight, bias, scale=scale, shift=shift,
                             out_dtype=out_dtype, kernel=kernel,
                             return_v=return_v)
    launch()
    return out


def _site(x_seq: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
          out_dtype: torch.dtype) -> torch.Tensor:
    """The real implementation of :data:`fused_affine_psn_op`: K2 for a
    CUDA tensor (counted on :func:`fused_affine_psn`), :func:`psn_spike`
    for a CPU tensor; the spikes in ``out_dtype``."""
    if x_seq.device.type == "cpu":
        return psn_spike(x_seq, weight, bias, scale=scale,
                         shift=shift).to(out_dtype)
    out = launch_k2(x_seq, weight, bias, scale=scale, shift=shift,
                    out_dtype=out_dtype)
    fused_affine_psn.launches += 1
    return out


fused_affine_psn_op = torch.library.custom_op(
    "sdformerflow_torch::fused_affine_psn", _site, mutates_args=())


@fused_affine_psn_op.register_fake
def _(x_seq, weight, bias, scale, shift, out_dtype):
    return x_seq.new_empty(x_seq.shape, dtype=out_dtype)


def fused_affine_psn(x_seq, weight, bias, *, scale=None, shift=None,
                     return_v=False):
    """PSN spikes of [T, ..., C] (optional per-channel affine on the last
    axis): K2 for a CUDA tensor, :func:`psn_spike` for a CPU tensor;
    while traced, :data:`fused_affine_psn_op`. Forward only: call it
    through :func:`affine_psn` for a gradient.

    ``return_v`` (the membrane telemetry) returns ``(spikes, h)``, the
    potential in float32 (float64 stays float64 on the CPU): K2 writes it
    from the registers that thresholded it. The custom op has no such
    output, so a traced call with ``return_v`` raises."""
    if return_v:
        if torch.compiler.is_compiling():
            raise NotImplementedError("K2's membrane output is eager only: "
                                      "an exported program collects no "
                                      "telemetry")
        if x_seq.device.type == "cpu":
            return psn_spike(x_seq, weight, bias, scale=scale, shift=shift,
                             return_v=True)
        out = launch_k2(x_seq, weight, bias, scale=scale, shift=shift,
                        return_v=True)
        fused_affine_psn.launches += 1
        return out
    if torch.compiler.is_compiling():
        _forward_only("K2", (x_seq, weight, bias, scale, shift))
        return fused_affine_psn_op(x_seq, weight, bias, scale, shift,
                                   x_seq.dtype)
    return _site(x_seq, weight, bias, scale, shift, x_seq.dtype)


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

def psn_backward_gh(x_seq, g, weight, bias, *, scale=None, shift=None,
                    surrogate="atan", alpha=2.0):
    """``gh = g * surrogate'(h)`` [T, N] in >= float32, the potential
    recomputed exactly as :func:`psn_spike` computes it: what ``_fused_bwd``'s
    Pallas kernel writes (pallas_psn.py:52) and K2b keeps in registers."""
    T, C = x_seq.shape[0], x_seq.shape[-1]
    cdt = torch.promote_types(x_seq.dtype, torch.float32)
    w = weight.to(cdt)
    xa = _affine(x_seq.reshape(T, -1).to(cdt), scale, shift, C)
    h = w @ xa + bias.to(cdt).reshape(T, 1)
    return g.reshape(T, -1).to(cdt) * surrogate_grad(surrogate)(h, alpha)


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


def psn_backward_plain(x_seq, g, weight, bias, *, scale=None, shift=None,
                       surrogate="atan", alpha=2.0):
    """Plain PyTorch twin of K2b, the whole VJP of one site (what
    ``_fused_bwd`` returns): the saved pre-affine input ``x_seq``
    [T, ..., C] and the spikes' cotangent ``g`` -> (dx in ``x_seq``'s shape
    and dtype, dW, db, dscale, dshift in the shapes and dtypes of the
    parameters; dscale and dshift None with no affine)."""
    T, C = x_seq.shape[0], x_seq.shape[-1]
    gh = psn_backward_gh(x_seq, g, weight, bias, scale=scale, shift=shift,
                         surrogate=surrogate, alpha=alpha)
    dx = weight.to(gh.dtype).t() @ gh
    if scale is not None:
        dx = (dx.reshape(T, -1, C) * scale.to(gh.dtype)).reshape(T, -1)
    return (dx.to(x_seq.dtype).reshape(x_seq.shape),
            *_param_grads(x_seq, gh, weight, bias, scale, shift))


def k2b_args(x, g, weight, bias, scale, shift, dx, grads, ws, alpha):
    """The arguments of ``psn_bwd`` before the stream, for contiguous
    tensors that :func:`prepare_k2b` has checked."""
    T, C = x.shape[0], x.shape[-1]
    return (x.data_ptr(), g.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            _ptr(scale), _ptr(shift), dx.data_ptr(), grads.data_ptr(),
            ws.data_ptr(), ws.numel(), x.numel() // T, T, C,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype], alpha / 2.0,
            math.pi / 2.0 * alpha)


def prepare_k2b(x_seq, g, weight, bias, *, scale=None, shift=None,
                surrogate="atan", alpha=2.0):
    """Check one K2b launch on CUDA tensors and return ``(launch, grads)``:
    each call of ``launch()`` runs the site's backward once (two kernels:
    the site, then the sums over its blocks) and raises if the launch
    fails; ``grads`` = (dx, dW, db, dscale, dshift) as
    :func:`psn_backward_plain` returns them, the reductions float32 (cast to
    the parameters' dtypes by :func:`fused_psn_backward`). Counts nothing."""
    if surrogate_key(surrogate) != "atan":
        raise NotImplementedError(f"K2b computes the ATan surrogate, not "
                                  f"{surrogate!r}")
    T, C, N = _check_site(x_seq, weight, bias, scale, shift, "K2b")
    if g.shape != x_seq.shape or g.device != x_seq.device:
        raise ValueError(f"K2b: cotangent {tuple(g.shape)} on {g.device} "
                         f"does not match x {tuple(x_seq.shape)}")
    x = x_seq.contiguous()
    gc = g.to(x.dtype).contiguous()
    affine = scale is not None
    lib = _lib()
    n_ws = lib.psn_bwd_workspace(N, T, C, int(affine), _DTYPE_CODES[x.dtype])
    dx = torch.empty_like(x)
    grads = torch.empty(T * T + T + (2 * C if affine else 0),
                        dtype=torch.float32, device=x.device)
    ws = torch.empty(max(n_ws, 1), dtype=torch.float32, device=x.device)
    args = k2b_args(x, gc, weight, bias, scale, shift, dx, grads, ws, alpha)
    fn = lib.psn_bwd

    def launch():
        _launch("K2b", fn, args, x.device)
        return x, gc, dx, grads, ws   # alive as long as the closure

    dw, db = grads[:T * T].view(T, T), grads[T * T:T * T + T]
    dscale = grads[T * T + T:T * T + T + C] if affine else None
    dshift = grads[T * T + T + C:] if affine else None
    return launch, (dx.reshape(x_seq.shape), dw, db, dscale, dshift)


def _like(grad, param):
    """``grad`` in ``param``'s shape and dtype (no copy when they match)."""
    if grad is None:
        return None
    return grad.reshape(param.shape).to(param.dtype)


def fused_psn_backward(x_seq, g, weight, bias, *, scale=None, shift=None,
                       surrogate="atan", alpha=2.0):
    """(dx, dW, db, dscale, dshift) of one PSN site: K2b for CUDA tensors,
    :func:`psn_backward_plain` for CPU tensors. K2b takes the ATan surrogate
    only; x and g float32 or bfloat16."""
    if x_seq.device.type == "cpu":
        return psn_backward_plain(x_seq, g, weight, bias, scale=scale,
                                  shift=shift, surrogate=surrogate,
                                  alpha=alpha)
    launch, (dx, dw, db, dscale, dshift) = prepare_k2b(
        x_seq, g, weight, bias, scale=scale, shift=shift,
        surrogate=surrogate, alpha=alpha)
    launch()
    fused_psn_backward.launches += 1
    return (dx, _like(dw, weight), _like(db, bias), _like(dscale, scale),
            _like(dshift, shift))


fused_psn_backward.launches = 0


# ------------------------------------------------------- the VJP itself

class PSNImpl(NamedTuple):
    """The forward and backward a :class:`FusedAffinePSN` site runs."""
    forward: Callable    # (x, W, b, *, scale, shift) -> spikes
    backward: Callable   # (x, g, W, b, *, scale, shift, surrogate, alpha)
    #                      -> (dx, dW, db, dscale, dshift)


KERNELS = PSNImpl(fused_affine_psn, fused_psn_backward)
PLAIN = PSNImpl(psn_spike, psn_backward_plain)


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
        grads = ctx.impl.backward(x_seq, g, weight, bias, scale=scale,
                                  shift=shift, surrogate=ctx.surrogate,
                                  alpha=ctx.alpha)
        return (*grads, None, None, None)


def affine_psn(x_seq, weight, bias, *, scale=None, shift=None,
               surrogate="atan", alpha=2.0, impl=KERNELS, return_v=False):
    """A differentiable PSN site (:class:`FusedAffinePSN`). With no gradient
    to record (serving runs under ``inference_mode``) it calls the forward
    alone, sparing the host the Function's dispatch at every site.
    ``return_v`` (the membrane telemetry, forward only) also returns the
    potential ``h``."""
    recording = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x_seq, weight, bias, scale, shift))
    if return_v:
        if recording:
            raise NotImplementedError("the PSN membrane output is forward "
                                      "only: collect it under "
                                      "torch.no_grad() or inference_mode()")
        return impl.forward(x_seq, weight, bias, scale=scale, shift=shift,
                            return_v=True)
    if not recording:
        return impl.forward(x_seq, weight, bias, scale=scale, shift=shift)
    return FusedAffinePSN.apply(x_seq, weight, bias, scale, shift,
                                surrogate, alpha, impl)
