"""K2: fused [per-channel affine -> PSN time mix -> spike] (forward), Triton.

Replaces the forward of the Pallas TPU kernel
``sdformerflow_tpu/ops/pallas_psn.py`` (``_fwd_kernel`` via
``fused_affine_psn`` / ``psn_spike``): ``spike = H(W[T, T] @ (x * scale +
shift) + b)`` over the leading time axis of ``x`` viewed as [T, N]. The
JAX path left this chain to XLA's fusion; eager PyTorch would run it as
three or four passes over tensors of up to ~100 MB at T=10, so it is a
kernel here.

What bounds it on H100: memory. Each column reads T values and writes T
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

Dispatch: :func:`fused_affine_psn` launches the kernel for a CUDA tensor (or
raises) and runs the plain twin :func:`psn_spike` for a CPU tensor. Triton
is imported only when the kernel is launched. Forward only.
"""

from __future__ import annotations

import functools

import torch

from ..kernel_build import import_triton
from .neurons import psn_neuron

BLOCK = 1024
NUM_WARPS = 8


def psn_spike(x_seq, weight, bias, *, scale=None, shift=None):
    """Plain PyTorch twin: ``H(W @ (x * scale + shift) + b)`` over
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


def fused_affine_psn(x_seq, weight, bias, *, scale=None, shift=None):
    """PSN spikes of [T, ..., C] (optional per-channel affine on the last
    axis): K2 for a CUDA tensor, :func:`psn_spike` for a CPU tensor."""
    if x_seq.device.type == "cpu":
        return psn_spike(x_seq, weight, bias, scale=scale, shift=shift)
    if not x_seq.is_cuda:
        raise ValueError(f"K2 runs on CUDA tensors, got {x_seq.device}")
    if x_seq.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"K2 takes float32/bfloat16/float16, got "
                        f"{x_seq.dtype}")
    tensors = [x_seq, weight, bias] + ([] if scale is None
                                       else [scale, shift])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("K2 is forward-only: call it under "
                                  "torch.no_grad() or inference_mode()")
    T = x_seq.shape[0]
    C = x_seq.shape[-1]
    if weight.shape != (T, T) or bias.numel() != T:
        raise ValueError(f"PSN weight/bias do not match T={T}")
    x = x_seq.contiguous()
    N = x.numel() // T
    w = weight.to(torch.float32).contiguous()
    b = bias.to(torch.float32).reshape(T).contiguous()
    if scale is not None:
        sc = scale.to(torch.float32).reshape(C).contiguous()
        sh = shift.to(torch.float32).reshape(C).contiguous()
    else:
        sc = sh = b  # unused: HAS_AFFINE is False
    if any(t.device != x.device for t in (w, b, sc, sh)):
        raise ValueError("K2 parameters must be on the input's device")
    out = torch.empty_like(x)
    triton, kernel = _kernel()
    with torch.cuda.device(x.device):
        kernel[(triton.cdiv(N, BLOCK),)](
            x, w, b, sc, sh, out, N, C, T=T, BLOCK_N=BLOCK,
            HAS_AFFINE=scale is not None,
            num_warps=NUM_WARPS)
    fused_affine_psn.launches += 1
    return out.reshape(x_seq.shape)


fused_affine_psn.launches = 0
