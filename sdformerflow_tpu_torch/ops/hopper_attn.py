"""K1: fused spiking-QK window attention (eval), CUDA C++ on Hopper.

Replaces the Pallas TPU kernel ``sdformerflow_tpu/ops/pallas_attn.py``
(``_kernel`` via ``fused_qk_attention``). The algebra is the JAX package's
pair-local re-derivation of the reference's raw-refold attention (header of
``pallas_attn.py``): the head-scrambled ``k * att_token`` product is
slab-local, and the output refold is one pair-regroup. The kernel
(``csrc/qk_attn.cu``) computes the interior - input PSN, q/k linears, BN
affine, positional encoding, q/k PSN, per-head token PSN and the product -
and the pair-regroup + proj linear + BN affine tail runs in torch here, as
it ran in XLA.

What bounds it on the card and what the design does about it is in the
source note of ``csrc/qk_attn.cu``. What the TPU kernel needed and this one
does not: block pickers, token padding 81 -> 84, 0/1 pooling-matrix dots
and the f32 large-C fallback.

Dispatch: :func:`fused_qk_attention` runs the kernel for a CUDA tensor (or
raises) and the plain twin :func:`qk_attention_pairlocal` for a CPU tensor.
Forward only: a CUDA call that would need gradients raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..kernel_build import load_cuda_library


class QKAttnParams(NamedTuple):
    """The attention's parameters in kernel-ready form.

    BN sites are eval affines ``y = a * x + c``; PSN sites are [2, 2]
    weights with [2] (or [2, 1]) biases; ``pe`` is the k positional
    encoding reshaped raw to [2, ns, C]; dense kernels are input-major
    ``[C_in, C_out]`` (``y = x @ w``).
    """

    w_in: torch.Tensor
    b_in: torch.Tensor
    wq: torch.Tensor
    aq: torch.Tensor
    cq: torch.Tensor
    w_q: torch.Tensor
    b_q: torch.Tensor
    wk: torch.Tensor
    ak: torch.Tensor
    ck: torch.Tensor
    pe: torch.Tensor
    w_k: torch.Tensor
    b_k: torch.Tensor
    w_t: torch.Tensor
    b_t: torch.Tensor
    wp: torch.Tensor
    bp: torch.Tensor
    ap: torch.Tensor
    cp: torch.Tensor


def bn_eval_affine(scale, bias, mean, var, eps=1e-5):
    """Eval BatchNorm as ``y = a * x + c``, statistics in >= float32."""
    cdt = torch.promote_types(var.dtype, torch.float32)
    a = scale.to(cdt) * torch.rsqrt(var.to(cdt) + eps)
    return a, bias.to(cdt) - mean.to(cdt) * a


def _psn2(x0, x1, w, b):
    """2-step PSN over an explicit pair: (spike_0, spike_1)."""
    b = b.reshape(2)
    h0 = w[0, 0] * x0 + w[0, 1] * x1 + b[0]
    h1 = w[1, 0] * x0 + w[1, 1] * x1 + b[1]
    return (h0 >= 0).to(h0.dtype), (h1 >= 0).to(h1.dtype)


def _check(x_windows, num_heads):
    wd, M, _, _, C = x_windows.shape
    if wd != 2 or M % 2:
        raise NotImplementedError(
            f"spiking-QK attention needs wd == 2 and an even window count, "
            f"got wd={wd}, M={M}")
    if C % num_heads:
        raise ValueError(f"C={C} is not a multiple of num_heads={num_heads}")


def qk_attn_interior_plain(x_windows, p: QKAttnParams, num_heads: int):
    """Plain PyTorch twin of the kernel: [2, M, wh, ww, C] -> the 0/1
    slab-local products [2, M, ns, C] in the input's dtype."""
    _check(x_windows, num_heads)
    _, M, wh, ww, C = x_windows.shape
    ns, nh, hd = wh * ww, num_heads, C // num_heads
    f32 = torch.promote_types(x_windows.dtype, torch.float32)
    xf = x_windows.reshape(2, M, ns, C).to(f32)
    xs0, xs1 = _psn2(xf[0], xf[1], p.w_in.to(f32), p.b_in.to(f32))

    def branch(w, a, c, pe=None):
        w, a, c = w.to(f32), a.to(f32), c.to(f32)
        y0 = a * (xs0 @ w) + c
        y1 = a * (xs1 @ w) + c
        if pe is not None:
            pe = pe.to(f32).reshape(2, ns, C)
            y0, y1 = y0 + pe[0], y1 + pe[1]
        return y0, y1

    q0, q1 = _psn2(*branch(p.wq, p.aq, p.cq), p.w_q.to(f32), p.b_q.to(f32))
    k0, k1 = _psn2(*branch(p.wk, p.ak, p.ck, p.pe), p.w_k.to(f32),
                   p.b_k.to(f32))
    # att_token: per (position, head) sum of hd consecutive q channels
    t0, t1 = _psn2(q0.reshape(M, ns, nh, hd).sum(-1),
                   q1.reshape(M, ns, nh, hd).sum(-1),
                   p.w_t.to(f32), p.b_t.to(f32))
    a0 = (k0.reshape(M, ns, nh, hd) * t0[..., None]).reshape(M, ns, C)
    a1 = (k1.reshape(M, ns, nh, hd) * t1[..., None]).reshape(M, ns, C)
    return torch.stack([a0, a1]).to(x_windows.dtype)


def qk_attn_tail(a, p: QKAttnParams, num_heads: int, shape, dtype):
    """Pair-regroup + proj linear + BN affine: [2, M, ns, C] -> ``shape``."""
    _, M, ns, C = a.shape
    nh, hd = num_heads, C // num_heads

    def regroup(ah):  # [M, ns, C] -> [2, M // 2, ns, C]
        v = ah.reshape(M // 2, nh, 2, ns, hd).permute(2, 0, 3, 1, 4)
        return v.reshape(2, M // 2, ns, C)

    f32 = torch.promote_types(dtype, torch.float32)
    out = torch.cat([regroup(a[0]), regroup(a[1])], dim=1).to(f32)
    out = out @ p.wp.to(f32) + p.bp.to(f32)
    out = p.ap.to(f32) * out + p.cp.to(f32)
    return out.reshape(shape).to(dtype)


def qk_attention_pairlocal(x_windows, p: QKAttnParams, num_heads: int):
    """Plain PyTorch attention forward: [2, M, wh, ww, C] -> same shape
    (pre window_reverse), the JAX ``qk_attention_pairlocal``."""
    a = qk_attn_interior_plain(x_windows, p, num_heads)
    return qk_attn_tail(a, p, num_heads, x_windows.shape, x_windows.dtype)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel_fn():
    fn = load_cuda_library("qk_attn.cu").qk_attn_forward
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _psn_row(w, b):
    return torch.cat([w.reshape(4), b.reshape(2)]).to(torch.float32)


def qk_attn_interior(x_windows, p: QKAttnParams, num_heads: int):
    """Launch K1 on a CUDA tensor: [2, M, wh, ww, C] (float32 or bfloat16)
    -> the 0/1 slab-local products [2, M, ns, C] in the input's dtype."""
    _check(x_windows, num_heads)
    if not x_windows.is_cuda:
        raise ValueError("qk_attn_interior runs on CUDA tensors only")
    if x_windows.dtype not in _DTYPE_CODES:
        raise TypeError(f"K1 takes float32 or bfloat16, got {x_windows.dtype}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_windows, *p)):
        raise NotImplementedError("K1 is forward-only: call it under "
                                  "torch.no_grad() or inference_mode()")
    _, M, wh, ww, C = x_windows.shape
    ns, dt = wh * ww, x_windows.dtype
    x = x_windows.contiguous()
    wq = p.wq.to(dt).contiguous()
    wk = p.wk.to(dt).contiguous()
    pe = p.pe.to(dt).reshape(2, ns, C).contiguous()
    affine = torch.stack([p.aq, p.cq, p.ak, p.ck]).to(torch.float32)
    psn = torch.cat([_psn_row(p.w_in, p.b_in), _psn_row(p.w_q, p.b_q),
                     _psn_row(p.w_k, p.b_k), _psn_row(p.w_t, p.b_t)])
    if wq.shape != (C, C) or wk.shape != (C, C) or affine.shape != (4, C):
        raise ValueError(f"K1 parameters do not match C={C}")
    if any(t.device != x.device for t in (wq, wk, pe, affine, psn)):
        raise ValueError("K1 parameters must be on the input's device")
    affine, psn = affine.contiguous(), psn.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            x.data_ptr(), wq.data_ptr(), wk.data_ptr(), pe.data_ptr(),
            affine.data_ptr(), psn.data_ptr(), out.data_ptr(),
            M * ns, C, num_heads, ns, _DTYPE_CODES[dt],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 (qk_attn_forward) launch failed: CUDA error "
                           f"{err}")
    qk_attn_interior.launches += 1
    return out.reshape(2, M, ns, C)


qk_attn_interior.launches = 0


def fused_qk_attention(x_windows, p: QKAttnParams, num_heads: int):
    """Attention forward [2, M, wh, ww, C] -> same shape: K1 + torch tail
    for a CUDA tensor, :func:`qk_attention_pairlocal` for a CPU tensor."""
    if x_windows.device.type == "cpu":
        return qk_attention_pairlocal(x_windows, p, num_heads)
    a = qk_attn_interior(x_windows, p, num_heads)
    return qk_attn_tail(a, p, num_heads, x_windows.shape, x_windows.dtype)
