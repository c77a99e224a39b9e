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
source note of ``csrc/qk_attn.cu``: in bfloat16 the q/k products run on
the tensor cores (wgmma) against [Wq | Wk] re-laid by
:func:`pack_qk_weight`; float32 keeps the CUDA-core kernel. What the TPU
kernel needed and this one does not: block pickers, token padding 81 -> 84,
0/1 pooling-matrix dots and the f32 large-C fallback.

Dispatch: :func:`fused_qk_attention` runs the kernel for a CUDA tensor (or
raises) and the plain twin :func:`qk_attention_pairlocal` for a CPU tensor.
Forward only: a CUDA call that would need gradients raises.

The interior is also the custom op ``sdformerflow_torch::qk_attn_interior``
(:data:`qk_attn_interior_op`), with a fake form that gives its output's
shape. While ``torch.export`` (or ``torch.compile``) traces,
:func:`fused_qk_attention` calls the op, so an exported program carries one
op node per attention site; the op's real implementation dispatches by
device like the eager call, which goes straight to the launch (the op's
Python dispatch costs host time at every site, PERF.md section 5).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple

import torch
import torch.nn.functional as F

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


# the fields of QKAttnParams the interior reads (w_in ... b_t); the last
# four (wp, bp, ap, cp) are the tail's
N_INTERIOR = len(QKAttnParams._fields) - 4


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


def _forward_only(tensors):
    """Raise if a K1 call would have to record a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("K1 is forward-only: call it under "
                                  "torch.no_grad() or inference_mode()")


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
_BF16_CUDA_CORES = 2   # the kernel entry's code of the bf16 CUDA-core path


def _kernel_code(dtype, cuda_cores):
    return (_BF16_CUDA_CORES if cuda_cores and dtype == torch.bfloat16
            else _DTYPE_CODES[dtype])


# the bf16 kernel's tiles (csrc/qk_attn.cu, namespace tc): output channels
# a block, input channels a K chunk
QK_GROUP = 32
QK_KCHUNK = 64


def pack_qk_weight(wq, wk):
    """[Wq | Wk] (input-major [C, C]) as the bf16 kernel's shared-memory
    image: [ceil(C / 32), ceil(C / 64), 8, 64, 8], zero-padded. Entry
    (g, kc, kg, n, kk) is Wq[k, c] for n < 32 and Wk[k, c] after, with input
    channel k = 64 kc + 8 kg + kk and output channel c = 32 g + n % 32: per
    channel group g and K chunk kc, 8 K-major core matrices of 64 rows [q |
    k] x 8 input channels."""
    C = wq.shape[0]
    if wq.shape != (C, C) or wk.shape != (C, C):
        raise ValueError(f"pack_qk_weight takes two [C, C] weights, got "
                         f"{tuple(wq.shape)} and {tuple(wk.shape)}")
    ng, nk = -(-C // QK_GROUP), -(-C // QK_KCHUNK)
    z = F.pad(torch.stack([wq, wk], 1),
              (0, ng * QK_GROUP - C, 0, 0, 0, nk * QK_KCHUNK - C))
    z = z.reshape(nk, QK_KCHUNK // 8, 8, 2, ng, QK_GROUP)
    return z.permute(4, 0, 1, 3, 5, 2).reshape(
        ng, nk, QK_KCHUNK // 8, 2 * QK_GROUP, 8).contiguous()


@functools.cache
def _kernel_fn():
    fn = load_cuda_library("qk_attn.cu").qk_attn_forward
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _aligned(t):
    """``t``, copied when its data does not start on 16 bytes (the
    kernels' vector loads)."""
    return t.clone() if t.data_ptr() % 16 else t


def _psn_rows(p: QKAttnParams):
    """The kernel's [4, 6] PSN table in one cat: (w00, w01, w10, w11, b0,
    b1) of the input, q, k and token neurons, float32."""
    return torch.cat([t.reshape(-1) for t in (
        p.w_in, p.b_in, p.w_q, p.b_q, p.w_k, p.b_k, p.w_t, p.b_t)]).to(
            torch.float32)


def prepare_qk_attn_interior(x_windows, p: QKAttnParams, num_heads: int,
                             *, cuda_cores=False):
    """Check and lay out one K1 launch on CUDA tensors (the arguments of
    :func:`qk_attn_interior`): returns ``(launch, out)``, where each call of
    ``launch()`` runs the kernel once on these arguments into ``out``
    ([2, M, ns, C]) and raises if the launch fails; it counts no launch.
    ``cuda_cores=True`` lays a bfloat16 input out for the CUDA-core kernel
    instead (K1's first version). ``chip_smoke.py`` times ``launch``, the
    kernel alone, and that yardstick beside it."""
    _check(x_windows, num_heads)
    if not x_windows.is_cuda:
        raise ValueError("qk_attn_interior runs on CUDA tensors only")
    if x_windows.dtype not in _DTYPE_CODES:
        raise TypeError(f"K1 takes float32 or bfloat16, got {x_windows.dtype}")
    _forward_only((x_windows, *(t for t in p if t is not None)))
    _, M, wh, ww, C = x_windows.shape
    ns, dt = wh * ww, x_windows.dtype
    x = _aligned(x_windows.contiguous())
    wq, wk = p.wq.to(dt), p.wk.to(dt)
    pe = p.pe.to(dt).reshape(2, ns, C).contiguous()
    affine = torch.stack([p.aq, p.cq, p.ak, p.ck]).to(torch.float32)
    psn = _psn_rows(p)
    if (wq.shape != (C, C) or wk.shape != (C, C) or affine.shape != (4, C)
            or psn.shape != (24,)):
        raise ValueError(f"K1 parameters do not match C={C}")
    if any(t.device != x.device for t in (wq, wk, pe, affine, psn)):
        raise ValueError("K1 parameters must be on the input's device")
    affine, psn = affine.contiguous(), psn.contiguous()
    if dt == torch.bfloat16 and not cuda_cores:   # tensor cores
        wq, wk, wpk = None, None, pack_qk_weight(wq, wk)
    else:
        wq, wk, wpk = wq.contiguous(), wk.contiguous(), None
    out = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (x.data_ptr(), ptr(wq), ptr(wk), ptr(wpk), pe.data_ptr(),
            affine.data_ptr(), psn.data_ptr(), out.data_ptr(), M * ns, C,
            num_heads, ns, _kernel_code(dt, cuda_cores))
    keep = (x, wq, wk, wpk, pe, affine, psn)   # alive as long as the closure

    def launch():
        with torch.cuda.device(out.device):
            err = _kernel_fn()(
                *args, torch.cuda.current_stream(out.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"K1 (qk_attn_forward) launch failed: CUDA "
                               f"error {err}")
        return keep

    return launch, out.reshape(2, M, ns, C)


def qk_attn_interior(x_windows, p: QKAttnParams, num_heads: int):
    """Launch K1 on a CUDA tensor: [2, M, wh, ww, C] (float32 or bfloat16)
    -> the 0/1 slab-local products [2, M, ns, C] in the input's dtype.
    bfloat16 runs the tensor-core kernel on :func:`pack_qk_weight`'s
    layout, float32 the CUDA-core kernel; both count on ``launches``."""
    launch, out = prepare_qk_attn_interior(x_windows, p, num_heads)
    launch()
    qk_attn_interior.launches += 1
    return out


qk_attn_interior.launches = 0


def _interior(x_windows: torch.Tensor, params: List[torch.Tensor],
              num_heads: int) -> torch.Tensor:
    """The real implementation of :data:`qk_attn_interior_op`: K1 for a
    CUDA tensor (counted on :func:`qk_attn_interior`), the plain twin for a
    CPU tensor. ``params`` are QKAttnParams' first :data:`N_INTERIOR`
    fields, in order."""
    p = QKAttnParams(*params, *(None,) * (len(QKAttnParams._fields)
                                          - N_INTERIOR))
    if x_windows.device.type == "cpu":
        return qk_attn_interior_plain(x_windows, p, num_heads)
    return qk_attn_interior(x_windows, p, num_heads)


qk_attn_interior_op = torch.library.custom_op(
    "sdformerflow_torch::qk_attn_interior", _interior, mutates_args=())


@qk_attn_interior_op.register_fake
def _(x_windows, params, num_heads):
    _check(x_windows, num_heads)
    _, M, wh, ww, C = x_windows.shape
    return x_windows.new_empty((2, M, wh * ww, C))


def fused_qk_attention(x_windows, p: QKAttnParams, num_heads: int):
    """Attention forward [2, M, wh, ww, C] -> same shape: K1 + torch tail
    for a CUDA tensor, :func:`qk_attention_pairlocal` for a CPU tensor;
    while traced, :data:`qk_attn_interior_op` + the tail."""
    if torch.compiler.is_compiling():
        _forward_only((x_windows, *p))
        a = qk_attn_interior_op(x_windows, list(p[:N_INTERIOR]), num_heads)
    elif x_windows.device.type == "cpu":
        return qk_attention_pairlocal(x_windows, p, num_heads)
    else:
        a = qk_attn_interior(x_windows, p, num_heads)
    return qk_attn_tail(a, p, num_heads, x_windows.shape, x_windows.dtype)
