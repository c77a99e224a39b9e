"""The channels-second patch-embed kernels: K4 (convolution + affine, CUDA
C++) and K4a (PSN spikes, K2's Triton kernel), and the fused-embed eval
forward they compose.

Replaces the Pallas TPU kernels of ``sdformerflow_tpu/ops/pallas_embed.py``:

- K4, ``conv3x3_affine_cs`` (``_conv_cs_kernel``): a 3x3 or 1x1 SAME
  convolution with a per-output-channel affine ``acc * a + b`` (the folded
  eval BN, or a conv bias). Here ``csrc/conv_cs.cu``, on NCHW-ordered
  ``[N, Cin, H, W]`` with N = T * B (channels-second is PyTorch's NCHW with
  time folded into the batch) and OIHW weights; it also takes an output
  stride of 2, computing only the outputs the stride keeps. Its source note
  says what bounds it and what its design does about that.
- K4a, ``psn_spike_cs`` (``_psn_cs_kernel``): ``H(W[T, T] x + b)`` over the
  leading T axis with no affine. That is K2's function on the ``[T, rest]``
  view, so it launches K2's kernel (``ops/hopper_psn.py:launch_k2``), with
  the output dtype free.

:func:`fused_embed_forward` is ``pallas_embed.py:fused_embed_forward``: the
eval forward of ``MSPEDSpikingPatchEmbedConvSfn`` through these two
kernels, fed to the network through its ``pre_embedded`` input
(``training/train_step.py:make_eval_step(fused_embed=True)``).

Dispatch: a CUDA tensor launches the kernel (or the call raises), a CPU
tensor runs the plain twin. K4 is built, and Triton imported, only when a
kernel is first launched.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..kernel_build import load_cuda_library
from ..models.spiking_patch_embed import sfn_regroup
from .hopper_psn import launch_k2
from .neurons import psn_neuron

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------------- K4

def conv3x3_affine_cs_plain(x, weight, scale=None, shift=None, *, stride=1):
    """Plain twin of K4: ``F.conv2d`` (SAME padding, ``stride``) in >=
    float32 on the weight rounded to ``x``'s dtype (as the TPU kernel casts
    its kernel to the input's), then ``* scale + shift`` per output channel,
    then the cast to ``x``'s dtype."""
    cdt = torch.promote_types(x.dtype, torch.float32)
    k = weight.shape[-1]
    y = F.conv2d(x.to(cdt), weight.to(x.dtype).to(cdt), stride=stride,
                 padding=k // 2)
    if scale is not None:
        y = y * scale.to(cdt).reshape(-1, 1, 1)
    if shift is not None:
        y = y + shift.to(cdt).reshape(-1, 1, 1)
    return y.to(x.dtype)


@functools.cache
def _conv_fn():
    fn = load_cuda_library("conv_cs.cu").conv_cs
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _affine_vector(v, cout, device, name):
    if v is None:
        return None
    if v.numel() != cout or v.device != device:
        raise ValueError(f"K4: {name} must hold Cout={cout} values on the "
                         f"input's device")
    return v.to(torch.float32).reshape(cout).contiguous()


def conv3x3_affine_cs(x, weight, scale=None, shift=None, *, stride=1):
    """K4: ``x`` [N, Cin, H, W], ``weight`` OIHW [Cout, Cin, k, k] with k 3
    or 1 (SAME padding), ``scale``/``shift`` [Cout] (None: 1 / 0), output
    stride 1 or 2 -> [N, Cout, ceil(H / stride), ceil(W / stride)] in
    ``x``'s dtype. A CUDA tensor launches the kernel (float32 or bfloat16),
    a CPU tensor runs :func:`conv3x3_affine_cs_plain`. Forward only."""
    if x.device.type == "cpu":
        return conv3x3_affine_cs_plain(x, weight, scale, shift,
                                       stride=stride)
    if not x.is_cuda:
        raise ValueError(f"K4 runs on CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"K4 takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"K4 takes x [N, Cin, H, W] and an OIHW weight, got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    N, cin, H, W = x.shape
    cout, wcin, k, k2 = weight.shape
    if wcin != cin or k != k2 or k not in (1, 3):
        raise ValueError(f"K4 takes a [Cout, {cin}, k, k] weight with k 1 or "
                         f"3, got {tuple(weight.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"K4 takes an output stride of 1 or 2, got {stride}")
    if weight.device != x.device:
        raise ValueError("K4: the weight must be on the input's device")
    tensors = [t for t in (x, weight, scale, shift) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("K4 is forward-only: call it under "
                                  "torch.no_grad() or inference_mode()")
    a = _affine_vector(scale, cout, x.device, "scale")
    b = _affine_vector(shift, cout, x.device, "shift")
    xc = x.contiguous()
    w = weight.to(x.dtype).contiguous()
    out = torch.empty((N, cout, (H - 1) // stride + 1, (W - 1) // stride + 1),
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _conv_fn()(
            xc.data_ptr(), w.data_ptr(), None if a is None else a.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), N, cin,
            cout, H, W, k, stride, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K4 (conv_cs) launch failed: CUDA error {err}")
    conv3x3_affine_cs.launches += 1
    return out


conv3x3_affine_cs.launches = 0


# ------------------------------------------------------------------ K4a

def psn_spike_cs_plain(x, weight, bias, out_dtype=None):
    """Plain twin of K4a: ``H(W @ x + b)`` over the leading T axis of
    [T, ...] in >= float32, 0/1 spikes in ``out_dtype`` (default ``x``'s)."""
    return psn_neuron(x, weight, bias).to(out_dtype or x.dtype)


def psn_spike_cs(x, weight, bias, out_dtype=None):
    """K4a: PSN + heaviside on channels-second [T, C, H, W] (any trailing
    layout: the mix runs over T), ``weight`` [T, T], ``bias`` [T] or
    [T, 1]. K2's kernel with no affine for a CUDA tensor, the plain twin for
    a CPU tensor. Counted on its own ``launches``."""
    if x.device.type == "cpu":
        return psn_spike_cs_plain(x, weight, bias, out_dtype)
    out = launch_k2(x, weight, bias, out_dtype=out_dtype, kernel="K4a")
    psn_spike_cs.launches += 1
    return out


psn_spike_cs.launches = 0


# ------------------------------------------------------- the fused embed

def _conv_site(x, conv, norm, *, stride=1):
    """K4 at one conv (+ eval BN) site of ``x`` [T * B, Cin, H, W]: the
    affine of the norm's running statistics from its (cast) parameters, or
    the conv's bias."""
    scale, shift = norm.eval_affine() if norm is not None else (None, None)
    if norm is None and conv.bias is not None:
        shift = conv.bias
    return conv3x3_affine_cs(x, conv.weight, scale, shift, stride=stride)


def _spike_site(x, sn, T):
    """K4a at one PSN site of ``x`` [T * B, C, H, W]."""
    return psn_spike_cs(x.reshape(T, -1, *x.shape[1:]), sn.weight,
                        sn.bias).reshape(x.shape)


def fused_embed_forward(embed, x, *, num_steps: int):
    """Eval forward of ``embed`` (an ``MSPEDSpikingPatchEmbedConvSfn``)
    through K4 and K4a: ``x`` [B, bins, 2, H, W] -> [T, B, H / 4, W / 4, C],
    the module's output. It works on ``[T * B, C, H, W]`` and keeps the JAX
    composition's quirks (``pallas_embed.py:259-304``): the SEW head spikes
    its output only, the MS conv (``first_layer``) takes no spike, the
    resblocks join by ADD, the PED residual is the 1x1 conv of the
    stride-2-decimated input (plus its bias, if any), and the regroup takes
    every bin (no ``x[:, :in_chans]`` truncation). Each affine comes from the
    parameters as they are (bf16 BN weights over float32 statistics give a
    float32 affine)."""
    T = num_steps
    xr = sfn_regroup(x, T)                              # [T, B, H, W, ch]
    B = xr.shape[1]
    y = xr.permute(0, 1, 4, 2, 3).reshape(T * B, xr.shape[-1],
                                          *xr.shape[2:4])
    head = embed.head
    y = _spike_site(_conv_site(y, head.conv, head.norm), head.sn, T)
    y = _conv_site(y, embed.conv.conv, embed.conv.norm, stride=2)
    res = embed.residual_encoding
    for i in range(res.num_blocks):
        blk = getattr(res, f"res{i}")
        z = _conv_site(_spike_site(y, blk.sn1, T), blk.conv1, blk.norm1)
        z = _conv_site(_spike_site(z, blk.sn2, T), blk.conv2, blk.norm2)
        y = z + y
    proj = embed.proj
    yr = _conv_site(y, proj.conv_res, None, stride=2)
    z = _conv_site(_spike_site(y, proj.sn, T), proj.conv, proj.norm,
                   stride=2)
    out = z + yr                                        # [T * B, C, h, w]
    return out.reshape(T, B, *out.shape[1:]).permute(0, 1, 3, 4, 2)
