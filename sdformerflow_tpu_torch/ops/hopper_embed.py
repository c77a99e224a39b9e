"""The channels-second patch-embed kernels: K4 (convolution + affine, CUDA
C++) and K4a (PSN spikes, K2's CUDA kernel), and the fused-embed eval
forward they compose.

Replaces the Pallas TPU kernels of ``sdformerflow_tpu/ops/pallas_embed.py``:

- K4, ``conv3x3_affine_cs`` (``_conv_cs_kernel``): a 3x3 or 1x1 SAME
  convolution with a per-output-channel affine ``acc * a + b`` (the folded
  eval BN, or a conv bias). Here ``csrc/conv_cs.cu``, on NCHW-ordered
  ``[N, Cin, H, W]`` with N = T * B (channels-second is PyTorch's NCHW with
  time folded into the batch) and OIHW weights; it also takes an output
  stride of 2, computing only the outputs the stride keeps. bfloat16 runs
  an implicit GEMM on the tensor cores (wgmma) over the weight re-laid by
  :func:`pack_conv_weight`; float32 keeps the CUDA-core kernel. Its source
  note says what bounds it and what its design does about that.
- K4a, ``psn_spike_cs`` (``_psn_cs_kernel``): ``H(W[T, T] x + b)`` over the
  leading T axis with no affine. That is K2's function on the ``[T, rest]``
  view, so it launches K2's kernel (``ops/hopper_psn.py:launch_k2``), with
  the output dtype free.

:func:`fused_embed_forward` is ``pallas_embed.py:fused_embed_forward``: the
eval forward of ``MSPEDSpikingPatchEmbedConvSfn`` through these two
kernels, fed to the network through its ``pre_embedded`` input
(``training/train_step.py:make_eval_step(fused_embed=True)``).

Dispatch: a CUDA tensor launches the kernel (or the call raises), a CPU
tensor runs the plain twin. The kernels are built when first launched.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..kernel_build import load_cuda_library
from ..models.spiking_layers import FoldedNorm
from ..models.spiking_patch_embed import sfn_regroup
from .hopper_psn import launch_k2
from .neurons import psn_neuron

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BF16_CUDA_CORES = 2   # the kernel entry's code of the bf16 CUDA-core path


def _kernel_code(dtype, cuda_cores):
    return (_BF16_CUDA_CORES if cuda_cores and dtype == torch.bfloat16
            else _DTYPE_CODES[dtype])


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


# the bf16 kernel's K chunk (csrc/conv_cs.cu, namespace tc): 16 input
# channels, or 16 of the folded ci * k * k axis, which it zero-pads to 4
# chunks
CONV_KCHUNK = 16
CONV_FOLD_CHUNKS = 4


def conv_tile_config(cin, cout, k, stride):
    """(block width nt, fold) of the bf16 kernel for a conv: nt = 48 when
    Cout fits, else 96 (blocks of 96 channels); fold the taps into K when
    Cin * k * k <= 64 at k = 3, stride 1 (the head: 2 * 9 = 18 -> 64)."""
    nt = 48 if cout <= 48 else 96
    fold_max = CONV_KCHUNK * CONV_FOLD_CHUNKS
    return nt, k == 3 and stride == 1 and cin * k * k <= fold_max


def pack_conv_weight(weight, nt, fold):
    """The OIHW ``weight`` as the bf16 kernel's shared-memory image:
    [ceil(Cout / nt), ceil(Kin / 16), taps, 2, nt, 8], zero-padded, where
    Kin, taps = Cin, k * k, or 64, 1 when ``fold`` (Cin * k * k padded to
    64). Entry (n, c, t, g, o, i) is weight[nt * n + o, 16 * c + 8 * g + i,
    tap t] (the folded axis in OIHW order ci * k * k + tap): per
    output-channel block n and K chunk c, each tap's two K-major
    core-matrix columns of nt rows x 8 inputs."""
    cout, cin, k, _ = weight.shape
    w = weight.reshape(cout, cin * k * k, 1) if fold else weight.reshape(
        cout, cin, k * k)
    kin, taps = w.shape[1:]
    nn = -(-cout // nt)
    nc = CONV_FOLD_CHUNKS if fold else -(-kin // CONV_KCHUNK)
    z = w.new_zeros(nn * nt, nc * CONV_KCHUNK, taps)
    z[:cout, :kin] = w
    z = z.reshape(nn, nt, nc, 2, 8, taps)
    return z.permute(0, 2, 5, 3, 1, 4).contiguous()


@functools.cache
def _conv_fn():
    fn = load_cuda_library("conv_cs.cu").conv_cs
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
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


def prepare_conv3x3_affine_cs(x, weight, scale=None, shift=None, *,
                              stride=1, cuda_cores=False):
    """Check and lay out one K4 launch on CUDA tensors (the arguments of
    :func:`conv3x3_affine_cs`): returns ``(launch, out)``, where each call
    of ``launch()`` runs the kernel once on these arguments into ``out`` and
    raises if the launch fails; it counts no launch. ``cuda_cores=True``
    lays a bfloat16 input out for the CUDA-core kernel instead (K4's first
    version). ``chip_smoke.py`` times ``launch``, the kernel alone, and that
    yardstick beside it."""
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
    nt, fold = conv_tile_config(cin, cout, k, stride)
    if x.dtype == torch.bfloat16 and not cuda_cores:   # tensor cores
        w, wpk = None, pack_conv_weight(weight.to(x.dtype), nt, fold)
    else:
        w, wpk = weight.to(x.dtype).contiguous(), None
    out = torch.empty((N, cout, (H - 1) // stride + 1, (W - 1) // stride + 1),
                      dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (xc.data_ptr(), ptr(w), ptr(wpk), ptr(a), ptr(b), out.data_ptr(),
            N, cin, cout, H, W, k, stride, _kernel_code(x.dtype, cuda_cores),
            nt, int(fold))
    keep = (xc, w, wpk, a, b)   # alive as long as the closure

    def launch():
        with torch.cuda.device(out.device):
            err = _conv_fn()(*args,
                             torch.cuda.current_stream(out.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"K4 (conv_cs) launch failed: CUDA error {err}")
        return keep

    return launch, out


def conv3x3_affine_cs(x, weight, scale=None, shift=None, *, stride=1):
    """K4: ``x`` [N, Cin, H, W], ``weight`` OIHW [Cout, Cin, k, k] with k 3
    or 1 (SAME padding), ``scale``/``shift`` [Cout] (None: 1 / 0), output
    stride 1 or 2 -> [N, Cout, ceil(H / stride), ceil(W / stride)] in
    ``x``'s dtype. A CUDA tensor launches the kernel (bfloat16: tensor
    cores on :func:`pack_conv_weight`'s layout; float32: CUDA cores), a CPU
    tensor runs :func:`conv3x3_affine_cs_plain`. Forward only."""
    if x.device.type == "cpu":
        return conv3x3_affine_cs_plain(x, weight, scale, shift,
                                       stride=stride)
    launch, out = prepare_conv3x3_affine_cs(x, weight, scale, shift,
                                            stride=stride)
    launch()
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
    the conv's bias (no norm, or one that BN folding removed)."""
    if isinstance(norm, FoldedNorm):
        norm = None
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
