"""What the copied model files took from the program's kernel and
multi-process modules, in plain PyTorch: the PSN site (K2's twin), the eval
BN's affine, a one-process stand-in for ``parallel/multihost.py``, and the
float8 control's switch."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..precision import fake_fp8

# the lower-precision control: every PSN's time mix and every conv and
# dense layer take float8 operands (``set_fp8``)
FP8 = {"on": False}


def psn_neuron(x_seq, weight, bias):
    """``H(W[T, T] @ x + b)`` over the leading time axis, the potential in
    >= float32 (its operands in float8 under the control), 0/1 spikes in
    ``x_seq``'s dtype."""
    T = x_seq.shape[0]
    cdt = torch.promote_types(x_seq.dtype, torch.float32)
    w, x = weight.to(cdt), x_seq.reshape(T, -1).to(cdt)
    if FP8["on"]:
        w, x = fake_fp8(w), fake_fp8(x)
    h = w @ x + bias.to(cdt).reshape(T, 1)
    return (h >= 0).to(x_seq.dtype).reshape(x_seq.shape)


def affine_psn(x_seq, weight, bias, *, scale=None, shift=None,
               surrogate=None, alpha=None, return_v=False):
    """The fused site's forward, ``H(W @ (x * scale + shift) + b)`` with a
    per-channel (last axis) affine, as K2 computes it (the affine in >=
    float32). Forward only: the reference never trains an SNN."""
    del surrogate, alpha
    if return_v:
        raise NotImplementedError("the reference records no membrane")
    if scale is None:
        return psn_neuron(x_seq, weight, bias)
    cdt = torch.promote_types(x_seq.dtype, torch.float32)
    xa = x_seq.to(cdt) * scale.to(cdt) + shift.to(cdt)
    return psn_neuron(xa, weight, bias).to(x_seq.dtype)


def bn_eval_affine(scale, bias, mean, var, eps=1e-5):
    """Eval BatchNorm as ``y = a * x + c``, statistics in >= float32."""
    cdt = torch.promote_types(var.dtype, torch.float32)
    a = scale.to(cdt) * torch.rsqrt(var.to(cdt) + eps)
    return a, bias.to(cdt) - mean.to(cdt) * a


class multihost:
    """One process: no group is ever active."""

    @staticmethod
    def active(group) -> bool:
        return False

    @staticmethod
    def batch_moments(x, dims, group=None):
        dims = tuple(dims)
        n = 1.0
        for d in dims:
            n *= x.shape[d]
        mean = x.mean(dim=dims)
        return mean, ((x - mean) ** 2).mean(dim=dims), n

    @staticmethod
    def global_rows(make, shape, axis, group=None):
        return make(shape)


@contextlib.contextmanager
def fp8_operands():
    """Inside the block every PSN time mix, convolution, transposed
    convolution and dense layer takes float8 operands (e4m3, one scale a
    tensor): the spiking reference's lower-precision control. It swaps
    ``torch.nn.functional``'s functions for the whole process, so nothing
    else may run meanwhile."""
    saved = F.conv2d, F.linear, F.conv_transpose2d

    def rounded(fn):
        return lambda x, w, *a, **k: fn(fake_fp8(x), fake_fp8(w), *a, **k)
    F.conv2d, F.linear, F.conv_transpose2d = (rounded(fn) for fn in saved)
    FP8["on"] = True
    try:
        yield
    finally:
        F.conv2d, F.linear, F.conv_transpose2d = saved
        FP8["on"] = False
