"""Spiking neuron dynamics over time-major tensors, mirrors of
``sdformerflow_tpu/ops/neurons.py``.

Every neuron takes ``x_seq`` [T, ...] and returns 0/1 spikes of the same
shape (with ``return_v``, also the membrane potential each step fired
from). The spike function's surrogate gives the gradient.

- PSN (:func:`psn_neuron`): ``spike = H(W[T, T] @ x + b)`` contracted over
  the leading time axis; no recurrence, one small matrix product. It is
  the plain form the fused PSN (K2 forward, K2b backward,
  ``ops/hopper_psn.py``) is held against.
- IF, LIF (both ``decay_input`` forms), SLTT-LIF (the carried membrane is
  detached each step), PLIF (the decay ``sigmoid(w)`` learnable) and GLIF
  (layer-wise learnable gates): a charge -> fire -> reset recurrence, a
  loop over T in plain PyTorch (``jax.lax.scan`` in JAX; none of them
  reaches a Pallas kernel). Soft reset when ``v_reset`` is None, else hard;
  ``detach_reset`` cuts the reset's gradient through the spike. The
  membrane starts at ``v_reset`` (0 for a soft reset) on every call.

The recurrences compute in ``x_seq``'s dtype, as JAX does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .surrogate import atan_spike


def psn_neuron(x_seq: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, *, surrogate_fn=atan_spike,
               return_v: bool = False):
    """``x_seq`` [T, ...]; ``weight`` [T, T]; ``bias`` [T] or [T, 1].

    The potential is computed in at least float32 (float64 stays float64)
    and the 0/1 spikes are returned in ``x_seq``'s dtype; with
    ``return_v`` also the potential, the PSN's "membrane"."""
    T = x_seq.shape[0]
    cdt = torch.promote_types(x_seq.dtype, torch.float32)
    h = (weight.to(cdt) @ x_seq.reshape(T, -1).to(cdt)
         + bias.to(cdt).reshape(T, 1))
    spike = surrogate_fn(h).to(x_seq.dtype).reshape(x_seq.shape)
    if return_v:
        return spike, h.reshape(x_seq.shape)
    return spike


def _reset(v, spike, v_th, v_reset, detach_reset: bool):
    s = spike.detach() if detach_reset else spike
    if v_reset is None:
        return v - s * v_th                       # soft reset
    return (1.0 - s) * v + s * v_reset            # hard reset


def _scan_neuron(charge, x_seq, *, v_th, v_reset, surrogate_fn,
                 detach_reset, detach_carry=False, return_v=False):
    """charge -> fire -> reset over the leading time axis."""
    v = torch.full_like(x_seq[0], 0.0 if v_reset is None else v_reset)
    spikes, vs = [], []
    for x in x_seq:
        if detach_carry:
            v = v.detach()
        v = charge(v, x)
        spike = surrogate_fn(v - v_th)
        spikes.append(spike)
        vs.append(v)
        v = _reset(v, spike, v_th, v_reset, detach_reset)
    out = torch.stack(spikes)
    return (out, torch.stack(vs)) if return_v else out


def if_neuron(x_seq, *, v_th=1.0, v_reset=None, surrogate_fn=atan_spike,
              detach_reset=True, return_v=False):
    """Integrate-and-fire: v <- v + x."""
    return _scan_neuron(lambda v, x: v + x, x_seq, v_th=v_th,
                        v_reset=v_reset, surrogate_fn=surrogate_fn,
                        detach_reset=detach_reset, return_v=return_v)


def _decay_charge(decay_input: bool, vr, scale):
    """LIF / PLIF charge: ``scale(d)`` is ``d / tau`` or ``d * decay``."""
    if decay_input:
        return lambda v, x: v + scale(x - (v - vr))
    return lambda v, x: v - scale(v - vr) + x


def lif_neuron(x_seq, *, v_th=1.0, v_reset=None, tau=2.0,
               surrogate_fn=atan_spike, detach_reset=True, decay_input=True,
               return_v=False, detach_carry=False):
    """Leaky integrate-and-fire with SpikingJelly's charge."""
    vr = 0.0 if v_reset is None else v_reset
    return _scan_neuron(_decay_charge(decay_input, vr, lambda d: d / tau),
                        x_seq, v_th=v_th, v_reset=v_reset,
                        surrogate_fn=surrogate_fn, detach_reset=detach_reset,
                        detach_carry=detach_carry, return_v=return_v)


def sltt_lif_neuron(x_seq, *, v_th=1.0, v_reset=None, tau=2.0,
                    surrogate_fn=atan_spike, detach_reset=True,
                    decay_input=True, return_v=False):
    """LIF whose carried membrane is detached each step (SLTT training)."""
    return lif_neuron(x_seq, v_th=v_th, v_reset=v_reset, tau=tau,
                      surrogate_fn=surrogate_fn, detach_reset=detach_reset,
                      decay_input=decay_input, return_v=return_v,
                      detach_carry=True)


def plif_neuron(x_seq, w, *, v_th=1.0, v_reset=None, surrogate_fn=atan_spike,
                detach_reset=True, decay_input=True, return_v=False):
    """Parametric LIF: the decay ``1 / tau = sigmoid(w)`` is learnable."""
    decay = torch.sigmoid(w)
    vr = 0.0 if v_reset is None else v_reset
    return _scan_neuron(_decay_charge(decay_input, vr, lambda d: d * decay),
                        x_seq, v_th=v_th, v_reset=v_reset,
                        surrogate_fn=surrogate_fn, detach_reset=detach_reset,
                        return_v=return_v)


def plif_init_w(init_tau: float = 2.0) -> float:
    """The initial ``w`` with ``sigmoid(w) == 1 / init_tau``."""
    return -math.log(init_tau - 1.0)


class GLIFParams(NamedTuple):
    """GLIF's layer-wise learnable parameters (pre-sigmoid logits)."""
    alpha: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    tau: torch.Tensor
    v_threshold: torch.Tensor
    linear_decay: torch.Tensor
    v_subreset: torch.Tensor
    conduct: torch.Tensor   # [T]


def glif_init(generator: Optional[torch.Generator], T: int, *, init_tau=0.25,
              init_v_threshold=0.5, init_conduct=0.5, init_linear_decay=None,
              init_v_subreset=None) -> GLIFParams:
    """GLIF's initial logits: the three gate mixes ``0.2 * (U(0, 1) - 0.5)``
    drawn from ``generator`` (torch's default one if None), the rest the
    logits of the initial values (float32)."""
    if init_linear_decay is None:
        init_linear_decay = init_v_threshold / (T * 2)
    if init_v_subreset is None:
        init_v_subreset = init_v_threshold

    def logit(p):
        return torch.tensor(-math.log(1.0 / p - 1.0))

    rand = 0.2 * (torch.rand(3, generator=generator) - 0.5)
    return GLIFParams(
        alpha=rand[0], beta=rand[1], gamma=rand[2], tau=logit(init_tau),
        v_threshold=logit(init_v_threshold),
        linear_decay=logit(init_linear_decay),
        v_subreset=logit(init_v_subreset),
        conduct=logit(init_conduct).expand(T).clone())


def glif_neuron(x_seq, params: GLIFParams, *, surrogate_fn=atan_spike,
                return_v=False):
    """Gated LIF in the reference's step order: charge ``x_t`` on the
    previous membrane, reset with the previous step's spike, then fire."""
    sg = torch.sigmoid
    alpha, beta, gamma = sg(params.alpha), sg(params.beta), sg(params.gamma)
    tau_s, v_th_s = sg(params.tau), sg(params.v_threshold)
    lin_decay_s, v_subreset_s = sg(params.linear_decay), sg(params.v_subreset)
    conduct_s = sg(params.conduct)                     # [T]
    v = torch.zeros_like(x_seq[0])
    prev = torch.zeros_like(x_seq[0])
    spikes, us = [], []
    for x, conduct_t in zip(x_seq, conduct_s):
        inp = x * (1.0 - beta * (1.0 - conduct_t))
        leak = 1.0 - alpha * (1.0 - tau_s)
        u = (leak * v - (1.0 - alpha) * lin_decay_s) + inp
        u = (u - leak * v * gamma * prev
             - (1.0 - gamma) * v_subreset_s * prev)
        spike = surrogate_fn(u - v_th_s)
        spikes.append(spike)
        us.append(u)
        v, prev = u, spike
    out = torch.stack(spikes)
    return (out, torch.stack(us)) if return_v else out
