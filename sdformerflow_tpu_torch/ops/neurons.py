"""Parallel Spiking Neuron (PSN), forward only.

Mirror of ``sdformerflow_tpu/ops/neurons.py:psn_neuron``:
``spike = H(W[T, T] @ x + b)`` contracted over the leading time axis. There
is no recurrence, so the neuron is one small matrix product over time.
"""

from __future__ import annotations

import torch

from .surrogate import heaviside


def psn_neuron(x_seq: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """``x_seq`` [T, ...]; ``weight`` [T, T]; ``bias`` [T] or [T, 1].

    The potential is computed in at least float32 (float64 stays float64)
    and the 0/1 spikes are returned in ``x_seq``'s dtype.
    """
    T = x_seq.shape[0]
    cdt = torch.promote_types(x_seq.dtype, torch.float32)
    h = (weight.to(cdt) @ x_seq.reshape(T, -1).to(cdt)
         + bias.to(cdt).reshape(T, 1))
    return heaviside(h).to(x_seq.dtype).reshape(x_seq.shape)
