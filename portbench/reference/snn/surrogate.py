"""Surrogate-gradient spike functions.

Mirror of ``sdformerflow_tpu/ops/surrogate.py``: the forward of every
surrogate is the Heaviside step ``(x >= 0) -> 1``; the backward substitutes
a smooth pseudo-derivative (SpikingJelly's):

- ATan (alpha 2.0): ``alpha / 2 / (1 + (pi / 2 * alpha * x) ** 2)``;
- Sigmoid (alpha 4.0): ``alpha * s * (1 - s)`` with ``s = sigmoid(alpha x)``.

The pseudo-derivatives are plain functions too, so the PSN's fused backward
(``ops/hopper_psn.py``) computes exactly what these Functions compute.
"""

from __future__ import annotations

import functools
import math

import torch


def heaviside(x: torch.Tensor) -> torch.Tensor:
    """Spike where the (membrane - threshold) argument is non-negative."""
    return (x >= 0).to(x.dtype)


def atan_grad(x: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    """ATan pseudo-derivative, in the JAX package's operation order."""
    return alpha / 2.0 / (1.0 + (math.pi / 2.0 * alpha * x) ** 2)


def sigmoid_grad(x: torch.Tensor, alpha: float = 4.0) -> torch.Tensor:
    """Sigmoid pseudo-derivative."""
    s = torch.sigmoid(alpha * x)
    return alpha * s * (1.0 - s)


class _Spike(torch.autograd.Function):
    """Heaviside forward, ``grad_fn(x, alpha)`` backward."""

    @staticmethod
    def forward(ctx, x, alpha, grad_fn):
        ctx.save_for_backward(x)
        ctx.alpha, ctx.grad_fn = alpha, grad_fn
        return heaviside(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ctx.grad_fn(x, ctx.alpha), None, None


def atan_spike(x: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    """Heaviside forward, ATan pseudo-derivative backward."""
    return _Spike.apply(x, alpha, atan_grad)


def sigmoid_spike(x: torch.Tensor, alpha: float = 4.0) -> torch.Tensor:
    """Heaviside forward, sigmoid pseudo-derivative backward."""
    return _Spike.apply(x, alpha, sigmoid_grad)


_REGISTRY = {"atan": (atan_spike, atan_grad),
             "sigmoid": (sigmoid_spike, sigmoid_grad)}


def surrogate_key(name: str) -> str:
    """'atan' or 'sigmoid' from a name or a reference spelling such as
    ``surrogate.ATan()``."""
    key = name.lower()
    for candidate in _REGISTRY:
        if candidate in key:
            return candidate
    raise ValueError(f"unknown surrogate function: {name!r}")


def get_surrogate(name: str, alpha: float | None = None):
    """The spike function of a surrogate name (alpha bound when given)."""
    fn = _REGISTRY[surrogate_key(name)][0]
    return fn if alpha is None else functools.partial(fn, alpha=alpha)


def surrogate_grad(name: str):
    """The pseudo-derivative ``fn(x, alpha)`` of a surrogate name."""
    return _REGISTRY[surrogate_key(name)][1]
