"""Spike function, forward only.

Mirror of ``sdformerflow_tpu/ops/surrogate.py``: the forward of every
surrogate (ATan, sigmoid) is the Heaviside step ``(x >= 0) -> 1``. The
surrogate gradients arrive with the train slice.
"""

from __future__ import annotations

import torch


def heaviside(x: torch.Tensor) -> torch.Tensor:
    """Spike where the (membrane - threshold) argument is non-negative."""
    return (x >= 0).to(x.dtype)
