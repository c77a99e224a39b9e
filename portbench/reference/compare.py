"""The numbers that decide ``correct``: each a gap between what the program
produced and what the reference works out, as a share of the reference's
own scale."""

from __future__ import annotations

from typing import Dict

import torch


def flow_gap(served: torch.Tensor, ref: torch.Tensor) -> float:
    """``||served - ref|| / ||ref||`` over one flow map (float64)."""
    d = (served.double() - ref.double()).norm()
    return float(d / ref.double().norm().clamp(min=1e-30))


def loss_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


def leaf_norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  scale_ref: Dict[str, torch.Tensor], keep=None) -> float:
    """The worst leaf's gap between the program's and the reference's norm
    (not the norm of their difference), over the larger of the reference's
    norm of that leaf and the median leaf's; only the leaves in ``keep``."""
    names = sorted(ref if keep is None else keep)
    ref_n = {n: float(ref[n].double().norm()) for n in names}
    med = sorted(ref_n.values())[len(names) // 2]
    worst = 0.0
    for n in names:
        gap = abs(float(prog[n].double().norm()) - ref_n[n])
        worst = max(worst, gap / max(ref_n[n], med, 1e-30))
    return worst


def moving_leaves(first_grad: Dict[str, torch.Tensor], share: float = 1e-3):
    """The leaves whose first gradient in the reference is above ``share``
    of the median leaf's norm; the others move under Adam by round-off
    alone."""
    norms = {n: float(g.double().norm()) for n, g in first_grad.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return sorted(n for n, v in norms.items() if v > share * med)
