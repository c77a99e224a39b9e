"""Per-parameter gradient statistics, a copy of
``sdformerflow_tpu/utils/gradients.py``: for each parameter the mean, min
and max of ``|grad|``, and a CSV of such records, one row a step (the
reference's ``vis.store_grads`` probe, which its trainer never calls; the
port's trainer does not either).
"""

from __future__ import annotations

import csv
from typing import Dict, List

import torch.nn as nn


def get_grads(model: nn.Module) -> Dict[str, tuple]:
    """{name: (mean|g|, min|g|, max|g|)} over ``model.named_parameters()``
    that hold a gradient, the names "/"-joined as JAX's parameter paths."""
    out = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        a = p.grad.detach().abs()
        out[name.replace(".", "/")] = (float(a.mean()), float(a.min()),
                                       float(a.max()))
    return out


def save_grads_csv(records: List[Dict[str, tuple]], path: str):
    """List of per-step grad dicts -> CSV (one row per step)."""
    if not records:
        return
    keys = sorted(records[0].keys())
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["step"] + [f"{k}:{s}" for k in keys
                                    for s in ("mean", "min", "max")])
        for i, rec in enumerate(records):
            row = [i]
            for k in keys:
                row.extend(rec.get(k, (float("nan"),) * 3))
            writer.writerow(row)
