"""The reckoning of the ``sdformerflow_en4`` configuration: the floating-point
operations of one served window, and the bytes and operations of its hand
kernels' sites, from the configuration's shapes alone (never from what the
program ran).

The plain reference model (``portbench/reference/snn``) of the
configuration runs once on PyTorch's meta device, which computes shapes and
no values, under ``torch.utils.flop_counter.FlopCounterMode``: two
operations a multiply-add of every convolution, dense layer and matrix
product, over all T = 10 time steps (the PSN's time mix included); norms,
thresholds, joins and resizes are not counted. Its hooks give each site's
shapes:

- a K2 site is a neuron outside an attention block (45 a forward): it
  reads its input potential and writes its spikes, both bfloat16 on the
  serving path;
- a K1 site is an attention block (12 a forward): it reads its windows and
  writes its output (bfloat16) and reads its q, k and projection weights,
  and its operations are those the counter gives the block.
"""

from __future__ import annotations

import functools
import json

import torch

BF16 = 2   # bytes


def _measure(program_json: str, rows: int):
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import build as ref_build
    program = json.loads(program_json)
    crop = program["loader"]["crop"]
    bins = int(program["data"].get("num_frames", 10))
    sites = {}
    with torch.device("meta"):
        model = ref_build.build(program)
        for m in model.modules():
            if hasattr(m, "rows_apart"):
                m.rows_apart = True
        blocks = [n for n, m in model.named_modules()
                  if type(m).__name__ == "SpikingQKWindowAttention3D"]
        handles = []
        for name, m in model.named_modules():
            kind = type(m).__name__
            inside = any(name.startswith(b + ".") for b in blocks)
            if kind == "SpikingQKWindowAttention3D" or (
                    kind == "SpikingNeuron" and not inside):
                handles.append(m.register_forward_hook(
                    lambda mod, a, o, name=name: sites.setdefault(
                        name, []).append((a[0].numel(), o.numel()))))
        x = torch.empty(rows, bins, 2, *crop)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            model(x)
        per_module = fc.get_flop_counts()
    total = fc.get_total_flops()
    k2, k1 = [], []
    for name, calls in sites.items():
        m = model.get_submodule(name)
        for n_in, n_out in calls:
            if name in blocks:
                weights = sum(p.numel() for p in m.parameters())
                ops = sum(v for k, d in per_module.items()
                          if k.endswith("." + name) for v in d.values())
                k1.append(((n_in + n_out + weights) * BF16, ops))
            else:
                k2.append((n_in + n_out) * BF16)
    return total, tuple(k2), tuple(k1)


@functools.lru_cache(maxsize=4)
def _cached(program_json: str, rows: int):
    return _measure(program_json, rows)


def serve_flops_per_window(program: dict) -> float:
    """Operations of one window's forward (batch 1)."""
    return float(_cached(json.dumps(program, sort_keys=True), 1)[0])


def k2_site_bytes(program: dict, rows: int):
    """Each K2 site's bytes read and written in one forward of ``rows``."""
    return _cached(json.dumps(program, sort_keys=True), rows)[1]


def k1_site_work(program: dict, rows: int):
    """Each K1 site's (bytes, operations) in one forward of ``rows``."""
    return _cached(json.dumps(program, sort_keys=True), rows)[2]
