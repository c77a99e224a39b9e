"""The plain reference of a spiking model, following the program's own state
layer by layer.

The reference model (float32, TF32 off) runs once over the program's own
model input. At every neuron site the program recorded
(``portbench/stitch.py``) it computes the site's input potential from what
came before, holds it against the program's, thresholds the program's own
potential with its plain PSN and holds those spikes against the program's,
then hands on the program's spikes. An attention block is one site of the
program (one kernel): the reference holds the block's input windows, which
it computed, against the program's as a potential, runs the block on the
program's own windows, holds its output against the program's and hands on
the program's. So each site is judged from the program's state before it,
and a rounding that flips spikes upstream cannot make every later site
differ. The convolutions, norms, residual joins, window partitions and
upsampling between the sites are the reference's own, so a fault in any of
them shows at the next site's potential; the last predictions and the flow
are the reference's, from the program's last spikes.

It reads the program's record only to judge it and to take the program's
spikes and attention outputs forward, as a served language model's
reference is run over the served tokens.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _gap2(a: torch.Tensor, b: torch.Tensor):
    """(||a - b||^2, ||b||^2) in float64."""
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).sum()), float((b ** 2).sum())


def _token_gaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each output vector's (last axis) relative gap ``||a - b|| / ||b||``,
    a vector of the reference's under a thousandth of the median one's
    norm measured against that floor."""
    a, b = a.double().flatten(0, -2), b.double().flatten(0, -2)
    ref = b.norm(dim=-1)
    floor = 1e-3 * ref.median().clamp(min=1e-300)
    return (a - b).norm(dim=-1) / torch.maximum(ref, floor)


class Follow:
    """Per-site sums of one followed forward."""

    def __init__(self):
        self.potential: Dict[str, list] = {}   # name -> [gap2, ref2]
        self.attention: Dict[str, list] = {}   # name -> [median, moved]
        self.flips = 0
        self.spikes = 0
        self.unmatched = 0                     # a recorded call never reached

    def numbers(self) -> dict:
        """The readings: the root mean square over the neuron sites of each
        site's relative gap of its potential, and the worst site's; the
        worst attention block's median gap of an output vector (a spike
        that flips inside the block moves the vectors of its token
        wholesale, so the median reads the others), and the share of the
        blocks' vectors that moved by more than 2^-5; the share of spikes
        that differ."""
        rel = [math.sqrt(g / max(r, 1e-300))
               for g, r in self.potential.values()]
        pot = math.sqrt(sum(v * v for v in rel) / len(rel)) if rel \
            else float("nan")
        att = [m for m, _ in self.attention.values()]
        moved = [v for _, v in self.attention.values()]
        return {"potential_gap": pot,
                "potential_worst": max(rel, default=float("nan")),
                "attention_gap": max(att, default=float("nan")),
                "attention_moved": sum(moved) / len(moved) if moved
                else float("nan"),
                "spike_flips": self.flips / max(self.spikes, 1),
                "sites": len(self.potential) + len(self.attention),
                "unmatched": self.unmatched}


def follow(model: torch.nn.Module, record, *, dtype=torch.float32):
    """Run ``model`` (the reference, eval mode, on the record's device)
    over the record's model input, following the record at every site it
    holds. Returns (the reference's flows, coarse -> fine, float32;
    :class:`Follow`)."""
    f = Follow()
    count: Dict[str, int] = {}
    handles = []

    def take(name):
        i = count.get(name, 0)
        count[name] = i + 1
        calls = record.calls.get(name, [])
        return calls[i] if i < len(calls) else None

    def on_neuron(name):
        def hook(mod, args, kwargs, out):
            got = take(name)
            if got is None:
                return None
            xp, sp = got
            own = args[0]
            g, r = _gap2(xp, own)
            acc = f.potential.setdefault(name, [0.0, 0.0])
            acc[0] += g
            acc[1] += r
            affine = args[1] if len(args) > 1 else kwargs.get("affine")
            mine = mod._fire(xp.to(own.dtype), affine, False)
            f.flips += int((mine.to(torch.bool) != sp).sum())
            f.spikes += sp.numel()
            return sp.to(out.dtype)
        return hook

    held = {}

    def on_attention_input(name):
        def hook(mod, args, kwargs):
            got = take(name)
            held[name] = got
            if got is None:
                return None
            xp, _ = got
            own = args[0]
            g, r = _gap2(xp, own)
            acc = f.potential.setdefault(name + "/input", [0.0, 0.0])
            acc[0] += g
            acc[1] += r
            return (xp.to(own.dtype),) + tuple(args[1:]), kwargs
        return hook

    def on_attention(name):
        def hook(mod, args, kwargs, out):
            got = held.pop(name, None)
            if got is None:
                return None
            _, yp = got
            rel = _token_gaps(yp, out)
            f.attention[f"{name}/{count[name] - 1}"] = [
                float(rel.median()), float((rel > 2.0 ** -5).double().mean())]
            return yp.to(out.dtype)
        return hook

    for name, m in model.named_modules():
        if name not in record.calls:
            continue
        kind = type(m).__name__
        if kind == "SpikingNeuron":
            handles.append(m.register_forward_hook(on_neuron(name),
                                                   with_kwargs=True))
        elif kind == "SpikingQKWindowAttention3D":
            handles.append(m.register_forward_pre_hook(
                on_attention_input(name), with_kwargs=True))
            handles.append(m.register_forward_hook(on_attention(name),
                                                   with_kwargs=True))
    try:
        with torch.no_grad():
            out = model(record.input.to(dtype))
    finally:
        for h in handles:
            h.remove()
    f.unmatched = sum(len(c) for c in record.calls.values()) \
        - sum(count.values())
    return [fl.float() for fl in out["flow"]], f
