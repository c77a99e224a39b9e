"""The program's own state at each layer of a spiking model, for a
reference that follows it step by step.

A spiking forward thresholds potentials that land, at random weights, in
dense clusters near zero; one rounding moves a whole cluster across the
threshold, and every layer after it then sees other spikes. So the flows of
two runs that differ only in rounding differ as much as the flows of a
wrong program, and the program's own events front sums in no fixed order,
so two runs of one request differ too: no comparison of outputs alone can
tell bfloat16 from float8. The check therefore records, in one forward of
the timed window, the model's input, every neuron site's input potential
and output spikes, every attention block's input windows and output, and
the finest flow; the reference (``reference/follow.py``) recomputes each
site from the program's own state before it.

A site is a neuron or an attention block that is not inside another
attention block: the program runs each attention block as one kernel (K1),
so the neurons inside it are not its own modules' calls.

Nothing here imports the program: :class:`Capture` takes its model as an
``nn.Module`` and finds the sites by their class names.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

NEURONS = ("SpikingNeuron",)
ATTENTION = ("SpikingQKWindowAttention3D",)


def sites(model: torch.nn.Module) -> Dict[str, str]:
    """{module name: "neuron" | "attention"} of ``model``'s sites."""
    out: Dict[str, str] = {}
    blocks = []
    for name, m in model.named_modules():
        kind = type(m).__name__
        if any(name.startswith(b + ".") for b in blocks):
            continue
        if kind in ATTENTION:
            out[name] = "attention"
            blocks.append(name)
        elif kind in NEURONS:
            out[name] = "neuron"
    return out


class Record:
    """One forward's state: ``input`` the model's input, ``flow`` its
    finest flow, ``calls[name]`` each call's (input potential, spikes) of
    a neuron site or (input windows, output) of an attention block, in
    call order, and ``t`` the host time the forward began."""

    def __init__(self):
        self.input = None
        self.flow = None
        self.t = None
        self.calls: Dict[str, List[tuple]] = {}

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for calls in self.calls.values() for pair in calls
                   for t in pair if t is not None)


class Capture:
    """Hooks on ``model``'s sites that record the first forward to begin
    after :meth:`arm` (on the device, copies of the tensors) and pass every
    other forward through untouched. Thread-safe for one forward at a time:
    the forward runs on whichever thread calls the model."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.record = None
        self.forwards = 0          # every forward begun while hooked
        self.armed = False
        self._live = False
        self._handles = [model.register_forward_pre_hook(self._begin),
                         model.register_forward_hook(self._end)]
        for name, kind in sites(model).items():
            self._handles.append(model.get_submodule(name)
                                 .register_forward_hook(self._site(name,
                                                                   kind)))

    def arm(self):
        self.armed = True

    def _begin(self, mod, args):
        self.forwards += 1
        if self.armed and self.record is None:
            self.armed = False
            self.record = Record()
            self.record.t = time.perf_counter()
            self.record.input = args[0].detach().clone()
            self._live = True

    def _end(self, mod, args, out):
        if self._live:
            self.record.flow = out["flow"][-1].detach().float().clone()
            self._live = False

    def _site(self, name, kind):
        def hook(mod, args, out):
            if not self._live:
                return
            x = args[0].detach().clone()
            y = out.detach()
            y = y.to(torch.bool) if kind == "neuron" else y.clone()
            self.record.calls.setdefault(name, []).append((x, y))
        return hook

    def close(self):
        for h in self._handles:
            h.remove()
        self._handles = []
