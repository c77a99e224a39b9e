"""The serving driver of a model that takes two consecutive event windows a
request (E-RAFT): the program's ``FlowServer`` under an open loop of camera
streams, each request ``{"old": window, "new": window}``.

Set-up builds the server from the configuration file's program section
with weights made on the card from the seed, makes the traffic's pool of
requests on the card (``portbench/scene.py``: twice the pool's windows,
taken in pairs, the newer window retimed to start where the older ends),
warms the server (its own warm-up, then the whole pool once). The window
sends and times requests as ``drivers/serve.py``'s client does (every
stream at its frame rate, the streams evenly phased, each request timed
from its due time to its flow, the late ones waited for and counted).

The check, after the window, the server gone:

- ``input_gap``: one forward's model input, recorded at a time drawn from
  the seed in the window's last half (a hook on the served model), each
  row matched to the pool request whose plain input lies nearest; each
  window's gap to the plain events front's float64 grid (the signed
  trilinear grid over the window's own span, standardized over its own
  nonzero entries as E-RAFT's ``VoxelGrid(normalize=True)``), relative,
  worst window of the worst request;
- ``corr_gap``: the same forward's correlation (E-RAFT's, the program's
  ``models/eraft.py`` ``corr_pyramid`` and ``lookup`` wrapped while the
  forward is recorded): its first lookup against the plain reference's
  float64 volume, pyramid and bilinear samples
  (``reference/models/ERAFT.py``) from the features the program built its
  volume from, at the coordinates it sampled; relative, worst row. The
  configuration states the correlation in float32: a volume, pyramid or
  lookup kept in bfloat16 reads some 1e-3, float32 some 1e-7. (TF32
  matmuls over the volume round nothing: the features are bfloat16
  values, which TF32 holds exactly.)
- ``flow_gap_ratio``: a seeded sample of the window's served flows against
  the plain reference's (``reference/models/ERAFT.py``) on the plain
  inputs, their gap to the float32 reference over the bfloat16
  reference's gap (``drivers/serve.py:gap_ratio``);
- ``unchecked``: sampled requests never answered, and a recorded forward
  that never came.

``drivers/serve.py``'s check hands a pool entry to the reference as it is,
a voxel chunk; here each reference input is built from the raw events by
the plain front, so the driver is its own. Its ``start_server`` builds the
one-window pool of ``serve.make_pool``, so this driver sets up its own.
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from .. import scene
from ..harness import Spans, profiled, read_trace, seeded_state
from ..reference import events as ref_events
from ..reference import build as ref_build
from ..reference.compare import flow_gap
from ..reference.models import ERAFT as ref_eraft
from ..reference.precision import fake_fp8, set_fp8
from . import common
from .serve import Client, gap_ratio, reference_flows, summarize

WINDOWS = ("old", "new")


def make_pool(cell, program, device):
    """The traffic's pool: ``pool`` requests of two consecutive raw-events
    windows as a DSEC file stores them, from ``2 * pool`` drawn windows in
    pairs."""
    tr = cell.traffic
    wins = scene.events(2 * int(tr["pool"]), cell.seed * 7 + 1, tr["scene"],
                        device=device)
    pool = []
    for old, new in zip(wins[::2], wins[1::2]):
        t = new["t"] - new["t"].min() + old["t"].max() + 1
        pool.append({"old": old, "new": dict(new, t=t)})
    return pool


def reference_input(request, program, device) -> torch.Tensor:
    """One request's model input [2 * bins, H, W] float64 by the plain
    events front: each window's signed grid over its own time span, its
    nonzero entries standardized (unbiased std) on their own; where their
    std is 0, E-RAFT subtracts their mean."""
    res = program["loader"]["resolution"]
    bins = int(program["data"]["num_frames"])
    grids = []
    for w in WINDOWS:
        g = ref_events.voxel_signed(request[w], num_bins=bins,
                                    height=res[0], width=res[1],
                                    device=device)
        nz = g != 0
        if bool(nz.any()):
            v = g[nz]
            std = v.std() if v.numel() > 1 else v.new_zeros(())
            mean = v.mean()
            g = torch.where(nz, (g - mean) / std if std > 0 else g - mean, g)
        grids.append(g)
    return torch.cat(grids)


def window_gap(x: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst window's relative gap of a [2 * bins, H, W] input."""
    return max(float((a.double() - r).norm() / r.norm().clamp(min=1e-300))
               for a, r in zip(x.chunk(2), ref.chunk(2)))


class InputCapture:
    """The served model's input in the first forward after :meth:`arm`
    (a forward pre-hook, on the device), the host time it began, and that
    forward's correlation ``corr``: the two feature maps its volume was
    built from, the coordinates of its first lookup and that lookup's
    output (the program's ``eraft.corr_pyramid`` and ``eraft.lookup``,
    wrapped from :meth:`arm` to :meth:`close`)."""

    def __init__(self, model):
        self.model, self.handle = model, None
        self.input = self.t = self.corr = None
        self._feats = self._saved = None

    def arm(self):
        from sdformerflow_tpu_torch.models import eraft
        pyramid_fn, lookup_fn = self._saved = (eraft.corr_pyramid,
                                               eraft.lookup)

        def corr_pyramid(fmap1, fmap2, *args, **kw):
            if self.input is not None and self._feats is None:
                self._feats = (fmap1.detach().clone(),
                               fmap2.detach().clone())
            return pyramid_fn(fmap1, fmap2, *args, **kw)

        def lookup(pyramid, coords, *args, **kw):
            out = lookup_fn(pyramid, coords, *args, **kw)
            if self._feats is not None and self.corr is None:
                self.corr = self._feats + (coords.detach().clone(),
                                           out.detach().clone())
            return out
        eraft.corr_pyramid, eraft.lookup = corr_pyramid, lookup
        self.handle = self.model.register_forward_pre_hook(self._hook)

    def _hook(self, module, args):
        if self.input is None:
            self.t = time.perf_counter()
            self.input = args[0].detach().clone()

    def close(self):
        if self.handle is not None:
            self.handle.remove()
            self.handle = None
        if self._saved is not None:
            from sdformerflow_tpu_torch.models import eraft
            eraft.corr_pyramid, eraft.lookup = self._saved
            self._saved = None


def start_server(cell, program, device):
    """The pool of requests and the warmed server, as a run sets them up:
    weights from the seed, the server's own warm-up (a voxel request and a
    two-window events request), then the whole pool once."""
    from sdformerflow_tpu_torch.serving import FlowServer
    tr = cell.traffic
    state = seeded_state(common.skeleton(program).state_dict(), cell.seed,
                         device)
    pool = make_pool(cell, program, device)
    server = FlowServer(program, state, device=cell.device,
                        bf16=cell.config["precision"]["serve"] == "bf16",
                        devices=[cell.device] * int(tr["rows"]),
                        batch_window_s=float(tr["batch_window_s"]),
                        max_pending=int(tr["max_pending"]))
    server.warmup(max(len(r[w]["x"]) for r in pool for w in WINDOWS))
    for f in [server.submit(r) for r in pool]:
        f.result(timeout=600)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return pool, server


def run(cell):
    tr = cell.traffic
    device = torch.device(cell.device)
    spans = Spans()
    program = common.program_config(cell)
    pool, server = start_server(cell, program, device)
    capture = InputCapture(server.model)
    setup_s = time.perf_counter() - cell.t0

    rate = float(tr["streams"]) * float(tr["stream_hz"])
    n_window = int(cell.seconds * rate)
    draw = random.Random(cell.seed)
    keep = draw.sample(range(n_window), min(int(tr["sample"]), n_window))
    at = cell.seconds * (0.5 + 0.4 * draw.random())
    client = Client(server, pool, rate, keep, arm=(at, capture))
    start = time.perf_counter() + 0.05
    j = client.send(0, start, cell.seconds, spans)
    client.wait(timeout=60.0)
    capture.close()
    _, p95 = summarize(client.done.values(), start, cell.seconds)
    out = {"attempted": n_window, "failed": n_window - len(client.done),
           "serve_latency_p95_ms": p95, "setup_s": setup_s}
    if device.type == "cuda":
        out["memory_peak_bytes"] = client.peak if client.peak is not None \
            else torch.cuda.max_memory_allocated(device)
    trace = None
    if cell.trace:
        path = common.trace_path(cell)
        tclient = Client(server, pool, rate)
        with profiled(path):
            with spans("traced_window"):
                tclient.send(j, time.perf_counter(),
                             float(tr.get("trace_seconds", 2.0)), spans)
                tclient.wait(timeout=60.0)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        trace = read_trace(path)
        trace["windows"] = len(tclient.done)
    server.close()
    del server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks, readings = check(cell, program, pool, client, capture.input,
                             capture.corr, device)
    readings.update(late_s=client.late, check_s=time.perf_counter() - t)
    out.update(trace=trace, checks=checks, spans=spans, readings=readings,
               reckoning=common.reckoning(cell), program=program)
    return out


def input_gaps(recorded, pool, program, device):
    """{row: (pool index, its worst window's gap)} of a recorded forward's
    input [rows, 2 * bins, H, W], every row that holds a request (a padded
    row is all zero) matched to the pool request whose plain input lies
    nearest."""
    rows = [b for b in range(recorded.shape[0]) if bool(recorded[b].any())]
    best = {}
    for i, req in enumerate(pool):
        ref = reference_input(req, program, device)
        for b in rows:
            xb = recorded[b].to(device, torch.float64)
            d = float((xb - ref).norm() / ref.norm().clamp(min=1e-300))
            if b not in best or d < best[b][0]:
                best[b] = (d, i, window_gap(xb, ref))
        del ref
    return {b: (i, g) for b, (_, i, g) in best.items()}


def corr_gap(record, rows, device) -> float:
    """The worst of ``rows``' relative gap of a recorded first lookup
    ``(fmap1, fmap2, coords, lookup)`` to the plain reference's in
    float64: the volume of the same features, its pyramid and its
    bilinear samples at the same coordinates."""
    worst = float("inf") if not rows else 0.0
    for b in rows:
        f1, f2, coords, got = (t[b:b + 1].to(device, torch.float64)
                               for t in record)
        want = ref_eraft.sample(ref_eraft.pyramid(ref_eraft.volume(f1, f2)),
                                coords)
        worst = max(worst, float((got - want).norm()
                                 / want.norm().clamp(min=1e-300)))
        del want
    return worst


def check(cell, program, pool, client, recorded, corr, device):
    """The recorded forward's input against the plain events front
    (``input_gap``), its correlation against the plain reference's in
    float64 (``corr_gap``), the sampled served flows against the plain
    reference (``flow_gap_ratio``), and what could not be checked; not
    compared: the widest relative gap of a served flow to the float32
    reference."""
    lim = cell.limits
    kept = sorted(client.kept)
    unchecked = len(client.keep) - len(kept)
    readings = {}
    c_gap = float("inf")
    if recorded is None:
        unchecked += 1
        in_gap = float("inf")
    else:
        rows = input_gaps(recorded, pool, program, device)
        in_gap = max((g for _, g in rows.values()), default=float("inf"))
        readings["recorded_rows"] = len(rows)
        if corr is not None:
            c_gap = corr_gap(corr, sorted(rows), device)
    ratio = float("inf")
    if kept:
        idx = sorted({j % len(pool) for j in kept})
        inputs = [reference_input(pool[i], program, device).float().cpu()
                  .numpy() for i in idx]
        r32 = dict(zip(idx, reference_flows(program, cell.seed, inputs,
                                            device)))
        r16 = dict(zip(idx, reference_flows(program, cell.seed, inputs,
                                            device, precision="bf16")))
        served = [torch.from_numpy(np.asarray(client.kept[j])) for j in kept]
        ref32 = [r32[j % len(pool)] for j in kept]
        ratio = gap_ratio(served, ref32, [r16[j % len(pool)] for j in kept])
        readings["flow_gap"] = max(flow_gap(a, r)
                                   for a, r in zip(served, ref32))
    return [("input_gap", in_gap, lim["input_gap"]),
            ("corr_gap", c_gap, lim["corr_gap"]),
            ("flow_gap_ratio", ratio, lim["flow_gap_ratio"]),
            ("unchecked", unchecked, lim["unchecked"])], readings


def reference_run(program, seed, inputs, device, *, precision, corr,
                  block=8):
    """The plain reference in bfloat16 (``precision`` "bf16", or "fp8":
    its convs' operands rounded to float8) with its correlation in
    ``corr`` (``ERAFT.corr``): its finest flows of ``inputs`` (host
    arrays) and its ``corr_gap``, its first lookup against the float64
    one of its own features, worst row."""
    model = ref_build.build(program).to(device)
    model.load_state_dict(seeded_state(model.state_dict(), seed, device))
    model = set_fp8(model.to(torch.bfloat16), precision == "fp8")
    model.corr = corr
    flows, gap = [], 0.0
    with common.tf32(False), torch.no_grad():
        for s in range(0, len(inputs), block):
            x = torch.from_numpy(np.stack(inputs[s:s + block])).to(device)
            x = x.to(torch.bfloat16)
            f1, f2, levels, start = model.correlate(x)
            got = ref_eraft.sample(levels, start)
            gap = max(gap, corr_gap((f1, f2, start, got),
                                    range(x.shape[0]), device))
            del f1, f2, levels, got
            flows.extend(f.float().cpu() for f in model(x)["flow"][-1])
    del model
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return flows, gap


def control(cell, program, device):
    """The readings the cell's limits are set against: on as many pool
    requests as a run checks (drawn from the seed), each held by the
    cell's numbers against the float32 reference: the plain reference in
    bfloat16 with its convolutions' operands rounded to float8, its inputs
    rounded to float8 (``fp8``); the bfloat16 reference with its volume,
    pyramid and lookups in bfloat16 (``bf16_corr``) or its volume's
    matmul in TF32 (``tf32_corr``); and the bfloat16 reference alone
    (``bf16_reference``). ``corr_gap`` is each one's first lookup against
    the float64 one of its own features."""
    pool = make_pool(cell, program, device)
    k = min(int(cell.traffic["sample"]), len(pool))
    idx = sorted(random.Random(cell.seed).sample(range(len(pool)), k))
    exact = [reference_input(pool[i], program, device) for i in idx]
    inputs = [x.float().cpu().numpy() for x in exact]
    ref = reference_flows(program, cell.seed, inputs, device)
    r16, gap16 = reference_run(program, cell.seed, inputs, device,
                               precision="bf16", corr="fp32")
    out = {}
    for name, precision, corr in (("fp8", "fp8", "fp32"),
                                  ("bf16_corr", "bf16", "bf16"),
                                  ("tf32_corr", "bf16", "tf32")):
        flows, gap = reference_run(program, cell.seed, inputs, device,
                                   precision=precision, corr=corr)
        out[name] = {"corr_gap": gap,
                     "flow_gap_ratio": gap_ratio(flows, ref, r16),
                     "flow_gap": max(flow_gap(c, r)
                                     for c, r in zip(flows, ref))}
    out["fp8"]["input_gap"] = max(window_gap(fake_fp8(x.float()), x)
                                  for x in exact)
    out["bf16_reference"] = {
        "input_gap": max(window_gap(x.to(torch.bfloat16), x)
                         for x in exact),
        "corr_gap": gap16,
        "flow_gap": max(flow_gap(c, r) for c, r in zip(r16, ref))}
    return out
