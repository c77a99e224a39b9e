"""The serving driver: the program's ``FlowServer`` under an open loop of
camera streams.

Set-up builds the server from the configuration file's program section
with weights made on the card from the seed, makes the traffic's pool of
windows on the card (``portbench/scene.py``), and warms the one batch shape
the traffic uses. The window then sends one request every ``1 / (streams *
stream_hz)`` seconds (every stream at its frame rate, the streams' phases
evenly spread), cycling through the pool, each request timed from when it
was due to the flow in hand; requests still in flight when the window
closes are waited for and counted. A seeded sample of the window's
requests is kept and, once the window has closed and the server is gone,
held against the plain reference.

A configuration whose file says ``"check": "follow"`` (a spiking model,
whose outputs alone cannot tell a sound program from a wrong one: see
``portbench/stitch.py``) is judged instead on one forward of the window,
drawn from the seed in its last half: its state is recorded layer by layer
and the plain reference follows it (``reference/follow.py``), after the
device's peak has been read.
"""

from __future__ import annotations

import gc
import random
import threading
import time

import numpy as np
import torch

from .. import scene, stitch
from ..harness import Spans, profiled, quantile, read_trace, seeded_state
from ..reference import build as ref_build
from ..reference import events as ref_events
from ..reference.compare import flow_gap
from ..reference.follow import follow
from . import common


def _crop(chunk, crop):
    th, tw = crop
    h, w = chunk.shape[-2:]
    y0, x0 = (h - th) // 2, (w - tw) // 2
    return chunk[..., y0:y0 + th, x0:x0 + tw]


def make_pool(cell, program, device):
    """The traffic's pool of requests: raw-events dicts at the sensor's
    resolution (``kind`` "events"), or voxel chunks at the crop, as host
    arrays."""
    tr = cell.traffic
    if tr["kind"] == "events":
        return scene.events(tr["pool"], cell.seed * 7 + 1, tr["scene"],
                            device=device)
    bins = common.chunk_bins(program)
    made = scene.windows(tr["pool"], cell.seed * 7 + 1, tr["scene"],
                         bins=bins, device=device)
    chunks = _crop(made["chunk"], program["loader"]["crop"]).contiguous()
    host = chunks.cpu().numpy()
    return [host[i] for i in range(host.shape[0])]


class Client:
    """The open loop: requests due at fixed times, each one's latency from
    its due time to its flow; ``keep`` names the requests whose flows are
    kept for the check."""

    def __init__(self, server, pool, rate, keep=(), arm=None):
        self.server, self.pool, self.rate = server, pool, rate
        self.keep = set(keep)
        self.lock = threading.Lock()
        self.done = {}            # answered request -> (due, finished)
        self.kept = {}
        self.sent = {}            # kept request -> when it was submitted
        self.futures = []
        self.late = 0.0           # the largest lateness of a send
        # (seconds into the window, Capture): armed before the first send
        # due then, once the device's peak is read
        self.arm, self.peak = arm, None

    def _finish(self, j, due, fut):
        t = time.perf_counter()
        if fut.exception() is not None:
            return              # failed: never done, counted in ``failed``
        with self.lock:
            self.done[j] = (due, t)
            if j in self.keep:
                self.kept[j] = fut.result()

    def send(self, j0, start, seconds, spans):
        """Send the requests due in [start, start + seconds), numbered from
        ``j0``; returns the next number."""
        n = int(seconds * self.rate)
        for k in range(n):
            j = j0 + k
            due = start + k / self.rate
            with spans("sleep"):
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            self.late = max(self.late, time.perf_counter() - due)
            if self.arm is not None and due >= start + self.arm[0]:
                if torch.cuda.is_available():
                    self.peak = torch.cuda.max_memory_allocated()
                self.arm[1].arm()
                self.arm = None
            if j in self.keep:
                self.sent[j] = time.perf_counter()
            with spans("submit"):
                fut = self.server.submit(self.pool[j % len(self.pool)])
            fut.add_done_callback(
                lambda f, j=j, due=due: self._finish(j, due, f))
            self.futures.append(fut)
        return j0 + n

    def wait(self, timeout):
        deadline = time.perf_counter() + timeout
        for f in self.futures:
            f.exception(timeout=max(deadline - time.perf_counter(), 0.01))


def summarize(done, start, seconds):
    """(windows/s, latency p95 ms) of a window's requests, ``done`` their
    (due, finished) times: the flows returned inside [start, start +
    seconds) over its seconds, and the 95th percentile of every request's
    latency, those finished after the close included."""
    done = list(done)
    end = start + seconds
    lat = [(t - due) * 1e3 for due, t in done]
    return sum(1 for _, t in done if start <= t < end) / seconds, \
        quantile(lat, 0.95)


def start_server(cell, program, device):
    """The pool of requests and the warmed server, as a run sets them up:
    weights from the seed, the server's own warm-up, then the whole pool
    once, so that the window's one batch shape is warm."""
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
    server.warmup(max(len(r["x"]) for r in pool)
                  if tr["kind"] == "events" else None)
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
    follows = cell.config.get("check") == "follow"
    capture = stitch.Capture(server.model) if follows else None
    setup_s = time.perf_counter() - cell.t0

    rate = float(tr["streams"]) * float(tr["stream_hz"])
    n_window = int(cell.seconds * rate)
    draw = random.Random(cell.seed)
    arm = None
    if follows:
        # the recorded forward begins at a time drawn in the window's last
        # half; the flows of the requests sent 2 s around it are kept
        at = cell.seconds * (0.5 + 0.4 * draw.random())
        keep = range(max(int((at - 2.0) * rate), 0),
                     min(int((at + 2.0) * rate) + 1, n_window))
        arm = (at, capture)
    else:
        keep = draw.sample(range(n_window), min(int(tr["sample"]), n_window))
    client = Client(server, pool, rate, keep, arm)
    start = time.perf_counter() + 0.05
    j = client.send(0, start, cell.seconds, spans)
    client.wait(timeout=60.0)
    _, p95 = summarize(client.done.values(), start, cell.seconds)
    out = {"attempted": n_window, "failed": n_window - len(client.done),
           "serve_latency_p95_ms": p95, "setup_s": setup_s}
    if device.type == "cuda":
        out["memory_peak_bytes"] = client.peak if client.peak is not None \
            else torch.cuda.max_memory_allocated(device)
    if capture is not None:
        capture.close()
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
    if follows:
        checks, readings = check_follow(cell, program, pool, client,
                                        capture.record, device)
    else:
        checks, readings = check(cell, program, pool, client, device)
    readings.update(late_s=client.late, check_s=time.perf_counter() - t)
    if capture is not None:
        readings["forwards"] = capture.forwards   # the window's forwards
    out.update(trace=trace, checks=checks, spans=spans, readings=readings,
               reckoning=common.reckoning(cell), program=program)
    return out


def reference_flows(program, seed, inputs, device, *, precision="fp32",
                    block=8):
    """The plain reference's finest flows of ``inputs`` (host arrays):
    ``precision`` "fp32" with TF32 off, "bf16" (parameters and activations
    bfloat16, as the program's serving path casts them) or "fp8" (bfloat16
    with its convs' and dense layers' operands rounded to float8: the
    control)."""
    from ..reference.precision import set_fp8
    model = ref_build.build(program).to(device)
    model.load_state_dict(seeded_state(model.state_dict(), seed, device))
    dtype = torch.float32
    if precision != "fp32":
        model = set_fp8(model.to(torch.bfloat16), precision == "fp8")
        dtype = torch.bfloat16
    flows = []
    with common.tf32(False), torch.no_grad():
        for s in range(0, len(inputs), block):
            x = torch.from_numpy(np.stack(inputs[s:s + block])).to(device)
            flows.extend(f.float().cpu() for f in
                         model(x.to(dtype))["flow"][-1])
    del model
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return flows


def gap_ratio(served, ref32, ref16) -> float:
    """How many times farther the served flows lie from the float32
    reference than the bfloat16 reference does: the square roots of the
    summed squared gaps over the checked requests."""
    num = sum(float(((a.double() - r.double()) ** 2).sum())
              for a, r in zip(served, ref32))
    den = sum(float(((b.double() - r.double()) ** 2).sum())
              for b, r in zip(ref16, ref32))
    return (num / max(den, 1e-300)) ** 0.5


def check(cell, program, pool, client, device):
    """The served flows of the kept requests against the reference: their
    gap to the float32 reference over the bfloat16 reference's gap
    (``gap_ratio``), and how many kept requests never came back; and, not
    compared, the widest relative gap to the float32 reference."""
    kept = sorted(client.kept)
    lim = cell.limits
    missing = ("unchecked", len(client.keep) - len(kept), lim["unchecked"])
    if not kept:
        return [("flow_gap_ratio", float("inf"), lim["flow_gap_ratio"]),
                missing], {}
    idx = sorted({j % len(pool) for j in kept})
    inputs = [pool[i] for i in idx]
    r32 = dict(zip(idx, reference_flows(program, cell.seed, inputs, device)))
    r16 = dict(zip(idx, reference_flows(program, cell.seed, inputs, device,
                                        precision="bf16")))
    served = [torch.from_numpy(np.asarray(client.kept[j])) for j in kept]
    ref32 = [r32[j % len(pool)] for j in kept]
    ratio = gap_ratio(served, ref32, [r16[j % len(pool)] for j in kept])
    widest = max(flow_gap(a, r) for a, r in zip(served, ref32))
    return [("flow_gap_ratio", ratio, lim["flow_gap_ratio"]), missing], \
        {"flow_gap": widest}


def match_rows(record, pool, program, device):
    """The recorded forward's requests: {row: (pool index, the row's input
    gap to the reference's input of that window)} for every row that holds
    a request (a padded row's input is all zero), each matched to the pool
    window whose reference input lies nearest."""
    refs = [ref_events.model_input(r, program, device) for r in pool]
    rows = {}
    for b in range(record.input.shape[0]):
        xb = record.input[b].to(device, torch.float64)
        if not bool(xb.any()):
            continue
        gaps = [float((xb - r).norm() / r.norm().clamp(min=1e-300))
                for r in refs]
        i = min(range(len(gaps)), key=gaps.__getitem__)
        rows[b] = (i, gaps[i])
    return rows


def follow_numbers(program, seed, record, rows, device):
    """The plain reference (float32, TF32 off, weights from the seed, its
    parameters rounded to the serving precision's as the configuration
    casts them: bfloat16, the norms' statistics float32) following
    ``record``: (the readings of ``Follow.numbers``, the widest relative
    gap of a request's recorded flow to the reference's)."""
    model = ref_build.build(program).to(device)
    model.load_state_dict(seeded_state(model.state_dict(), seed, device))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.to(torch.bfloat16))
    for m in model.modules():
        if hasattr(m, "rows_apart"):
            m.rows_apart = True      # the server's rows are refolded apart
    with common.tf32(False):
        flows, f = follow(model, record)
    fine = flows[-1]
    gap = max((flow_gap(record.flow[b].cpu(), fine[b].cpu()) for b in rows),
              default=float("inf"))
    del model, flows
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return f.numbers(), gap


def check_follow(cell, program, pool, client, record, device):
    """The recorded forward of the window against the plain reference that
    follows it: the model's input against the reference's from the raw
    events (``input_gap``); each neuron site's potential and spikes and
    each attention block's output (``potential_gap``, ``spike_flips``,
    ``attention_gap``); each request's flow (``flow_gap``); the flow each
    of its requests was served against the recorded one (``served_gap``,
    exact); and how many of its requests could not be checked."""
    lim = cell.limits
    names = ("input_gap", "potential_gap", "attention_gap", "spike_flips",
             "flow_gap", "served_gap")
    if record is None or record.flow is None:
        return [(n, float("inf"), lim[n]) for n in names] + \
            [("unchecked", 1, lim["unchecked"])], {}
    rows = match_rows(record, pool, program, device)
    missing, served = 0, 0.0
    for b, (i, _) in rows.items():
        sent = [j for j, t in client.sent.items()
                if j % len(pool) == i and t <= record.t]
        j = max(sent, default=None)
        if j is None or j not in client.kept:
            missing += 1
            continue
        got = np.asarray(client.kept[j], np.float32)
        served = max(served, float(np.abs(
            got - record.flow[b].cpu().numpy()).max()))
    nums, gap = follow_numbers(program, cell.seed, record, rows, device)
    values = {"input_gap": max((g for _, g in rows.values()),
                               default=float("inf")),
              "potential_gap": nums["potential_gap"],
              "attention_gap": nums["attention_gap"],
              "spike_flips": nums["spike_flips"], "flow_gap": gap,
              "served_gap": served}
    checks = [(n, values[n], lim[n]) for n in names]
    checks.append(("unchecked", missing + nums["unmatched"],
                   lim["unchecked"]))
    readings = {"rows": len(rows), "sites": nums["sites"],
                "potential_worst": nums["potential_worst"],
                "attention_moved": nums["attention_moved"],
                "record_gb": record.nbytes() / 1e9}
    return checks, readings
