"""The one generator of the benchmark's inputs: DSEC-shaped event windows of
a moving-edge scene, made on the device from a seed, in bulk.

A window holds ``segments`` (drawn in a range) straight edges, each
translating at its own velocity over the window's span, and uniform noise
events. An edge event lies at a uniform point of its edge at a uniform
time; its polarity is the sign of the edge's normal against its velocity
(a tenth flipped). The events are binned by time into ``bins`` signed
count grids at the sensor's resolution (integer sums: the same seed gives
the same grids, whatever order the device adds them in). The label is
each pixel's displacement over one 100 ms window by the nearest edge's
velocity; the valid mask holds the pixels within ``mask_px`` of an edge's
path.

Everything a traffic mix varies is a number of its data file
(``portbench/traffic/<mix>.json``, key ``scene``).
"""

from __future__ import annotations

import math

import torch


def _uniform(gen, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device,
                                       dtype=torch.float64)


def windows(n: int, seed: int, scene: dict, *, bins: int, device,
            labels: bool = False):
    """``n`` windows -> dict(chunk [n, bins, H, W] float32 signed counts,
    events [n] int64 event counts, and with ``labels`` flow [n, 2, H, W]
    float32 and mask [n, H, W] float32), on ``device``."""
    H, W = scene["resolution"]
    span_s = scene["span_ms"] / 1e3
    lo, hi = scene["events"]
    s_lo, s_hi = scene["segments"]
    gen = torch.Generator(device).manual_seed(int(seed) % (1 << 63))
    chunk = torch.empty((n, bins, H, W), dtype=torch.float32, device=device)
    counts = torch.empty(n, dtype=torch.int64)
    flow = mask = None
    if labels:
        flow = torch.empty((n, 2, H, W), dtype=torch.float32, device=device)
        mask = torch.empty((n, H, W), dtype=torch.float32, device=device)
    for i in range(n):
        n_ev = int(torch.randint(lo, hi + 1, (), generator=gen,
                                 device=device))
        x, y, t, p, geom = _draw(gen, scene, device, n_ev, s_lo, s_hi,
                                 span_s, H, W)
        b = (t / span_s * bins).long().clamp_(0, bins - 1)
        idx = (b * H + y) * W + x
        size = bins * H * W
        pos = torch.bincount(idx[p > 0], minlength=size)
        neg = torch.bincount(idx[p < 0], minlength=size)
        chunk[i] = (pos - neg).view(bins, H, W).float()
        counts[i] = x.numel()
        if labels:
            flow[i], mask[i] = _label(*geom, span_s, scene, H, W, device)
    out = {"chunk": chunk, "events": counts}
    if labels:
        out.update(flow=flow, mask=mask)
    return out


def events(n: int, seed: int, scene: dict, *, device):
    """``n`` windows of raw events as a DSEC file stores them: a list of
    dicts of host arrays x, y (uint16 pixels), t (int64 microseconds from
    the recording's start: each window starts at a time drawn in
    ``start_s``), p (uint8, 1 on, 0 off). The events keep the order they
    were drawn in (edges, then noise), which is not time order: the
    program's events front takes them in any order.

    The windows' event counts are the same for every seed: ``n`` evenly
    spaced over the ``events`` range, in an order drawn from the seed, so
    seeds change the scenes and not the work. A window keeps the first of
    its drawn events that land on the sensor (edges leave it), drawing a
    further scene for what is still missing, until it has its count."""
    H, W = scene["resolution"]
    span_s = scene["span_ms"] / 1e3
    lo, hi = scene["events"]
    s_lo, s_hi = scene["segments"]
    gen = torch.Generator(device).manual_seed(int(seed) % (1 << 63))
    counts = [lo + (hi - lo) * k // max(n - 1, 1) for k in range(n)]
    order = torch.randperm(n, generator=gen, device=device).tolist()
    out = []
    for k in order:
        want, parts, have = counts[k], [], 0
        while have < want:
            more = _draw(gen, scene, device, (want - have) * 5 // 4 + 16,
                         s_lo, s_hi, span_s, H, W)[:4]
            parts.append(more)
            have += more[0].numel()
        x, y, t, p = (torch.cat(c)[:want] for c in zip(*parts))
        t0 = _uniform(gen, 1, *scene["start_s"], device)
        us = ((t0 + t) * 1e6).floor().long()
        out.append({"x": x.to(torch.int32).cpu().numpy().astype("uint16"),
                    "y": y.to(torch.int32).cpu().numpy().astype("uint16"),
                    "t": us.cpu().numpy(),
                    "p": (p > 0).to(torch.uint8).cpu().numpy()})
    return out


def _draw(gen, scene, device, n_ev, s_lo, s_hi, span_s, H, W):
    """One window of ``n_ev`` drawn events, those on the sensor kept: x, y
    (int64 pixels), t (float64 seconds from the window's start), p (+1 /
    -1), and the edges' geometry for the label."""
    n_seg = int(torch.randint(s_lo, s_hi + 1, (), generator=gen,
                              device=device))
    cx = _uniform(gen, n_seg, 0, W, device)
    cy = _uniform(gen, n_seg, 0, H, device)
    length = _uniform(gen, n_seg, *scene["length_px"], device)
    ang = _uniform(gen, n_seg, 0, math.pi, device)
    speed = _uniform(gen, n_seg, *scene["speed_px_s"], device)
    heading = _uniform(gen, n_seg, 0, 2 * math.pi, device)
    vx, vy = speed * torch.cos(heading), speed * torch.sin(heading)
    dx, dy = torch.cos(ang), torch.sin(ang)
    pol = torch.where(-dy * vx + dx * vy >= 0, 1, -1)
    n_noise = int(round(n_ev * scene["noise"]))
    n_edge = n_ev - n_noise
    s = torch.randint(0, n_seg, (n_edge,), generator=gen, device=device)
    u = _uniform(gen, n_edge, -0.5, 0.5, device)
    t = _uniform(gen, n_edge, 0, span_s, device)
    x = cx[s] + u * length[s] * dx[s] + vx[s] * t
    y = cy[s] + u * length[s] * dy[s] + vy[s] * t
    flip = torch.rand(n_edge, generator=gen, device=device) < 0.1
    p = torch.where(flip, -pol[s], pol[s])
    xn = _uniform(gen, n_noise, 0, W, device)
    yn = _uniform(gen, n_noise, 0, H, device)
    tn = _uniform(gen, n_noise, 0, span_s, device)
    pn = torch.where(torch.rand(n_noise, generator=gen, device=device)
                     < 0.5, 1, -1)
    x, y = torch.cat([x, xn]).floor().long(), torch.cat([y, yn]).floor().long()
    t, p = torch.cat([t, tn]), torch.cat([p, pn])
    keep = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    x, y, t, p = x[keep], y[keep], t[keep], p[keep]
    return x, y, t, p, (cx, cy, dx, dy, length, vx, vy)


def _label(cx, cy, dx, dy, length, vx, vy, span_s, scene, H, W, device):
    """Each pixel's 100 ms displacement by its nearest edge (the distance
    to the edge's middle position over the window), valid within
    ``mask_px`` of it."""
    ys = torch.arange(H, device=device, dtype=torch.float64)[:, None]
    xs = torch.arange(W, device=device, dtype=torch.float64)[None, :]
    best = torch.full((H, W), float("inf"), device=device,
                      dtype=torch.float64)
    fx = torch.zeros((H, W), device=device, dtype=torch.float64)
    fy = torch.zeros_like(fx)
    mid = 0.5 * span_s
    for k in range(cx.shape[0]):
        px, py = xs - (cx[k] + vx[k] * mid), ys - (cy[k] + vy[k] * mid)
        along = (px * dx[k] + py * dy[k]).clamp(-0.5 * length[k],
                                                0.5 * length[k])
        d = torch.hypot(px - along * dx[k], py - along * dy[k])
        closer = d < best
        best = torch.where(closer, d, best)
        fx = torch.where(closer, vx[k] * 0.1, fx)
        fy = torch.where(closer, vy[k] * 0.1, fy)
    flow = torch.stack([fx, fy]).float()
    mask = (best <= scene["mask_px"]).float()
    return flow, mask
