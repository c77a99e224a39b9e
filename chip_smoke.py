#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA H100.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build every kernel from the sources in the checkout - K1 and K3 by
   nvcc and the event packer by g++, in parallel, K2 by Triton meanwhile -
   and print the build seconds and ptxas' register and memory report;
2. K1 vs its plain twin at the attention shapes the en4 forward gives it,
   float32 and bfloat16: bitwise on dyadic inputs, flipped-spike share on
   Gaussian and on real captured inputs; timings beside the bound;
3. K2 vs its plain twin at every PSN site shape of the forward, same checks;
4. K3's four entries vs their plain twins at 480x640, 10 and 15 bins, 2^20
   event slots: bitwise on dyadic events, within 1e-4 on uniform ones;
   timings beside the bound;
5. the voxel path: a full-width MS_SpikingformerFlowNet_en4 FlowServer
   (288x384, base 96, depths (2,2,6,2), window (2,9,9), T=10, bf16,
   weights from a seeded torch.Generator) answers voxel requests; launch
   counts, flow shapes, latency and the card's busy time per request
   (profiler) are checked and printed;
6. the raw-events path on the same server: synthetic DSEC-like windows of
   0.6-1.0 x 2^20 events at 480x640 (and 4 in the 2^21 bucket) are packed,
   voxelized by K3, center-cropped to 288x384 and run through the forward;
   K3 +1 and K1 +12 launches per request; on exact (dyadic) windows the
   events flow equals the voxel flow of the plain twin's grid bit for bit;
   latency, throughput and the pieces of a request (host pack, H2D, K3,
   forward) are printed;
7. kernel path vs plain path: float32 forwards on the card (TF32 off) with
   the kernels and with the plain twins, at 96x128 and at full width. Each
   kernel launch of the kernel path is held against its plain twin on the
   same input (flipped-spike share); with no flip the two forwards must be
   identical. Printed beside: the AEE of the plain path with one spike
   flipped, and of both paths to a float64 CPU forward.

The line before the card's name is a JSON object with each kernel's
launches, error, times and bound; then the card's name and power limit;
the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It needs one CUDA card and the CUDA toolkit; it imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "train_dsec_sdformerflow_en4.yaml")
SEED = 0
N_LATENCY = 64     # requests sent one at a time: the latency percentiles
N_QUEUED = 64      # requests queued at once: the throughput
# a Gaussian-input comparison may differ where a potential lands within
# float32 rounding of the threshold; more than this share of flipped
# output spikes is a fault, not rounding
MAX_FLIP_SHARE = 1e-3


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dyadic(shape, step, lo, hi, gen, device, dtype):
    """Values on a power-of-two grid: every float32 sum of them is exact."""
    import torch
    n = int(round((hi - lo) / step)) + 1
    v = torch.randint(0, n, shape, generator=gen) * step + lo
    return v.to(device, dtype)


# ------------------------------------------------------------ phase 1

def phase_build(torch, dev):
    """Build every kernel of the checkout: the two CUDA sources (nvcc) and
    the host event packer (g++) in parallel, Triton's K2 in this thread
    meanwhile. Returns the wall seconds of the whole build."""
    from concurrent.futures import ThreadPoolExecutor
    from sdformerflow_tpu_torch import kernel_build, native
    from sdformerflow_tpu_torch.ops.hopper_psn import fused_affine_psn

    def timed(build, source):
        t0 = time.perf_counter()
        _, compiler_log = build(source)
        return time.perf_counter() - t0, compiler_log

    t_start = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        jobs = {
            "K1 qk_attn.cu (nvcc)": pool.submit(
                timed, kernel_build.build_cuda_library, "qk_attn.cu"),
            "K3 voxel.cu (nvcc)": pool.submit(
                timed, kernel_build.build_cuda_library, "voxel.cu"),
            "event_ops.cpp (g++)": pool.submit(
                timed, kernel_build.build_host_library, "event_ops.cpp"),
        }
        t0 = time.perf_counter()
        with torch.inference_mode():
            for dt in (torch.float32, torch.bfloat16):
                x = torch.zeros(10, 4, 8, device=dev, dtype=dt)
                w = torch.zeros(10, 10, device=dev)
                b = torch.zeros(10, 1, device=dev)
                c = torch.ones(8, device=dev)
                fused_affine_psn(x, w, b)
                fused_affine_psn(x, w, b, scale=c, shift=c)
            torch.cuda.synchronize()
        t_triton = time.perf_counter() - t0
        builds = {name: job.result() for name, job in jobs.items()}
    for name, (secs, compiler_log) in builds.items():
        log(f"[1] build {name}: {secs:.2f} s")
        if compiler_log.strip():
            log(compiler_log.strip())
    kernel_build.load_cuda_library("qk_attn.cu")
    kernel_build.load_cuda_library("voxel.cu")
    native._lib()
    wall = time.perf_counter() - t_start
    log(f"[1] build: K2 triton {t_triton:.2f} s; all kernels {wall:.2f} s "
        f"wall (nvcc, g++ and triton in parallel)")
    return wall


# ------------------------------------------------------------- bounds
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, float32 FLOP/s outside the tensor cores

HBM_BYTES_S = 3.35e12
BF16_TC_FLOP_S = 989e12
F32_FLOP_S = 67e12


def bound(n_bytes, flops, peak_flop_s):
    """(least ms, "bytes" or "operations"): each input byte read once and
    each output byte written once at HBM speed, or the operations at the
    peak rate of their type, whichever takes longer."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak_flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------- model set-up

def load_en4(torch):
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.training.config import build_configs, load_config
    config = load_config(CONFIG)
    model_cfg, swin, cfg = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg, swin, cfg)
    randomize_(model, torch.Generator().manual_seed(SEED))
    return config, model.state_dict()


def voxel_requests(n, bins, hw, seed):
    """Synthetic signed voxel windows: sparse, like event voxel grids."""
    rng = np.random.default_rng(seed)
    shape = (bins,) + tuple(hw)
    return [(rng.standard_normal(shape) * (rng.random(shape) < 0.3)
             ).astype(np.float32) for _ in range(n)]


def capture_sites(torch, model, run):
    """Run ``run()`` with hooks on every attention and PSN site of
    ``model``; returns (attention inputs, PSN site signatures)."""
    from sdformerflow_tpu_torch.models.spiking_layers import SpikingNeuron
    from sdformerflow_tpu_torch.models.spiking_swin import (
        SpikingQKWindowAttention3D)
    attn, psn, handles = [], [], []

    def on_attn(mod, args):
        attn.append((mod, args[0].detach().clone()))

    def on_psn(mod, args, kwargs):
        x = args[0]
        psn.append((tuple(x.shape), x.dtype, kwargs.get("affine") is not None))

    attn_ids = set()
    for m in model.modules():
        if isinstance(m, SpikingQKWindowAttention3D):
            attn_ids.update(id(s) for s in m.modules())
            handles.append(m.register_forward_pre_hook(on_attn))
    for m in model.modules():
        if isinstance(m, SpikingNeuron) and id(m) not in attn_ids:
            handles.append(m.register_forward_pre_hook(on_psn,
                                                       with_kwargs=True))
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return attn, psn


# ------------------------------------------------------------ phase 2

def phase_k1(torch, dev, attn_inputs):
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    gen = torch.Generator().manual_seed(SEED + 1)
    shapes = {}
    for mod, x in attn_inputs:
        key = (tuple(x.shape), mod.num_heads)
        shapes.setdefault(key, []).append((mod, x))
    max_err, worst_flip, ms, plain_ms = 0.0, 0.0, 0.0, 0.0
    rates = []
    bound_by = {"bytes": 0.0, "operations": 0.0}
    for (shape, nh), sites in shapes.items():
        mod, x_real = sites[0]
        _, M, wh, ww, C = shape
        ns = wh * ww
        for dt in (torch.float32, torch.bfloat16):
            # dyadic: x on a 1/4 grid, weights/pe on 1/8, affines on 1/4,
            # PSN weights on 1/4 - every f32 sum is exact in any order
            g = lambda *s, step=0.125, lo=-1.0, hi=1.0: dyadic(  # noqa: E731
                s, step, lo, hi, gen, dev, torch.float32)
            psn = lambda: (g(2, 2, step=0.25), g(2, step=0.25))  # noqa: E731
            (w_in, b_in), (w_q, b_q), (w_k, b_k) = psn(), psn(), psn()
            w_t, b_t = g(2, 2, step=0.25), g(2, step=1.0, lo=-4.0, hi=0.0)
            p = A.QKAttnParams(
                w_in=w_in, b_in=b_in, wq=g(C, C).to(dt),
                aq=g(C, step=0.25, lo=0.25, hi=2.0), cq=g(C),
                w_q=w_q, b_q=b_q, wk=g(C, C).to(dt),
                ak=g(C, step=0.25, lo=0.25, hi=2.0), ck=g(C),
                pe=g(2, ns, C).to(dt), w_k=w_k, b_k=b_k, w_t=w_t, b_t=b_t,
                wp=g(C, C), bp=g(C), ap=g(C), cp=g(C))
            x = dyadic(shape, 0.25, -2.0, 2.0, gen, dev, dt)
            got = A.qk_attn_interior(x, p, nh).float()
            want = A.qk_attn_interior_plain(x, p, nh).float()
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            check(err == 0.0, f"K1 {shape} {dt} dyadic: max|d| = {err}")
            check(0.0 < got.mean().item() < 1.0,
                  f"K1 {shape} {dt} dyadic: degenerate output")
            # Gaussian input through the model's own (random) weights
            p_mod = mod.kernel_params()
            xg = torch.randn(shape, generator=gen).to(dev, dt)
            flip = (A.qk_attn_interior(xg, p_mod, nh)
                    != A.qk_attn_interior_plain(xg, p_mod, nh)
                    ).float().mean().item()
            worst_flip = max(worst_flip, flip)
            log(f"[2] K1 M={M} C={C} nh={nh} {str(dt)[6:]}: dyadic max|d| "
                f"{err} (bitwise), gaussian flipped share {flip:.3g}")
            check(flip <= MAX_FLIP_SHARE, f"K1 gaussian flips {flip}")
        # the real main-path inputs (bf16), their firing and timings
        p_real = mod.kernel_params()
        real_flip = 0.0
        for m_, xr in sites:
            a = A.qk_attn_interior(xr, m_.kernel_params(), nh)
            flip = (a != A.qk_attn_interior_plain(xr, m_.kernel_params(), nh)
                    ).float().mean().item()
            worst_flip = max(worst_flip, flip)
            real_flip = max(real_flip, flip)
            check(flip <= MAX_FLIP_SHARE, f"K1 real-input flips {flip}")
            rates.append(a.float().mean().item())
        t_k = cuda_time_ms(lambda: A.qk_attn_interior(x_real, p_real, nh))
        t_p = cuda_time_ms(
            lambda: A.qk_attn_interior_plain(x_real, p_real, nh))
        ms += t_k * len(sites)
        plain_ms += t_p * len(sites)
        # x read and the 0/1 products written once, the weights, pe and
        # affine/PSN rows read once; 4 C x C products per row (q and k, two
        # halves), on the bf16 tensor cores (0/1 x bf16 is exact there)
        site_bytes = (2 * nbytes(x_real) + 2 * C * C * x_real.element_size()
                      + 2 * ns * C * x_real.element_size() + 4 * C * 4
                      + 24 * 4)
        site_flops = 8 * M * ns * C * C
        b_ms, by = bound(site_bytes, site_flops, BF16_TC_FLOP_S)
        bound_by[by] += b_ms * len(sites)
        log(f"[2] K1 M={M} C={C} bf16 x{len(sites)}/forward: main-path "
            f"inputs flipped share {real_flip:.3g}; kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms; {site_bytes / 1e6:.2f} MB, "
            f"{site_flops / 1e9:.3f} GFLOP, bound {b_ms:.4f} ms ({by}), "
            f"kernel at {100 * b_ms / t_k:.1f}% of it")
    bound_ms = sum(bound_by.values())
    return dict(max_abs_err=max_err, flip_share=worst_flip, ms=ms,
                plain_ms=plain_ms, rates=rates, n_shapes=len(shapes),
                bound_ms=bound_ms, bound_by=max(bound_by, key=bound_by.get))


# ------------------------------------------------------------ phase 3

def phase_k2(torch, dev, psn_sites):
    from sdformerflow_tpu_torch.ops.hopper_psn import (fused_affine_psn,
                                                       psn_spike)
    gen = torch.Generator().manual_seed(SEED + 2)
    sites = {}
    for sig in psn_sites:
        sites[sig] = sites.get(sig, 0) + 1
    max_err, worst_flip, ms, plain_ms = 0.0, 0.0, 0.0, 0.0
    bound_by = {"bytes": 0.0, "operations": 0.0}
    for (shape, sdt, affine), count in sites.items():
        T, C = shape[0], shape[-1]
        errs, flips = [], []
        for dt in (torch.float32, torch.bfloat16):
            w = dyadic((T, T), 0.125, -1.0, 1.0, gen, dev, torch.float32)
            b = dyadic((T, 1), 0.25, -1.0, 1.0, gen, dev, torch.float32)
            kw = (dict(scale=dyadic((C,), 0.25, 0.25, 2.0, gen, dev,
                                    torch.float32),
                       shift=dyadic((C,), 0.25, -1.0, 1.0, gen, dev,
                                    torch.float32)) if affine else {})
            x = dyadic(shape, 0.25, -2.0, 2.0, gen, dev, dt)
            got = fused_affine_psn(x, w, b, **kw).float()
            err = (got - psn_spike(x, w, b, **kw).float()).abs().max().item()
            max_err = max(max_err, err)
            check(err == 0.0, f"K2 {shape} {dt} dyadic: max|d| = {err}")
            errs.append(err)
            wg = torch.randn(T, T, generator=gen).to(dev) * 0.4
            bg = torch.randn(T, 1, generator=gen).to(dev) * 0.4
            kwg = (dict(scale=torch.rand(C, generator=gen).to(dev) + 0.5,
                        shift=torch.randn(C, generator=gen).to(dev))
                   if affine else {})
            xg = torch.randn(shape, generator=gen).to(dev, dt)
            flip = (fused_affine_psn(xg, wg, bg, **kwg)
                    != psn_spike(xg, wg, bg, **kwg)).float().mean().item()
            worst_flip = max(worst_flip, flip)
            check(flip <= MAX_FLIP_SHARE, f"K2 gaussian flips {flip}")
            flips.append(flip)
        xt = torch.randn(shape, generator=gen).to(dev, sdt)
        t_k = cuda_time_ms(lambda: fused_affine_psn(xt, wg, bg, **kwg))
        t_p = cuda_time_ms(lambda: psn_spike(xt, wg, bg, **kwg))
        ms += t_k * count
        plain_ms += t_p * count
        # x read and the spikes written once, W/b (and the affine) read
        # once; T x T multiply-adds per column in float32 on the CUDA cores
        n_col = xt.numel() // T
        site_bytes = (2 * nbytes(xt) + (T * T + T) * 4
                      + (2 * C * 4 if affine else 0))
        site_flops = 2 * T * T * n_col + (2 * T * n_col if affine else 0)
        b_ms, by = bound(site_bytes, site_flops, F32_FLOP_S)
        bound_by[by] += b_ms * count
        log(f"[3] K2 {list(shape)} affine={affine} x{count}/forward: dyadic "
            f"max|d| f32/bf16 {errs}, gaussian flipped share {flips}; "
            f"{str(sdt)[6:]} kernel {t_k:.4f} ms, plain {t_p:.4f} ms; "
            f"{site_bytes / 1e6:.2f} MB, bound {b_ms:.4f} ms ({by}), "
            f"kernel at {100 * b_ms / t_k:.1f}% of it")
    bound_ms = sum(bound_by.values())
    return dict(max_abs_err=max_err, flip_share=worst_flip, ms=ms,
                plain_ms=plain_ms, n_sites=len(psn_sites), bound_ms=bound_ms,
                bound_by=max(bound_by, key=bound_by.get))


# ------------------------------------------------------------ phase 4
# K3, the voxelizer, at the sensor size of the raw-events path

SENSOR = (480, 640)
K3_EVENTS = 1 << 20
K3_TOL = 1e-4     # abs and rel, the tolerance of tests/test_pallas_voxel.py
# float operations of one valid event, by mode: t_n 3, corner weights
# 3 axes x 2 corners x 2, the value 2, then 3 multiplies and 1 add per
# corner (8 corners); v2 6 + 4, frames 5 + 8 + 4 x 2
K3_FLOPS = {"signed": 49, "polarities": 47, "v2": 10, "frames": 21}


def k3_entries():
    from sdformerflow_tpu_torch.ops import hopper_voxel as K
    from sdformerflow_tpu_torch.ops import voxel as V
    return {
        "signed": (K.voxel_grid_signed_k3, V.voxel_grid_signed, "num_bins",
                   {}),
        "polarities": (K.voxel_grid_polarities_k3, V.voxel_grid_polarities,
                       "num_bins", {}),
        "v2": (K.events_to_voxel_grid_v2_k3, V.events_to_voxel_grid_v2,
               "num_bins", {"normalize": False}),
        "frames": (K.events_to_frames_k3, V.events_to_frames, "num_frames",
                   {}),
    }


def k3_events(torch, gen, dev, bins, exact):
    """K3_EVENTS event slots over the sensor frame, from one unit before
    to one unit beyond each edge, the last 1/16 padding (valid False).
    Dyadic: x/y/t on a 1/4 grid, t in [0, bins - 1], t_range (0, bins - 1):
    every weight and every sum is exact. Else uniform, t in [0, 1]."""
    n, (h, w) = K3_EVENTS, SENSOR
    if exact:
        x = dyadic((n,), 0.25, -1.0, w + 1.0, gen, dev, torch.float32)
        y = dyadic((n,), 0.25, -1.0, h + 1.0, gen, dev, torch.float32)
        t = dyadic((n,), 0.25, 0.0, bins - 1.0, gen, dev, torch.float32)
        t_range = (0.0, bins - 1.0)
    else:
        x = (torch.rand(n, generator=gen) * (w + 2) - 1).to(dev)
        y = (torch.rand(n, generator=gen) * (h + 2) - 1).to(dev)
        t = torch.rand(n, generator=gen).sort().values.to(dev)
        t_range = (0.0, 1.0)
    p = torch.randint(0, 2, (n,), generator=gen).float().to(dev)
    valid = (torch.arange(n) < n - n // 16).to(dev)
    return (x, y, t, p), valid, t_range


def phase_k3(torch, dev):
    """The four K3 entries vs their plain twins at 480x640, 10 and 15
    bins, 2^20 event slots: bitwise on dyadic events, within K3_TOL on
    uniform ones; kernel and twin times beside the bound."""
    gen = torch.Generator().manual_seed(SEED + 10)
    rows, max_err, max_rand_err = {}, 0.0, 0.0
    for bins in (10, 15):
        dy_ev, dy_valid, dy_range = k3_events(torch, gen, dev, bins, True)
        ev, valid, t_range = k3_events(torch, gen, dev, bins, False)
        for kind, (entry, plain, bins_kw, extra) in k3_entries().items():
            kw = {bins_kw: bins, "height": SENSOR[0], "width": SENSOR[1],
                  **extra}
            got = entry(*dy_ev, valid=dy_valid, t_range=dy_range, **kw)
            want = plain(*dy_ev, valid=dy_valid, t_range=dy_range, **kw)
            err = (got - want).abs().max().item()
            check(err == 0.0, f"K3 {kind} bins={bins} dyadic: max|d| {err}")
            check(want.abs().sum().item() > 0, f"K3 {kind}: all-zero grid")
            max_err = max(max_err, err)
            run = lambda f: f(*ev, valid=valid, t_range=t_range, **kw)  # noqa: E731
            got, want = run(entry), run(plain)
            d = (got - want).abs()
            rand_err = d.max().item()
            check(bool((d <= K3_TOL + K3_TOL * want.abs()).all()),
                  f"K3 {kind} bins={bins} uniform: max|d| {rand_err}")
            check(got.abs().sum().item() > 0, f"K3 {kind}: all-zero grid")
            max_rand_err = max(max_rand_err, rand_err)
            t_k = cuda_time_ms(lambda: run(entry))
            t_p = cuda_time_ms(lambda: run(plain))
            n_valid = int(valid.sum())
            n_bytes = nbytes(*ev, valid, got)
            b_ms, by = bound(n_bytes, K3_FLOPS[kind] * n_valid, F32_FLOP_S)
            rows[(kind, bins)] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                                      bound_by=by, mb=n_bytes / 1e6)
            log(f"[4] K3 {kind} {bins}x{SENSOR[0]}x{SENSOR[1]}, "
                f"{K3_EVENTS} slots ({n_valid} valid): dyadic max|d| {err} "
                f"(bitwise), uniform max|d| {rand_err:.3g}; kernel "
                f"{t_k:.4f} ms, plain {t_p:.4f} ms; {n_bytes / 1e6:.2f} MB, "
                f"bound {b_ms:.4f} ms ({by}), kernel at "
                f"{100 * b_ms / t_k:.1f}% of it")
    main = rows[("signed", 10)]
    return dict(main, max_abs_err=max_err, uniform_max_abs_err=max_rand_err,
                rows=rows)


# ------------------------------------------------------------ phase 5

def device_ms_per_call(torch, run, n):
    """Device time per call of ``run``: the union of the kernel intervals
    that ``torch.profiler`` records over ``n`` calls, divided by ``n``.
    None if the profiler records no kernel."""
    from torch.profiler import ProfilerActivity, profile
    trace = os.path.join(ROOT, "sdformerflow_tpu_torch", "_build",
                         "smoke_forward_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") == "kernel")
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    return (busy + hi - lo) / 1e3 / n


def phase_slice(torch, server, hw, card):
    from sdformerflow_tpu_torch.ops import hopper_attn, hopper_psn
    requests = voxel_requests(N_LATENCY + N_QUEUED, 10, hw, SEED + 3)
    hopper_attn.qk_attn_interior.launches = 0
    hopper_psn.fused_affine_psn.launches = 0
    latencies, flows = [], []
    for r in requests[:N_LATENCY]:        # one at a time: latency
        t0 = time.perf_counter()
        flows.append(server.infer(r))
        latencies.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()              # all queued: throughput
    futs = [server.submit(r) for r in requests[N_LATENCY:]]
    flows += [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    k1 = hopper_attn.qk_attn_interior.launches
    k2 = hopper_psn.fused_affine_psn.launches
    n = len(requests)
    for f in flows:
        check(f.shape == (2,) + tuple(hw), f"flow shape {f.shape}")
        check(np.isfinite(f).all(), "non-finite flow")
    check(k1 == 12 * n, f"K1 launched {k1} times for {n} requests, "
          f"expected {12 * n}")
    check(k2 > 0 and k2 % n == 0, f"K2 launched {k2} times for {n} requests")
    p50, p90 = (float(v) for v in np.percentile(latencies, [50, 90]))
    # outside the counted run: how much of a request the card is busy
    dev_ms = device_ms_per_call(torch, lambda: server.infer(requests[0]), 8)
    log(f"[5] voxel path: {n} requests, flows {list(flows[0].shape)} "
        f"finite; K1 {k1} launches ({k1 // n}/request), K2 {k2} "
        f"({k2 // n}/request)")
    log(f"[5] latency over {N_LATENCY} requests one at a time on {card}: "
        f"p50 {p50:.2f} ms, p90 {p90:.2f}, min {min(latencies):.2f}, max "
        f"{max(latencies):.2f}; {N_QUEUED} queued requests in "
        f"{wall * 1e3:.1f} ms = {N_QUEUED / wall:.2f} windows/s; mean |flow| "
        f"{float(np.mean([np.abs(f).mean() for f in flows])):.4g}")
    log("[5] device busy per request (union of kernel intervals, profiler, "
        "8 requests): " + ("not measured: the profiler recorded no kernel"
                           if dev_ms is None else
                           f"{dev_ms:.3f} ms, {100 * dev_ms / p50:.1f}% of "
                           f"the p50"))
    return dict(k1=k1, k2=k2, p50=p50, p90=p90, device_ms=dev_ms,
                windows_per_s=N_QUEUED / wall)



# ------------------------------------------------------------ phase 6
# the raw-events path: FlowServer with dict requests at sensor resolution

N_WINDOWS = 16    # distinct synthetic windows, cycled through


def dsec_windows(n, lo, hi, seed):
    """Synthetic DSEC-like windows at 480x640: uint16 x/y, int64
    microsecond t sorted over 100 ms, uint8 p; lo..hi x 2^20 events."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.uniform(lo, hi) * K3_EVENTS)
        out.append({
            "x": rng.integers(0, SENSOR[1], m, dtype=np.uint16),
            "y": rng.integers(0, SENSOR[0], m, dtype=np.uint16),
            "t": np.sort(rng.integers(0, 100_000, m, dtype=np.int64)),
            "p": rng.integers(0, 2, m, dtype=np.uint8)})
    return out


def dyadic_window(rng, bins, m):
    """A window whose grid is exact: x/y on a 1/4 grid from one unit
    before to one unit beyond the frame, integer t from 0 to 4 (bins - 1)
    with both ends present, so the server's valid-span t_range puts t_n on
    a 1/4 grid."""
    h, w = SENSOR
    t = rng.integers(0, 4 * (bins - 1) + 1, m).astype(np.int64)
    t[:2] = 0, 4 * (bins - 1)
    return {"x": (rng.integers(-4, 4 * (w + 1), m) * 0.25).astype(np.float32),
            "y": (rng.integers(-4, 4 * (h + 1), m) * 0.25).astype(np.float32),
            "t": t, "p": rng.integers(0, 2, m).astype(np.uint8)}


def phase_events(torch, dev, server, card):
    from sdformerflow_tpu_torch import native
    from sdformerflow_tpu_torch.ops import hopper_attn, hopper_psn
    from sdformerflow_tpu_torch.ops import hopper_voxel
    from sdformerflow_tpu_torch.ops.voxel import voxel_grid_signed
    from sdformerflow_tpu_torch.serving import next_bucket
    from sdformerflow_tpu_torch.training.train_step import (center_crop,
                                                            voxelize_batch)
    bins = server._num_bins
    crop = server._crop
    windows = dsec_windows(N_WINDOWS, 0.6, 1.0, SEED + 8)
    big = dsec_windows(4, 1.1, 1.9, SEED + 9)       # the 2^21 bucket
    server.warmup(K3_EVENTS)
    server.warmup(2 * K3_EVENTS)
    hopper_attn.qk_attn_interior.launches = 0
    hopper_psn.fused_affine_psn.launches = 0
    hopper_voxel.voxel_k3.launches = 0
    latencies, flows = [], []
    for i in range(N_LATENCY):               # one at a time: latency
        t0 = time.perf_counter()
        flows.append(server.infer(windows[i % N_WINDOWS]))
        latencies.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()                 # all queued: throughput
    futs = [server.submit(windows[i % N_WINDOWS]) for i in range(N_QUEUED)]
    flows += [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    flows += [server.infer(r) for r in big]
    k1 = hopper_attn.qk_attn_interior.launches
    k2 = hopper_psn.fused_affine_psn.launches
    k3 = hopper_voxel.voxel_k3.launches
    n = len(flows)
    for f in flows:
        check(f.shape == (2,) + tuple(crop), f"events flow shape {f.shape}")
        check(np.isfinite(f).all(), "non-finite events flow")
    check(k3 == n, f"K3 launched {k3} times for {n} events requests")
    check(k1 == 12 * n, f"K1 launched {k1} times for {n} events requests")
    check(k2 > 0 and k2 % n == 0, f"K2 launched {k2} times for {n} "
          f"events requests")
    check(next_bucket(len(big[0]["x"])) == 2 * K3_EVENTS,
          "no request in the 2^21 bucket")
    p50, p90 = (float(v) for v in np.percentile(latencies, [50, 90]))
    log(f"[6] events path: {n} requests at {SENSOR[0]}x{SENSOR[1]} "
        f"({min(len(w['x']) for w in windows)}-"
        f"{max(len(w['x']) for w in windows)} events, 4 in the 2^21 "
        f"bucket), flows {list(flows[0].shape)} finite; K3 {k3} launches "
        f"({k3 // n}/request), K1 {k1} ({k1 // n}/request), K2 {k2} "
        f"({k2 // n}/request)")
    log(f"[6] events latency over {N_LATENCY} requests one at a time on "
        f"{card}: p50 {p50:.2f} ms, p90 {p90:.2f}, min {min(latencies):.2f},"
        f" max {max(latencies):.2f}; {N_QUEUED} queued in "
        f"{wall * 1e3:.1f} ms = {N_QUEUED / wall:.2f} windows/s")

    # end-to-end identity on exact grids: events request == the voxel
    # request of its plain-twin grid after the same crop, bit for bit
    rng = np.random.default_rng(SEED + 11)
    for m in (K3_EVENTS * 2 // 3, K3_EVENTS):
        req = dyadic_window(rng, bins, m)
        ev = [torch.from_numpy(np.asarray(req[k], np.float32)).to(dev)
              for k in "xytp"]
        grid = voxel_grid_signed(*ev, num_bins=bins, height=SENSOR[0],
                                 width=SENSOR[1],
                                 t_range=(0.0, 4.0 * (bins - 1)))
        chunk = center_crop(grid, crop).cpu().numpy()
        check(np.abs(chunk).sum() > 0, "dyadic window: empty crop")
        f_ev, f_vox = server.infer(req), server.infer(chunk)
        check(np.array_equal(f_ev, f_vox), f"events vs voxel request on a "
              f"dyadic window of {m}: max|d| {np.abs(f_ev - f_vox).max()}")
    log(f"[6] dyadic windows ({K3_EVENTS * 2 // 3} and {K3_EVENTS} events):"
        f" events flow == voxel flow of the plain-twin grid, bit for bit")

    # where a request's time goes, piece by piece
    pack_ms, sorted_ms = [], []
    for w in windows:
        t0 = time.perf_counter()
        buf = server.pack_events(w)
        pack_ms.append((time.perf_counter() - t0) * 1e3)
        out = np.empty((5, buf.shape[-1]), np.float32)
        t0 = time.perf_counter()
        native.pack_window_sorted(w["x"], w["y"], w["t"], w["p"],
                                  buf.shape[-1], SENSOR[0], t0=0.0, out=out)
        sorted_ms.append((time.perf_counter() - t0) * 1e3)
    buf = server.pack_events(windows[0])
    h2d_ms = cuda_time_ms(lambda: buf.to(dev, non_blocking=True))
    dbuf = buf.to(dev)
    ev = {"x": dbuf[:, 0], "y": dbuf[:, 1], "t": dbuf[:, 2], "p": dbuf[:, 3],
          "valid": dbuf[:, 4] != 0}
    vox = dict(num_bins=bins, height=SENSOR[0], width=SENSOR[1])
    with torch.inference_mode():
        k3_ms = cuda_time_ms(lambda: voxelize_batch(ev, **vox))
        cropped = center_crop(voxelize_batch(ev, **vox), crop).contiguous()
        fwd_ms = cuda_time_ms(lambda: server._step(cropped), iters=10)
    dev_ms = device_ms_per_call(torch, lambda: server.infer(windows[0]), 8)
    pieces = dict(pack_ms=float(np.median(pack_ms)),
                  pack_sorted_ms=float(np.median(sorted_ms)),
                  h2d_ms=h2d_ms, k3_ms=k3_ms, forward_ms=fwd_ms)
    log(f"[6] per request ({len(windows[0]['x'])} events in a "
        f"{buf.shape[-1]} bucket): host pack (pack_window into pinned "
        f"memory) median {pieces['pack_ms']:.2f} ms over {N_WINDOWS} "
        f"windows, pack_window_sorted {pieces['pack_sorted_ms']:.2f} ms; "
        f"H2D {buf.numel() * 4 / 1e6:.1f} MB {h2d_ms:.3f} ms; voxelize_batch "
        f"(span + K3) {k3_ms:.3f} ms; forward at {crop[0]}x{crop[1]} "
        f"(CUDA events, back-to-back) {fwd_ms:.2f} ms")
    log("[6] device busy per events request (profiler, 8 requests): "
        + ("not measured: the profiler recorded no kernel" if dev_ms is None
           else f"{dev_ms:.3f} ms, {100 * dev_ms / p50:.1f}% of the p50"))
    return dict(k1=k1, k2=k2, k3=k3, p50=p50, p90=p90, device_ms=dev_ms,
                windows_per_s=N_QUEUED / wall, **pieces)

# ------------------------------------------------------------ phase 7

@contextlib.contextmanager
def site_functions(psn, attend):
    """Run the model's PSN sites through ``psn`` and its attention sites
    through ``attend``, in place of the wrappers that dispatch by device."""
    from sdformerflow_tpu_torch.models import spiking_layers, spiking_swin
    saved = spiking_layers.fused_affine_psn, spiking_swin.fused_qk_attention
    spiking_layers.fused_affine_psn = psn
    spiking_swin.fused_qk_attention = attend
    try:
        yield
    finally:
        spiking_layers.fused_affine_psn, spiking_swin.fused_qk_attention = \
            saved


def checked_kernels(flips):
    """Site functions that launch the kernels and add up, in ``flips``, the
    output spikes where a launch disagrees with its plain twin on the same
    input: keys K1 and K2, each [flipped, total]."""
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops.hopper_psn import (fused_affine_psn,
                                                       psn_spike)

    def psn(x, w, b, scale=None, shift=None):
        y = fused_affine_psn(x, w, b, scale=scale, shift=shift)
        want = psn_spike(x, w, b, scale=scale, shift=shift)
        flips["K2"][0] += int((y != want).sum())
        flips["K2"][1] += y.numel()
        return y

    def attend(x, p, nh):
        a = A.qk_attn_interior(x, p, nh)
        flips["K1"][0] += int((a != A.qk_attn_interior_plain(x, p, nh)).sum())
        flips["K1"][1] += a.numel()
        return A.qk_attn_tail(a, p, nh, x.shape, x.dtype)
    return psn, attend


def plain_twins(flip_one=False):
    """Site functions of the plain twins. With ``flip_one``, the first
    attention site's first output spike is flipped: the witness of how far
    one flipped spike carries through the forward."""
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops.hopper_psn import psn_spike
    pending = [flip_one]

    def attend(x, p, nh):
        a = A.qk_attn_interior_plain(x, p, nh)
        if pending[0]:
            pending[0] = False
            a.view(-1)[0] = 1 - a.view(-1)[0]
        return A.qk_attn_tail(a, p, nh, x.shape, x.dtype)
    return psn_spike, attend


def phase_ab(torch, dev, config, state_dict):
    """Kernel path vs plain path in float32 on the card. Every kernel launch
    of the kernel path is held against its plain twin on the same input;
    with no flipped spike the two forwards must be identical. The plain path
    with one spike flipped and a float64 CPU forward are printed beside."""
    from sdformerflow_tpu_torch.losses import aee_metrics
    from sdformerflow_tpu_torch.models.common import SpikingConfig, SwinConfig
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.training.config import build_configs
    from sdformerflow_tpu_torch.training.train_step import make_eval_step
    model_cfg, swin, cfg = build_configs(config)
    name = config["model"]["name"]
    small_swin = SwinConfig(input_size=(96, 128), depths=(2, 2, 2, 2),
                            num_heads=(2, 2, 4, 4), window_size=(2, 3, 3))
    small_cfg = {"num_bins": 10, "base_num_channels": 16}
    small_state = randomize_(
        get_model(name, small_cfg, small_swin, SpikingConfig(
            num_steps=10, v_th=0.1, neuron_type="psn")),
        torch.Generator().manual_seed(SEED + 5)).state_dict()
    out = {}
    for label, mcfg, sw, sd in (("96x128", small_cfg, small_swin,
                                 small_state),
                                ("288x384", model_cfg, swin, state_dict)):
        hw = tuple(sw.input_size)
        chunk = torch.from_numpy(voxel_requests(1, 10, hw, SEED + 4)[0])[None]
        model = get_model(name, mcfg, sw, cfg)
        model.load_state_dict(sd)
        f = {"ref": make_eval_step(model.double())(chunk.double())[-1]}
        step = make_eval_step(model.float().to(dev))
        flips = {"K1": [0, 0], "K2": [0, 0]}
        for key, sites in (("kernels", checked_kernels(flips)),
                           ("plain", plain_twins()),
                           ("one_flip", plain_twins(flip_one=True))):
            with site_functions(*sites):
                f[key] = step(chunk.to(dev))[-1].double().cpu()
        del model, step
        torch.cuda.empty_cache()
        check(all(bool(torch.isfinite(v).all()) for v in f.values()),
              f"{label}: non-finite flow")
        ones = torch.ones_like(f["ref"][:, :1])
        aee = {f"{a}_vs_{b}": aee_metrics(f[a], f[b], ones)["AEE"].item()
               for a, b in (("kernels", "plain"), ("one_flip", "plain"),
                            ("kernels", "ref"), ("plain", "ref"))}
        mag = f["ref"].norm(dim=1).mean().item()
        log(f"[7] {label} f32 on the card: kernel launches vs their plain "
            f"twins on the same inputs: K1 {flips['K1'][0]} of "
            f"{flips['K1'][1]} spikes flipped, K2 {flips['K2'][0]} of "
            f"{flips['K2'][1]}")
        log(f"[7] {label} AEE kernels vs plain {aee['kernels_vs_plain']:.6g}; "
            f"plain with one spike flipped vs plain "
            f"{aee['one_flip_vs_plain']:.6g}; vs the f64 CPU forward: "
            f"kernels {aee['kernels_vs_ref']:.6g}, plain "
            f"{aee['plain_vs_ref']:.6g}; mean |flow| {mag:.6g}")
        for k, (n_flip, n) in flips.items():
            check(n > 0 and n_flip <= MAX_FLIP_SHARE * n,
                  f"{label}: {k} flipped {n_flip} of {n} spikes")
        if flips["K1"][0] + flips["K2"][0] == 0:
            check(torch.equal(f["kernels"], f["plain"]),
                  f"{label}: no kernel launch flipped a spike, yet the "
                  f"kernel path differs from the plain path")
        out[label] = dict(aee, K1_flipped=flips["K1"][0],
                          K2_flipped=flips["K2"][0])
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    try:
        from sdformerflow_tpu_torch.ops import hopper_attn, hopper_psn
        from sdformerflow_tpu_torch.serving import FlowServer
    except ImportError as e:
        print(f"FAIL: run from the repository root ({e})", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    dev = torch.device("cuda", 0)
    # float32 means float32 in every phase (bf16 work is unaffected)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)} [{card}]")
    t_start = time.perf_counter()
    try:
        build_s = phase_build(torch, dev)
        config, state_dict = load_en4(torch)
        server = FlowServer(config, state_dict, device=dev, bf16=True)
        try:
            hw = tuple(config["loader"]["crop"])
            attn_in, psn_sites = capture_sites(
                torch, server.model, lambda: server.infer(
                    voxel_requests(1, 10, hw, SEED + 7)[0]))
            check(len(attn_in) == 12, f"{len(attn_in)} attention sites")
            with torch.inference_mode():
                k1 = phase_k1(torch, dev, attn_in)
                k2 = phase_k2(torch, dev, psn_sites)
            del attn_in
            rates = k1["rates"]
            log(f"[2] K1 output firing rate per block: "
                + ", ".join(f"{r:.3f}" for r in rates))
            check(all(0.0 < r < 1.0 for r in rates),
                  "K1 sites fire all-0 or all-1: the checks would be vacuous")
            k3 = phase_k3(torch, dev)
            sl = phase_slice(torch, server, hw, card)
            evp = phase_events(torch, dev, server, card)
        finally:
            server.close()
        ab = phase_ab(torch, dev, config, state_dict)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    check_no_jax = [m for m in sys.modules
                    if m in ("jax", "sdformerflow_tpu")
                    or m.startswith(("jax.", "sdformerflow_tpu."))]
    if check_no_jax:
        print(f"FAIL: JAX modules imported: {check_no_jax[:5]}",
              file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s "
        f"(build {build_s:.1f} s)")
    # launches: the raw-events path's run (phase 6); K1 and K2 also give
    # the voxel path's (phase 5)
    kernels = [
        {"name": "K1 fused spiking-QK attention interior", "route": "cuda",
         "source": "sdformerflow_tpu_torch/csrc/qk_attn.cu",
         "replaces": "sdformerflow_tpu/ops/pallas_attn.py:382",
         "launches": evp["k1"], "launches_voxel_path": sl["k1"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None,
         "flip_share": k1["flip_share"]},
        {"name": "K2 fused affine PSN forward", "route": "triton",
         "source": "sdformerflow_tpu_torch/ops/hopper_psn.py",
         "replaces": "sdformerflow_tpu/ops/pallas_psn.py:80",
         "launches": evp["k2"], "launches_voxel_path": sl["k2"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None,
         "flip_share": k2["flip_share"]},
        {"name": "K3 event voxel-grid scatter (signed, 10x480x640, 2^20 "
                 "slots)", "route": "cuda",
         "source": "sdformerflow_tpu_torch/csrc/voxel.cu",
         "replaces": "sdformerflow_tpu/ops/pallas_voxel.py:135",
         "launches": evp["k3"], "max_abs_err": k3["max_abs_err"],
         "uniform_max_abs_err": k3["uniform_max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None},
    ]
    log(json.dumps({"voxel_path": {
        "p50_ms": sl["p50"], "p90_ms": sl["p90"],
        "windows_per_s": sl["windows_per_s"],
        "device_ms_per_request": sl["device_ms"]},
        "events_path": {k: v for k, v in evp.items()
                        if k not in ("k1", "k2", "k3")},
        "f32_ab": ab}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
