#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA H100.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build the kernels from the sources in the checkout (CUDA K1 via nvcc,
   Triton K2) and print the build seconds;
2. K1 vs its plain twin at the attention shapes the en4 forward gives it,
   float32 and bfloat16: bitwise on dyadic inputs, flipped-spike share on
   Gaussian and on real captured inputs; timings;
3. K2 vs its plain twin at every PSN site shape of the forward, same checks;
4. the slice: a full-width MS_SpikingformerFlowNet_en4 FlowServer (288x384,
   base 96, depths (2,2,6,2), window (2,9,9), T=10, bf16, weights from a
   seeded torch.Generator) answers voxel requests; launch counts, flow
   shapes, firing rates, latency and the card's busy time per request
   (profiler) are checked and printed;
5. kernel path vs plain path: float32 forwards on the card (TF32 off) with
   the kernels and with the plain twins, at 96x128 and at full width. Each
   kernel launch of the kernel path is held against its plain twin on the
   same input (flipped-spike share); with no flip the two forwards must be
   identical. Printed beside: the AEE of the plain path with one spike
   flipped, and of both paths to a float64 CPU forward.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is
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
    from sdformerflow_tpu_torch import kernel_build
    from sdformerflow_tpu_torch.ops.hopper_psn import fused_affine_psn
    t0 = time.perf_counter()
    _, ptxas = kernel_build.build_cuda_library("qk_attn.cu")
    kernel_build.load_cuda_library("qk_attn.cu")
    t_nvcc = time.perf_counter() - t0
    log(ptxas.strip())
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
    log(f"[1] build: K1 nvcc {t_nvcc:.2f} s, K2 triton {t_triton:.2f} s")
    return t_nvcc + t_triton


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
        log(f"[2] K1 M={M} C={C} bf16 x{len(sites)}/forward: main-path "
            f"inputs flipped share {real_flip:.3g}; kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms")
    return dict(max_abs_err=max_err, flip_share=worst_flip, ms=ms,
                plain_ms=plain_ms, rates=rates, n_shapes=len(shapes))


# ------------------------------------------------------------ phase 3

def phase_k2(torch, dev, psn_sites):
    from sdformerflow_tpu_torch.ops.hopper_psn import (fused_affine_psn,
                                                       psn_spike)
    gen = torch.Generator().manual_seed(SEED + 2)
    sites = {}
    for sig in psn_sites:
        sites[sig] = sites.get(sig, 0) + 1
    max_err, worst_flip, ms, plain_ms = 0.0, 0.0, 0.0, 0.0
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
        log(f"[3] K2 {list(shape)} affine={affine} x{count}/forward: dyadic "
            f"max|d| f32/bf16 {errs}, gaussian flipped share {flips}; "
            f"{str(sdt)[6:]} kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
    return dict(max_abs_err=max_err, flip_share=worst_flip, ms=ms,
                plain_ms=plain_ms, n_sites=len(psn_sites))


# ------------------------------------------------------------ phase 4

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
    log(f"[4] slice: {n} requests, flows {list(flows[0].shape)} finite; K1 "
        f"{k1} launches ({k1 // n}/request), K2 {k2} ({k2 // n}/request)")
    log(f"[4] latency over {N_LATENCY} requests one at a time on {card}: "
        f"p50 {p50:.2f} ms, p90 {p90:.2f}, min {min(latencies):.2f}, max "
        f"{max(latencies):.2f}; {N_QUEUED} queued requests in "
        f"{wall * 1e3:.1f} ms = {N_QUEUED / wall:.2f} windows/s; mean |flow| "
        f"{float(np.mean([np.abs(f).mean() for f in flows])):.4g}")
    log("[4] device busy per request (union of kernel intervals, profiler, "
        "8 requests): " + ("not measured: the profiler recorded no kernel"
                           if dev_ms is None else
                           f"{dev_ms:.3f} ms, {100 * dev_ms / p50:.1f}% of "
                           f"the p50"))
    return dict(k1=k1, k2=k2, p50=p50, p90=p90, device_ms=dev_ms,
                windows_per_s=N_QUEUED / wall)


# ------------------------------------------------------------ phase 5

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
        log(f"[5] {label} f32 on the card: kernel launches vs their plain "
            f"twins on the same inputs: K1 {flips['K1'][0]} of "
            f"{flips['K1'][1]} spikes flipped, K2 {flips['K2'][0]} of "
            f"{flips['K2'][1]}")
        log(f"[5] {label} AEE kernels vs plain {aee['kernels_vs_plain']:.6g}; "
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
            log(f"[4] K1 output firing rate per block: "
                + ", ".join(f"{r:.3f}" for r in rates))
            check(all(0.0 < r < 1.0 for r in rates),
                  "K1 sites fire all-0 or all-1: the checks would be vacuous")
            sl = phase_slice(torch, server, hw, card)
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
    kernels = [
        {"name": "K1 fused spiking-QK attention interior", "route": "cuda",
         "source": "sdformerflow_tpu_torch/csrc/qk_attn.cu",
         "replaces": "sdformerflow_tpu/ops/pallas_attn.py:382",
         "launches": sl["k1"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "flip_share": k1["flip_share"]},
        {"name": "K2 fused affine PSN forward", "route": "triton",
         "source": "sdformerflow_tpu_torch/ops/hopper_psn.py",
         "replaces": "sdformerflow_tpu/ops/pallas_psn.py:80",
         "launches": sl["k2"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "flip_share": k2["flip_share"]},
    ]
    log(json.dumps({"p50_ms": sl["p50"], "p90_ms": sl["p90"],
                    "windows_per_s": sl["windows_per_s"],
                    "device_ms_per_request": sl["device_ms"], "f32_ab": ab}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
