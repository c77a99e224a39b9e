"""K2's launch times at the PSN sites of an en4 request on the card: this
checkout's ``csrc/psn.cu`` without and with its potential output, beside
the ``psn.cu`` of another checkout (``--baseline``), built with the same
flags and launched on the same inputs, in turns (baseline, this, this,
baseline), each kernel alone (prepared launches) and in a CUDA graph.

    python -m sdformerflow_tpu_torch.bench_psn --baseline <checkout> \\
        [--iters 50]

The sites are those of a bf16 request to the en4 model of
``configs/train_dsec_sdformerflow_en4.yaml`` (288x384, seeded random
weights: the shapes matter, not the values). Prints a line per site shape,
the sums per request, the card's name and power limit, and a JSON line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
from pathlib import Path

import numpy as np
import torch

from . import kernel_build
from .bench_serving import CONFIG, card_name
from .models.registry import get_model, randomize_
from .models.spiking_layers import SpikingNeuron
from .ops import hopper_psn
from .training.config import build_configs, load_config
from .training.train_step import make_eval_step


def build_baseline(checkout: Path):
    """Compile ``<checkout>/sdformerflow_tpu_torch/csrc/psn.cu`` with this
    package's nvcc flags into ``_build/`` and load it, its ``psn_fwd``
    typed after its own declaration: (library, pointer arguments of
    ``psn_fwd``, 6 without the potential output, 7 with it)."""
    src = checkout / "sdformerflow_tpu_torch" / "csrc" / "psn.cu"
    flags = kernel_build.NVCC_FLAGS
    lib = kernel_build.BUILD_DIR / (
        f"psn-baseline-{kernel_build.source_digest(src, flags, src.parent)}"
        ".so")
    if not lib.exists():
        import subprocess
        kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([kernel_build._nvcc(), *flags, "-o", str(lib),
                        str(src)], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    decl = re.search(r'extern "C" int psn_fwd\(([^)]*)\)',
                     src.read_text()).group(1)
    n_ptr = sum("*" in p for p in decl.split(",")[:-1])   # not the stream
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    dll.psn_fwd.argtypes = [P] * n_ptr + [I64] + [I] * 5 + [P]
    dll.psn_fwd.restype = I
    return dll, n_ptr


def site_shapes(dev):
    """{(shape, dtype, affine): calls} of the PSN sites of one bf16 en4
    request."""
    config = load_config(CONFIG)
    model_cfg, swin, cfg = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg, swin, cfg)
    randomize_(model, torch.Generator().manual_seed(0))
    step = make_eval_step(model.to(dev), compute_dtype=torch.bfloat16)
    sites = {}

    def hook(mod, args, kwargs):
        sig = (tuple(args[0].shape), args[0].dtype,
               kwargs.get("affine") is not None)
        sites[sig] = sites.get(sig, 0) + 1
    for m in step.model.modules():
        if isinstance(m, SpikingNeuron) and m.kind == "psn":
            m.register_forward_pre_hook(hook, with_kwargs=True)
    hw = config["loader"]["crop"]
    step(torch.rand(1, 10, *hw, device=dev))
    return sites


def device_ms(launch, iters):
    """Mean device ms of ``launch`` over ``iters`` back-to-back calls, and
    over ``iters`` calls replayed from one CUDA graph."""
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    torch.cuda.synchronize()
    alone = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            launch()
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return alone, start.elapsed_time(end) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="root of the checkout to compare with")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_psn: needs a CUDA device")
    dev = torch.device("cuda", 0)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        base_f = pool.submit(build_baseline, args.baseline)
        pool.submit(hopper_psn._lib).result()
        base, n_ptr = base_f.result()
    gen = torch.Generator().manual_seed(14)
    keys = ("base", "this", "this_h", "base_graph", "this_graph",
            "this_h_graph")
    total = dict.fromkeys(keys, 0.0)
    for (shape, dt, affine), count in site_shapes(dev).items():
        T, C = shape[0], shape[-1]
        x = torch.randn(shape, generator=gen).to(dev, dt)
        w = (torch.randn(T, T, generator=gen) * 0.4).to(dev, dt)
        b = (torch.randn(T, 1, generator=gen) * 0.4).to(dev, dt)
        kw = (dict(scale=(torch.rand(C, generator=gen) + 0.5).to(dev),
                   shift=torch.randn(C, generator=gen).to(dev))
              if affine else {})
        this, out = hopper_psn.prepare_k2(x, w, b, **kw)
        this_h = hopper_psn.prepare_k2(x, w, b, return_v=True, **kw)[0]
        out_b = torch.empty_like(out)
        a = hopper_psn.k2_args(x, w, b, kw.get("scale"), kw.get("shift"),
                               out_b)
        a = a if n_ptr == 7 else a[:6] + a[7:]

        def base_launch(a=a):   # through the same host path as ``this``
            hopper_psn._launch("baseline K2", base.psn_fwd, a, dev)

        t = {}
        for name, fn in (("base", base_launch), ("this", this),
                         ("this", this), ("base", base_launch),
                         ("this_h", this_h)):
            alone, graph = device_ms(fn, args.iters)
            t.setdefault(name, []).append(alone)
            t.setdefault(name + "_graph", []).append(graph)
        torch.cuda.synchronize()
        if not torch.equal(out, out_b):
            raise SystemExit(f"bench_psn: {shape} the two kernels' spikes "
                             "differ")
        row = {k: float(np.mean(v)) for k, v in t.items()}
        for k in keys:
            total[k] += row[k] * count
        print(f"{list(shape)} {str(dt)[6:]} affine={affine} x{count}: "
              + ", ".join(f"{k} {row[k]:.4f}" for k in keys) + " ms",
              flush=True)
    card = card_name()
    print("per request: " + ", ".join(f"{k} {total[k]:.4f}" for k in keys)
          + f" ms [{card}]")
    result = {"k2_per_request_ms": total, "card": card}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
