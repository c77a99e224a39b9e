"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is looked up by name in ``BENCHMARK.json`` at the checkout's root;
its configuration (``portbench/configs/<config>.json``), its traffic mix
(``portbench/traffic/<traffic>.json``, which names its driver,
``portbench/drivers/<driver>.py``), its limits
(``portbench/limits/<workload>.json``) and each per-layer metric's reader
(``portbench/metrics/<metric>.py``) are found by name. The run sets up,
warms up, measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON line: with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
read from a profiled slice after the window. It fails, printing no result,
without a card, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.getcwd()
HERE = os.path.dirname(os.path.abspath(__file__))


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(workload: str, seed: int, seconds: float, trace: bool, *,
              root: str = ROOT, device: str = "cuda:0", t0: float = T0):
    """Everything BENCHMARK.json and the files named by it say about one
    cell."""
    bench = _json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]
    return SimpleNamespace(
        workload=workload, config_name=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]), seed=int(seed), seconds=float(seconds),
        trace=bool(trace), t0=t0, device=device,
        config=_json(root, conf["file"]),
        traffic=_json(HERE, "traffic", w["traffic"] + ".json"),
        limits=_json(HERE, "limits", workload + ".json"),
        end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]))


def reader(name: str):
    """The per-layer metric ``name``'s reader, ``portbench/metrics/
    <name>.py``, else the reader of the quantity it splits by the
    end-to-end metric it moves, ``portbench/metrics/<name up to its first
    dot>.py`` (``device_idle_pct.serve`` -> ``device_idle_pct.py``)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def execute(cell) -> dict:
    """The driver's run of the cell: its measurements, trace and checks."""
    driver = importlib.import_module("portbench.drivers."
                                     + cell.traffic["driver"])
    return driver.run(cell)


def result_line(cell, res: dict, kind: str) -> dict:
    """The result's JSON object, its checks the last key."""
    metrics = {}
    if cell.trace:
        for m in cell.per_layer:
            v = reader(m["name"])(cell, res)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": res[m["name"]], "unit": m["unit"]}
    checks = {name: {"value": v, "limit": lim} for name, v, lim
              in res["checks"]}
    correct = res["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": res.get("memory_peak_bytes", 0)}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    trace = res.get("trace")
    if cell.trace and trace:
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        line["breakdown"] = {"device_ops": trace["device_ops"],
                             "idle_gaps": trace["idle_gaps"]}
    line["checks"] = checks
    return line


def _caches():
    """Every build and kernel cache at a fixed place inside the checkout."""
    cache = os.path.join(HERE, "_out", "cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    cell = load_cell(args.workload, args.seed, args.seconds, args.trace)
    import torch
    from portbench.harness import card_info, forbidden_modules
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    kind = torch.cuda.get_device_name(0)
    res = execute(cell)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    line = result_line(cell, res, kind)
    print(f"portbench: {cell.workload} seed {cell.seed} on {kind} "
          f"({card_info()}), setup_s {res.get('setup_s')}, "
          f"readings {json.dumps(res.get('readings', {}))}",
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
