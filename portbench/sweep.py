"""Find the highest rate a serving cell's system sustains: one server, set up
as the cell's run sets it up, offered the cell's open loop at each rate in
turn for ``--seconds`` each; prints one JSON line a rate (offered and
completed windows/s, latency p50 / p95 / max, the sender's largest
lateness). A rate is sustained when the completed rate is the offered one
and the latencies do not grow over the run.

    python3 -m portbench.sweep --workload <serve cell> --seed <n> \
        --seconds 8 --rates 100 150 200 250
"""

from __future__ import annotations

import argparse
import json
import sys
import time

T0 = time.perf_counter()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from portbench import run
    from portbench.drivers import common, serve
    from portbench.harness import Spans, quantile
    run._caches()
    cell = run.load_cell(args.workload, args.seed, args.seconds, False)
    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA device", file=sys.stderr)
        return 3
    program = common.program_config(cell)
    pool, server = serve.start_server(cell, program, torch.device(cell.device))
    j = 0
    for rate in args.rates:
        client = serve.Client(server, pool, rate)
        start = time.perf_counter() + 0.05
        j = client.send(j, start, args.seconds, Spans())
        client.wait(timeout=120.0)
        end = start + args.seconds
        done = sorted(client.done.values())
        lat = [(t - d) * 1e3 for d, t in done]
        half = len(lat) // 2
        print(json.dumps({
            "offered": rate,
            "completed_per_s": sum(1 for _, t in done if t < end)
            / args.seconds,
            "p50_ms": quantile(lat, 0.5), "p95_ms": quantile(lat, 0.95),
            "max_ms": max(lat),
            "p95_first_half_ms": quantile(lat[:half], 0.95),
            "p95_second_half_ms": quantile(lat[half:], 0.95),
            "late_s": client.late}), flush=True)
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
