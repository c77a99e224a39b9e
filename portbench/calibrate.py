"""The readings a cell's limits are set from, on the chip at the cell's own
size: the program's numbers over many seeds (each a whole run of the cell,
its window ``--seconds`` long) and, on the control seeds, the lower-
precision control's and the planted faults' numbers, each held against the
float32 reference as the run holds the program. One JSON line a seed.

    python3 -m portbench.calibrate --workload <name> --seconds 3 \
        --seeds <n> ... --control-seeds <n> ...

Serving: the control is the reference in bfloat16 with its convs' and
dense layers' operands rounded to float8, on as many of the pool's windows
as a run checks. Training: the control is the reference with TF32 on; the
fault ``half_batch`` trains on half of each batch, the mean over the rest
(a state left unchanged reads 1 on ``move_gap`` by its definition and
needs no run).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import random
import sys
import time


def follow_control(cell, program, device):
    """The spiking reference in bfloat16 put in the program's place on one
    forward of the traffic's batch (as many pool windows, drawn from the
    seed, as the server batches): its input from the raw events by the
    plain front, then rounded to float8 with every PSN, conv and dense
    layer's operands (``fp8``), or left in bfloat16 (``bf16_reference``);
    its state recorded and followed as a run follows the program's."""
    import torch
    from portbench import stitch
    from portbench.drivers import serve
    from portbench.harness import seeded_state
    from portbench.reference import build as ref_build
    from portbench.reference import events as ref_events
    from portbench.reference.precision import fake_fp8
    from portbench.reference.snn.plain import fp8_operands
    pool = serve.make_pool(cell, program, device)
    rows = min(int(cell.traffic["rows"]), len(pool))
    idx = random.Random(cell.seed).sample(range(len(pool)), rows)
    x = torch.stack([ref_events.model_input(pool[i], program, device)
                     for i in idx])
    out = {}
    for name in ("bf16_reference", "fp8"):
        model = ref_build.build(program).to(device)
        model.load_state_dict(seeded_state(model.state_dict(), cell.seed,
                                           device))
        model = model.to(torch.bfloat16)
        for m in model.modules():
            if hasattr(m, "rows_apart"):
                m.rows_apart = True
        cap = stitch.Capture(model)
        cap.arm()
        xin = x.float()
        ctx = fp8_operands() if name == "fp8" else contextlib.nullcontext()
        with ctx, torch.no_grad():
            if name == "fp8":
                xin = fake_fp8(xin)
            model(xin.to(torch.bfloat16))
        cap.close()
        del model
        rec = cap.record
        matched = {b: (i, float((rec.input[b].double() - x[b]).norm()
                                / x[b].norm())) for b, i in enumerate(idx)}
        nums, gap = serve.follow_numbers(program, cell.seed, rec, matched,
                                         device)
        out[name] = {"input_gap": max(g for _, g in matched.values()),
                     "potential_gap": nums["potential_gap"],
                     "attention_gap": nums["attention_gap"],
                     "spike_flips": nums["spike_flips"], "flow_gap": gap,
                     "potential_worst": nums["potential_worst"],
                     "attention_moved": nums["attention_moved"]}
        del rec, cap
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def serve_control(cell, program, device):
    if cell.config.get("check") == "follow":
        return follow_control(cell, program, device)
    from portbench.drivers import serve
    from portbench.reference.compare import flow_gap
    pool = serve.make_pool(cell, program, device)
    k = min(int(cell.traffic["sample"]), len(pool))
    idx = sorted(random.Random(cell.seed).sample(range(len(pool)), k))
    inputs = [pool[i] for i in idx]
    ref = serve.reference_flows(program, cell.seed, inputs, device)
    r16 = serve.reference_flows(program, cell.seed, inputs, device,
                                precision="bf16")
    ctl = serve.reference_flows(program, cell.seed, inputs, device,
                                precision="fp8")
    return {"fp8": {"flow_gap_ratio": serve.gap_ratio(ctl, ref, r16),
                    "flow_gap": max(flow_gap(c, r)
                                    for c, r in zip(ctl, ref))},
            "bf16_reference": {"flow_gap": max(flow_gap(c, r)
                                               for c, r in zip(r16, ref))}}


def train_control(cell, program, device):
    from portbench.drivers import train
    dataset = train.make_dataset(cell, program, device)
    ref = train.reference_steps(cell, program, dataset, device, tf32=False)
    out = {}
    for name, kw in (("tf32", dict(tf32=True)),
                     ("half_batch", dict(fault="half_batch"))):
        other = train.reference_steps(cell, program, dataset, device, **kw)
        out[name] = dict(zip(("loss_gap", "grad_gap", "move_gap"),
                             train.numbers(other, ref)))
        out[name]["per_step_loss_gaps"] = train.per_step_loss_gaps(other,
                                                                   ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=())
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    args = ap.parse_args(argv)
    import torch

    from portbench import run
    from portbench.drivers import common
    run._caches()
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        cell = run.load_cell(args.workload, seed, args.seconds, False,
                             t0=time.perf_counter())
        res = run.execute(cell)
        print(json.dumps({"seed": seed, "program": {
            n: v for n, v, _ in res["checks"]},
            "readings": res.get("readings"), "failed": res["failed"],
            "setup_s": res["setup_s"]}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        cell = run.load_cell(args.workload, seed, args.seconds, False)
        program = common.program_config(cell)
        fn = serve_control if cell.traffic["driver"] == "serve" \
            else train_control
        print(json.dumps({"seed": seed, "control": fn(
            cell, program, torch.device(cell.device))}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
