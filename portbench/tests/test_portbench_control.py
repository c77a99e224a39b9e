"""The lower-precision control of each cell comes out not correct: the plain
reference put in the program's place, one precision below the
configuration's (serving bf16 -> float8 operands; training float32 with
TF32 off -> TF32 on), judged by the cell's own numbers and limits.

On the CPU at a small size (serving only: the CPU has no TF32); on the
card at each cell's own size over three seeds (``pytest -m cuda``)."""

import time

import pytest

from conftest import ROOT, cuda_or_skip, tiny_cell

from portbench import calibrate, run
from portbench.drivers import common

SEEDS = [3700000001, 3700000002, 3700000003]


def _fails(cell, control):
    lim = cell.limits
    return any(v > lim[k] for k, v in control.items() if k in lim)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_serve_control_fails_small(seed):
    import torch
    cell = tiny_cell("en4_serve_events_b8", seed=seed)
    program = common.program_config(cell)
    ctl = calibrate.serve_control(cell, program, torch.device("cpu"))
    assert _fails(cell, ctl["fp8"]), ctl


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["en4_serve_events_b8", "stt_train_b8"])
def test_control_fails_at_cell_size(workload):
    device = cuda_or_skip()
    for seed in SEEDS:
        cell = run.load_cell(workload, seed, 3.0, False, root=ROOT,
                             t0=time.perf_counter())
        program = common.program_config(cell)
        if cell.traffic["driver"] == "serve":
            ctl = calibrate.serve_control(cell, program, device)["fp8"]
        else:
            ctl = calibrate.train_control(cell, program, device)["tf32"]
        print(workload, seed, ctl)
        assert _fails(cell, ctl), ctl
