"""Shared pieces of the benchmark's CPU tests: a cell of BENCHMARK.json cut
to a size the CPU runs in seconds (the same code path, smaller shapes), on
one torch thread."""

import copy
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell(workload, seed=2 ** 33 + 5, seconds=2.0, trace=False):
    """``workload`` as BENCHMARK.json has it, its shapes cut for the CPU:
    a 72x96 crop of 96x128 scene windows, batch 2, a pool of 4."""
    from portbench import run
    cell = run.load_cell(workload, seed, seconds, trace, root=ROOT,
                         device="cpu", t0=time.perf_counter())
    cell.config = copy.deepcopy(cell.config)
    p = cell.config["program"]
    p["loader"]["crop"] = [72, 96]
    p["loader"]["resolution"] = [96, 128]
    p["loader"]["batch_size"] = 2
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["scene"].update(resolution=[96, 128], events=[20001, 40000])
    cell.traffic.update(pool=4, rows=2, streams=4, stream_hz=2.0, sample=3,
                        variants=4, roll_px=3, max_pending=8)
    return cell


def cuda_or_skip():
    """The card, decided inside the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda "
                    "portbench/tests)")
    return torch.device("cuda", 0)
