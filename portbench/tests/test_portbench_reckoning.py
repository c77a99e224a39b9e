"""The reckoning modules against ``torch.utils.flop_counter`` on the plain
reference, at small sizes on the CPU: the forward and the trained sample
(forward and backward) count exactly what the architecture computes.

And the question the program's analytic record left open: whether
``utils/flops.py:record_flops_spikingformer`` counts one time step or all
of them: one. At 96x128 the en4 forward's T = 10 steps count 7.9 times
the record (the record leaves out about a fifth of one step's work), not
about once."""

import pytest
import torch
import yaml
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT

from portbench.configs import sdformerflow_en4, sttflownet
from portbench.reference import build as ref_build


def _program(h, w):
    program = yaml.safe_load(open(f"{ROOT}/configs/train_dsec_stt_voxel.yaml"))
    program["loader"]["crop"] = [h, w]
    return program


@pytest.mark.parametrize("h,w", [(72, 96), (54, 70)])
def test_stt_forward_and_trained_sample(h, w):
    program = _program(h, w)
    model = ref_build.build(program)
    x = torch.randn(1, 20, h, w)
    with FlopCounterMode(display=False) as c, torch.no_grad():
        model(x)
    assert c.get_total_flops() == sttflownet.serve_flops_per_window(program)
    model.train()
    with FlopCounterMode(display=False) as c:
        sum(f.sum() for f in model(x)["flow"]).backward()
    assert c.get_total_flops() == sttflownet.train_flops_per_sample(program)


def test_en4_record_counts_one_time_step():
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.training.config import (build_configs,
                                                        load_config)
    from sdformerflow_tpu_torch.utils.flops import (record_flops_spikingformer,
                                                    total_flops)
    cfg = load_config(f"{ROOT}/configs/train_dsec_sdformerflow_en4.yaml")
    cfg["loader"]["crop"] = [96, 128]
    mc, swin, spiking = build_configs(cfg)
    model = get_model(cfg["model"]["name"], mc, swin, spiking)
    x = torch.zeros(1, 10, 2, 96, 128)
    with FlopCounterMode(display=False) as c, torch.no_grad():
        model(x)
    counted = c.get_total_flops() / 2          # multiply-adds
    record = total_flops(record_flops_spikingformer(swin, ms=True))
    T = spiking.num_steps
    # the record is one time step's: all T steps come to near T times it
    assert 0.7 * T * record < counted < 1.3 * T * record


def test_en4_reckoning_is_the_counted_forward():
    """The en4 reckoning (the reference traced on the meta device) counts
    what a real forward of the reference counts at a small size, over all
    T time steps; its sites are the program's 45 K2 sites and, a row
    alone, its 12 attention blocks (at this size a batch's rows take one
    attention call each), each K2 site reading and writing its
    [T, B, H, W, C] bfloat16 once."""
    import json
    program = json.load(open(f"{ROOT}/portbench/configs/"
                             "sdformerflow_en4.json"))["program"]
    program["loader"]["crop"] = [72, 96]
    model = ref_build.build(program)
    with FlopCounterMode(display=False) as c, torch.no_grad():
        model(torch.zeros(1, 10, 2, 72, 96))
    assert sdformerflow_en4.serve_flops_per_window(program) == \
        c.get_total_flops()
    k2 = sdformerflow_en4.k2_site_bytes(program, 2)
    k1 = sdformerflow_en4.k1_site_work(program, 1)
    assert (len(k2), len(k1)) == (45, 12)
    # the embed head's site: T=10, 2 rows, 72x96, 48 channels
    assert k2[0] == 2 * 2 * (10 * 2 * 72 * 96 * 48)
    assert all(b > 0 and f > 0 for b, f in k1)
