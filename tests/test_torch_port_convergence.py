"""The training A/B (``tests/torch_port_convergence_ab.py``) for a few
steps: the port's ``make_train_step`` against JAX's from JAX's init on the
moving-bar stream, float64 on the CPU. Every step's loss within 1e-8
relative of JAX's, and the final eval AEEs within
1e-8; and the committed 300-step record
(``docs/convergence_ab_torch.json``): no step's gap above 1e-6, final AEEs
within 1e-6.
"""

import json
import os

import numpy as np

import torch_port_convergence_ab as AB
from torch_port_harness import one_torch_thread  # noqa: F401

STEPS = 8
GAP = 1e-8
RECORD = os.path.join(os.path.dirname(__file__), os.pardir, "docs",
                      "convergence_ab_torch.json")


def test_port_trains_as_jax_f64():
    result = AB.run(steps=STEPS, log=lambda m: None)
    j, p = (np.asarray(result[k]) for k in ("jax_f64_losses",
                                            "port_f64_losses"))
    assert len(j) == len(p) == STEPS and np.isfinite(j).all()
    rel = np.abs(p - j) / np.abs(j)
    assert rel.max() < GAP, rel
    assert np.isclose(result["f64_divergence"]["max_rel"], rel.max(),
                      rtol=1e-6, atol=0)
    assert result["f64_divergence"]["first_step_rel_gt_1e-09"] is None
    # the moving bar is learnable: the losses move
    assert len(set(j.round(6))) == STEPS
    assert result["final_aee_rel"] < GAP



def test_committed_long_run_stays_together():
    with open(RECORD) as f:
        rec = json.load(f)
    j, p = (np.asarray(rec[k]) for k in ("jax_f64_losses",
                                         "port_f64_losses"))
    assert rec["steps"] == len(j) == len(p) >= 300
    rel = np.abs(p - j) / np.abs(j)
    assert rel.max() <= 1e-6
    assert rec["f64_divergence"]["first_step_rel_gt_1e-06"] is None
    assert rec["final_aee_rel"] <= 1e-6
