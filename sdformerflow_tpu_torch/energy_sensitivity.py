"""Rate-sensitivity of the SynOps energy estimate, the port's counterpart
of ``scripts/energy_sensitivity.py``.

The Spikformer-convention energy (``utils/energy.py``) is affine in the
per-site firing rates: E = E_MAC*analog_MACs + E_AC*sum(rate_s*T_s*F_s).
Given a measured ``spike_rates.json`` (written by ``eval_dsec
--energy_report`` of either package), this prices the flagship en4 forward
at scaled rates, to bound how the estimate moves as training changes the
rate regime. Host arithmetic only: no card needed. Run from the
repository root:

    python -m sdformerflow_tpu_torch.energy_sensitivity \\
        runs/eval/spike_rates.json [--scales=0.5,1,2,4]
"""

from __future__ import annotations

import json
import sys

from .models.common import SwinConfig
from .utils.energy import energy_spikingformer

# the flagship eval protocol (configs/train_dsec_sdformerflow_en4.yaml)
FLAGSHIP = SwinConfig(
    arc_type="swinv1", patch_embed_type="MS_PED_Spiking_PatchEmbed_Conv_sfn",
    input_size=(288, 384), patch_size=(1, 1, 2, 2), depths=(2, 2, 6, 2),
    num_heads=(3, 6, 12, 24), out_indices=(0, 1, 2, 3),
    window_size=(2, 9, 9), qk_scale=0.125)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        rates = json.load(f)
    scales = [float(s) for s in next(
        (a.split("=")[1] for a in argv if a.startswith("--scales=")),
        "0.5,1,2,4").split(",")]
    for s in scales:
        scaled = {k: min(1.0, v * s) for k, v in rates.items()}
        e = energy_spikingformer(FLAGSHIP, scaled, num_steps=10)
        mean_r = sum(scaled.values()) / len(scaled)
        print(f"rate x{s:<4} (mean {mean_r:.4f}): "
              f"{e['energy_mj']:.2f} mJ/forward, "
              f"{e['snn_vs_ann_ratio']:.4f}x ANN")


if __name__ == "__main__":
    main()
