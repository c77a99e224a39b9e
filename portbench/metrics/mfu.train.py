"""``mfu.train``: the samples trained in the window times the
configuration's FLOPs a trained sample (forward and backward,
``portbench/configs/<config>.py``), over the window's seconds, as a share
of the card's peak in the configuration's training precision (float32
with TF32 off: 67 TFLOP/s, H100 SXM data sheet)."""

from portbench.harness import PEAK_FLOPS

_PEAK = {"fp32_tf32_off": "fp32", "fp32": "tf32", "bf16": "bf16"}


def read(cell, res):
    if "train_samples_per_s" not in res:
        return None
    peak = PEAK_FLOPS[_PEAK[cell.config["precision"]["train"]]]
    return 100.0 * res["train_samples_per_s"] * res["sample_flops"] / peak
