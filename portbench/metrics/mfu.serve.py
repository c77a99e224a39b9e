"""``mfu.serve``: the whole served step's share of the card's dense peak in
the configuration's serving precision (bf16: 989 TFLOP/s, H100 SXM data
sheet): the windows answered in the profiled slice after the window, times
the configuration's operations a window (``portbench/configs/
<config>.py``), over the seconds the card was busy in that slice. Work on
padded rows, and time the card spends on anything but the model, count
against it; below the knee it does not follow the offered rate."""

from portbench.harness import PEAK_FLOPS


def read(cell, res):
    trace = res.get("trace")
    if not trace or not trace.get("windows") or trace["busy_s"] <= 0:
        return None
    flops = res["reckoning"].serve_flops_per_window(res["program"])
    peak = PEAK_FLOPS[cell.config["precision"]["serve"]]
    return 100.0 * trace["windows"] * flops / (trace["busy_s"] * peak)
