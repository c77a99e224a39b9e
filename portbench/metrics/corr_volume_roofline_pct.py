"""``corr_volume_roofline_pct``: E-RAFT's correlation volume and pyramid
against their roofline in the profiled slice after the window. A row's
bound is the larger of its operations (``fmap1^T fmap2``, 2 h w h w 256)
at the float32 peak (67 TFLOP/s: the volume is float32, TF32 off) and its
bytes (both feature maps read, every level of the pyramid written, float32)
at 3.35 TB/s, from the configuration's shapes
(``configs/<config>.py:volume_work``), times the rows the program built a
volume for (its counter ``eraft.volumes``, padded rows included). The time
is that of the kernels launched inside the program's ``eraft.corr`` spans
(the product, its scaling, the pooling; ``portbench/launches.py``).
Nothing to read where the program recorded no such span or count."""

from portbench import launches, program_trace
from portbench.harness import PEAK_BYTES_PER_S, PEAK_FLOPS


def read(cell, res):
    t = program_trace.read(cell, res)
    rows = t.counters.get("eraft.volumes", 0) if t else 0
    spans = t.within("eraft.corr") if t else []
    found = launches.read(cell, res) if spans and rows > 0 else None
    kernels = found.inside(spans) if found else []
    seconds = sum(b - a for a, b, _ in kernels) / 1e6
    if seconds <= 0:
        return None
    flops, nbytes = res["reckoning"].volume_work(res["program"])
    bound = max(flops / PEAK_FLOPS["fp32"], nbytes / PEAK_BYTES_PER_S)
    return 100.0 * rows * bound / seconds
