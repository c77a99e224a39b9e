"""``corr_lookup_roofline_pct``: E-RAFT's correlation lookups against their
bytes bound in the profiled slice after the window. A row's lookup at one
iteration must read each pixel's 10x10 float32 patch at each of the 4
levels and write its 324 float32 samples
(``configs/<config>.py:lookup_bytes``), at 3.35 TB/s, times the program's
counter ``eraft.lookups`` (rows times iterations). The time is that of the
kernels launched inside the program's ``eraft.lookup`` spans (the sampling
grid, ``grid_sample`` at every level, the samples' concatenation;
``portbench/launches.py``). Nothing to read where the program recorded no
such span or count."""

from portbench import launches, program_trace
from portbench.harness import PEAK_BYTES_PER_S


def read(cell, res):
    t = program_trace.read(cell, res)
    n = t.counters.get("eraft.lookups", 0) if t else 0
    spans = t.within("eraft.lookup") if t else []
    found = launches.read(cell, res) if spans and n > 0 else None
    kernels = found.inside(spans) if found else []
    seconds = sum(b - a for a, b, _ in kernels) / 1e6
    if seconds <= 0:
        return None
    bound = n * res["reckoning"].lookup_bytes(res["program"]) \
        / PEAK_BYTES_PER_S
    return 100.0 * bound / seconds
