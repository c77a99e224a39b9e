"""``psn_fwd_roofline_pct``: K2's share of its roofline in the profiled
slice after the window. The bound is the bytes of the configuration's PSN
sites (each reads its input potential and writes its spikes, bfloat16;
``portbench/configs/<config>.py``) for every forward the slice ran, at the
card's 3.35 TB/s; the time is that of the kernels named ``psn_fwd_kernel``
(``csrc/psn.cu``). The forwards are K2's launches over its sites a
forward. Nothing to read where the kernel did not run."""

from portbench.harness import PEAK_BYTES_PER_S, kernel_time


def read(cell, res):
    trace = res.get("trace")
    got = kernel_time(trace, "psn_fwd_kernel") if trace else None
    if not got or got[1] <= 0:
        return None
    launches, seconds = got
    sites = res["reckoning"].k2_site_bytes(res["program"],
                                           int(cell.traffic["rows"]))
    forwards = launches / len(sites)
    return 100.0 * forwards * sum(sites) / PEAK_BYTES_PER_S / seconds
