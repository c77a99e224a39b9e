"""``qk_attn_roofline_pct``: K1's share of its roofline in the profiled
slice after the window. Each attention site's bound is the larger of its
bytes (windows read, output written, weights read; bfloat16) at 3.35 TB/s
and its operations at the bf16 peak (989 TFLOP/s), both from the
configuration's shapes (``portbench/configs/<config>.py``), for every
forward the slice ran; the time is that of the kernels named ``qk_attn``
(``csrc/qk_attn.cu``). The forwards are K1's launches over its sites a
forward. Nothing to read where the kernel did not run."""

from portbench.harness import PEAK_BYTES_PER_S, PEAK_FLOPS, kernel_time


def read(cell, res):
    trace = res.get("trace")
    got = kernel_time(trace, "qk_attn") if trace else None
    if not got or got[1] <= 0:
        return None
    launches, seconds = got
    sites = res["reckoning"].k1_site_work(res["program"],
                                          int(cell.traffic["rows"]))
    bound = sum(max(b / PEAK_BYTES_PER_S, f / PEAK_FLOPS["bf16"])
                for b, f in sites)
    return 100.0 * launches / len(sites) * bound / seconds
