"""``device_idle_pct.<kind>``: the share of the profiled slice after the
window in which no kernel ran on the card (the union of the kernel
intervals of the ``torch.profiler`` trace). One quantity, split by name
for each end-to-end metric its cells report (``.serve``, ``.train``)."""


def read(cell, res):
    trace = res.get("trace")
    if not trace:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
