"""``serve_idle_in_dispatch_pct``: the share of the card's idle time in the
profiled slice after the window (no kernel running: the gaps of the union
of the kernel intervals, as ``device_idle_pct`` takes them) that falls
inside the union of the dispatch thread's ``serve.pack``, ``serve.upload``
and ``serve.issue`` spans: how much of the idle card waits on the host's
pack and issue of a forward."""

from portbench import program_trace


def read(cell, res):
    t = program_trace.read(cell, res)
    if t is None:
        return None
    dispatch = [(a, b) for name in ("serve.pack", "serve.upload",
                                    "serve.issue")
                for a, b, _, _ in t.within(name)]
    idle = t.idle()
    total = sum(b - a for a, b in idle)
    if not dispatch or total <= 0:
        return None
    return 100.0 * program_trace.overlap(idle, dispatch) / total
