"""``serve_padded_rows_pct``: the share of the rows ``FlowServer`` launched
in the profiled slice after the window that carried no request: 100 x
(``serve.rows`` - ``serve.requests``) / ``serve.rows``, the program's
counters over the slice (every group is padded to ``len(devices)`` rows).
"""

from portbench import program_trace


def read(cell, res):
    t = program_trace.read(cell, res)
    rows = t.counters.get("serve.rows", 0) if t else 0
    if rows <= 0:
        return None
    return 100.0 * (rows - t.counters.get("serve.requests", 0)) / rows
