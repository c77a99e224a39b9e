"""``eraft_update_issue_ms``: the host time the dispatch thread spends
issuing E-RAFT's refinement, the program's ``eraft.update`` spans (each an
iteration's lookup and update block, as issued) summed over the profiled
slice after the window and divided by the forwards there (its
``eraft.corr`` spans, one a forward), in ms a forward."""

from portbench import program_trace


def read(cell, res):
    t = program_trace.read(cell, res)
    updates = t.within("eraft.update") if t else []
    forwards = t.within("eraft.corr") if t else []
    if not updates or not forwards:
        return None
    return sum(b - a for a, b, _, _ in updates) / len(forwards) / 1e3
