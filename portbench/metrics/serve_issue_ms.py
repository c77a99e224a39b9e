"""``serve_issue_ms``: the host time ``FlowServer``'s dispatch thread spends
putting a group on the card: its buffer's non-blocking copy
(``serve.upload``) and the call that issues the forward's launches
(``serve.issue``), summed over the profiled slice after the window and
divided by the groups they cover, in ms a forward."""

from portbench import program_trace


def read(cell, res):
    t = program_trace.read(cell, res)
    spans = (t.within("serve.upload") + t.within("serve.issue")) if t else []
    if not spans:
        return None
    groups = {key for _, _, key, _ in spans}
    return sum(b - a for a, b, _, _ in spans) / len(groups) / 1e3
