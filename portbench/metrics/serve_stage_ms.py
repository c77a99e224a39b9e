"""``serve_stage_ms``: the host time ``FlowServer``'s staging thread spends
on one request, from taking it off the submit queue to handing its filled
slab to the dispatch thread (the raw events' pack, or the voxel chunk's
copy): the mean of the program's ``serve.stage`` spans in the profiled
slice after the window, in ms a request. A program that stages nothing
off the dispatch thread records no such span: nothing to read."""

from portbench import program_trace


def read(cell, res):
    t = program_trace.read(cell, res)
    spans = t.within("serve.stage") if t else []
    if not spans:
        return None
    return sum(b - a for a, b, _, _ in spans) / len(spans) / 1e3
