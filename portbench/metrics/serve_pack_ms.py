"""``serve_pack_ms``: the host time ``FlowServer``'s dispatch thread spends
filling a group's buffer (the raw events' pack, or the voxel chunks'
copy), the program's ``serve.pack`` spans in the profiled slice after the
window over the groups they cover, in ms a forward."""

from portbench import program_trace


def read(cell, res):
    t = program_trace.read(cell, res)
    spans = t.within("serve.pack") if t else []
    if not spans:
        return None
    groups = {key for _, _, key, _ in spans}
    return sum(b - a for a, b, _, _ in spans) / len(groups) / 1e3
