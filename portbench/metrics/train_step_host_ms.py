"""``train_step_host_ms``: the host's issue of one train step, the mean of
the program's ``train.step`` spans (``make_train_step``: input prep,
forward, loss, backward, the optimizer) in the profiled slice after the
window, in ms a step; the card runs the step behind it."""

from portbench import program_trace


def read(cell, res):
    t = program_trace.read(cell, res)
    steps = t.within("train.step") if t else []
    if not steps:
        return None
    return sum(b - a for a, b, _, _ in steps) / len(steps) / 1e3
