"""``train_batch_wait_ms``: the trainer's wait for its next host batch, the
program's ``train.batch`` spans (``parallel/mesh.py:prefetch_to_device``)
in the profiled slice after the window, over the ``train.step`` spans
there, in ms a step. Inside the harness's ``input_wait`` span, which adds
the batch's copy to the card and its augmentation."""

from portbench import program_trace


def read(cell, res):
    t = program_trace.read(cell, res)
    steps = t.within("train.step") if t else []
    if not steps:
        return None
    waits = t.within("train.batch")
    return sum(b - a for a, b, _, _ in waits) / len(steps) / 1e3
