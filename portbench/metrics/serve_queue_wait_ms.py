"""``serve_queue_wait_ms``: the mean of the program's ``serve.queue`` spans
in the profiled slice after the window: each request's wait from its
``FlowServer.submit`` to the start of its group's launch, in ms a
request (``portbench/program_trace.py``)."""

from portbench import program_trace


def read(cell, res):
    t = program_trace.read(cell, res)
    spans = t.within("serve.queue") if t else []
    if not spans:
        return None
    return sum(b - a for a, b, _, _ in spans) / len(spans) / 1e3
