"""``train_input_wait_ms``: the harness's host span around taking each
step's batch from the prefetcher and augmenting it, summed over the
window and divided by its steps."""


def read(cell, res):
    return res.get("input_wait_ms")
