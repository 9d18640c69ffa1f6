"""queue.copy_out_ms_per_batch: the host's time in the program's
``rctpu.queue.copy_out`` spans (the readback's copy out of its pinned
buffer into a fresh array) over the traced window, a batch."""

SPAN = "rctpu.queue.copy_out"


def read(r):
    if not r.closed_loop or r.trace is None or not r.window.batches:
        return None
    times = [e - s for name, s, e in r.trace.host if name == SPAN]
    return sum(times) / r.window.batches * 1e3 if times else None
