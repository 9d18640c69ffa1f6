"""queue.copy_out_ms_per_batch: the host's time in the program's
``rctpu.queue.copy_out`` spans (the readback handing a batch out of its
pinned buffer: lent as a view of the buffer, ``rctpu.queue.handout``, or
copied into an array of its own where no buffer would be left for the next
download, ``rctpu.queue.copy_held``) over the traced window, a batch."""

SPAN = "rctpu.queue.copy_out"


def read(r):
    if not r.closed_loop or r.trace is None or not r.window.batches:
        return None
    times = [e - s for name, s, e in r.trace.host if name == SPAN]
    return sum(times) / r.window.batches * 1e3 if times else None
