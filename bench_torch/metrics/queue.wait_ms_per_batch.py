"""queue.wait_ms_per_batch: the host's time blocked on the device inside
the frame queue, a batch: the program's ``rctpu.queue.upload_wait`` (for
a pinned buffer's last upload) and ``rctpu.queue.readback_wait`` (for the
download of the batch before) spans over the traced window."""

SPANS = ("rctpu.queue.upload_wait", "rctpu.queue.readback_wait")


def read(r):
    if not r.closed_loop or r.trace is None or not r.window.batches:
        return None
    times = [e - s for name, s, e in r.trace.host if name in SPANS]
    return sum(times) / r.window.batches * 1e3 if times else None
