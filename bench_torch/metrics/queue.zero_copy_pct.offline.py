"""queue.zero_copy_pct.offline: the share of the batches handed out in
the traced window that left the readback's pinned buffer with no copy:
100 times the program's ``rctpu.queue.handout`` spans over its
``rctpu.queue.copy_out`` spans. Every batch handed out opens one
``copy_out``; inside it a lent batch opens ``handout``, one copied out at
the buffers' cap ``copy_held``. A program that copies every batch opens
no ``handout`` and reads 0."""

BATCH, LENT = "rctpu.queue.copy_out", "rctpu.queue.handout"


def read(r):
    if not r.closed_loop or r.trace is None:
        return None
    names = [name for name, _, _ in r.trace.host]
    batches = names.count(BATCH)
    return 100.0 * names.count(LENT) / batches if batches else None
