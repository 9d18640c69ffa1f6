"""engine.launch_ms.live: the median over the open loop's frames of the
host's time from the start of the program's ``rctpu.engine.apply_u8``
span to the start of the ``rctpu.engine.readback`` span inside it: the
upload, the batch's preparation, the replay's launch and the blit's."""

from bisect import bisect_left

from harness.cell import percentile

CALL, READBACK = "rctpu.engine.apply_u8", "rctpu.engine.readback"


def read(r):
    if r.closed_loop or r.trace is None:
        return None
    readbacks = sorted(s for name, s, _ in r.trace.host if name == READBACK)
    times = []
    for name, s, e in r.trace.host:
        if name == CALL:
            k = bisect_left(readbacks, s)
            if k < len(readbacks) and readbacks[k] <= e:
                times.append(readbacks[k] - s)
    return percentile(times, 50) * 1e3 if times else None
