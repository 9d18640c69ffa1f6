"""engine.readback_ms.live: the median over the open loop's frames of the
program's ``rctpu.engine.readback`` span: ``apply_u8`` waiting for the
device and copying the frame to pageable host memory."""

from harness.cell import percentile

SPAN = "rctpu.engine.readback"


def read(r):
    if r.closed_loop or r.trace is None:
        return None
    times = [e - s for name, s, e in r.trace.host if name == SPAN]
    return percentile(times, 50) * 1e3 if times else None
