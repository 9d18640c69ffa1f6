"""latency_p50_ms: the median, over every frame of an open loop's window,
of the time from the frame's due time to its u8 answer on the host."""

from harness.cell import percentile


def read(r):
    if r.closed_loop:
        return None
    return percentile(r.window.latency_s, 50) * 1e3
