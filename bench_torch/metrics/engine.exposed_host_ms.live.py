"""engine.exposed_host_ms.live: the median service time of ``apply_u8``
(host clock around the call: upload, launch, readback to a numpy array)
less the device's busy time a frame: the host's part of a frame's
latency."""

from harness.cell import percentile


def read(r):
    if r.closed_loop or r.trace is None or not r.window.frames:
        return None
    return percentile(r.window.spans["call"], 50) * 1e3 - r.trace.busy_s() / r.window.frames * 1e3
