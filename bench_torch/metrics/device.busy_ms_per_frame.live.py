"""device.busy_ms_per_frame.live: the seconds in which an operation ran on
the device over the traced window of an open loop, a frame."""


def read(r):
    if r.closed_loop or r.trace is None or not r.window.frames:
        return None
    return r.trace.busy_s() / r.window.frames * 1e3
