"""device.idle_pct.offline: the share of the traced window in which no
operation ran on the device (torch.profiler's device records)."""


def read(r):
    if not r.closed_loop or r.trace is None:
        return None
    return (1.0 - r.trace.busy_s() / r.trace.window_s) * 100.0
