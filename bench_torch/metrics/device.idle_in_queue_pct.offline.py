"""device.idle_in_queue_pct.offline: the share of the traced window in
which no operation runs on the device while the host is inside one of the
program's ``rctpu.queue.*`` spans: the device's idle time that the frame
queue causes, both read on the profiler's clock."""

PREFIX = "rctpu.queue."


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys):
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(r):
    if not r.closed_loop or r.trace is None:
        return None
    queue = _union((s, e) for name, s, e in r.trace.host if name.startswith(PREFIX))
    if not queue:
        return None
    idle = sum(b - a for a, b in queue) - _overlap(queue, r.trace.busy_intervals())
    return idle / r.trace.window_s * 100.0
