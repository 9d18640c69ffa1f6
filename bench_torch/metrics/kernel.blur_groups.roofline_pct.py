"""kernel.blur_groups.roofline_pct: the least time for crt-mattias's blur at the cell's shapes
(``work/blur_groups.py``), once an apply, times the applies of the traced
window, over the device time of every ``blur_groups_kernel`` launch in it, in
percent. Taken over the whole window, so the share does not move with how
many launches the stage takes an apply."""

KERNEL = "blur_groups_kernel"


def read(r):
    if r.trace is None or not r.window.batches:
        return None
    times = r.trace.kernel_s(KERNEL)
    if not times:
        return None
    return r.bound_ms("blur_groups") * r.window.batches / (sum(times) * 1e3) * 100.0
