"""kernel.xbr_front.roofline_pct: the least time for xbr-lv2's front section at the cell's
shapes (``work/xbr_front.py``), once an apply, times the applies of the traced
window, over the device time of every ``xbr_front_kernel`` launch in it, in
percent. Nothing where no such launch ran (the front section as eager
passes)."""

KERNEL = "xbr_front_kernel"


def read(r):
    if r.trace is None or not r.window.batches:
        return None
    times = r.trace.kernel_s(KERNEL)
    if not times:
        return None
    return r.bound_ms("xbr_front") * r.window.batches / (sum(times) * 1e3) * 100.0
