"""kernel.xbr_epilogue.roofline_pct: the least time for xbr-lv2's epilogue at the cell's shapes
(``work/xbr_epilogue.py``), once an apply, times the applies of the traced
window, over the device time of every ``xbr_epilogue_kernel`` launch in it, in
percent. Taken over the whole window, so the share does not move with how
many launches the stage takes an apply."""

KERNEL = "xbr_epilogue_kernel"


def read(r):
    if r.trace is None or not r.window.batches:
        return None
    times = r.trace.kernel_s(KERNEL)
    if not times:
        return None
    return r.bound_ms("xbr_epilogue") * r.window.batches / (sum(times) * 1e3) * 100.0
