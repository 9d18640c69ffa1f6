"""kernel.mattias_epilogue.roofline_pct: the least time for crt-mattias's epilogue at the
cell's shapes (``work/mattias_epilogue.py``), once an apply, times the applies of the
traced window, over the device time of every ``mattias_epilogue_kernel`` launch in
it, in percent. Nothing where no such launch ran (the epilogue as eager passes)."""

KERNEL = "mattias_epilogue_kernel"


def read(r):
    if r.trace is None or not r.window.batches:
        return None
    times = r.trace.kernel_s(KERNEL)
    if not times:
        return None
    return r.bound_ms("mattias_epilogue") * r.window.batches / (sum(times) * 1e3) * 100.0
