"""kernel.nnedi3.roofline_pct: the least time for the chain's nnedi3 passes
at the cell's shapes (``work/nnedi3.py``: the net's own work, each pass's
sizes from ``work/passes.py``), once an apply, times the applies of the
traced window, over the device time of every kernel in it but the
viewport blit's (``resample_u8_kernel``), in percent. Copies and fills
(``Memcpy*``, ``Memset*``: the queue's transfers) are no kernels. The
cell's chain is its four nnedi3 passes and the blit, so the eager passes
today and a fused kernel later read the same work. Nothing where the
chain has no nnedi3 pass."""

from harness import peaks

OUTSIDE = "resample_u8_kernel"
TRANSFERS = ("Memcpy", "Memset")


def read(r):
    if r.trace is None or not r.window.batches:
        return None
    sizes = r.cell.work("passes").sizes(r.cell.config, r.cell.src_hw, r.cell.viewport)
    net = r.cell.work("nnedi3")
    stages = net.stages(r.cell.config, r.cell.src_hw, sizes)
    times = [d for name, _, d in r.trace.records if OUTSIDE not in name and not name.startswith(TRANSFERS)]
    if not stages or not times:
        return None
    bound_ms = peaks.bound(*net.work(r.cell.batch, stages))[0]
    return bound_ms * r.window.batches / (sum(times) * 1e3) * 100.0
