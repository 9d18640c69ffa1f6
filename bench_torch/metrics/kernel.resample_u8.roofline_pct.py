"""kernel.resample_u8.roofline_pct: the least time for the viewport blit
with its u8 pack (``work/resample_u8.py``) from the chain's last pass
(``work/passes.py``) to the viewport, once an apply, times the applies of
the traced window, over the device time of every ``resample_u8_kernel``
launch in it, in percent."""

from harness import peaks

KERNEL = "resample_u8_kernel"


def read(r):
    if r.trace is None or not r.window.batches:
        return None
    times = r.trace.kernel_s(KERNEL)
    if not times:
        return None
    last = r.cell.work("passes").sizes(r.cell.config, r.cell.src_hw, r.cell.viewport)[-1]
    vw, vh = r.cell.viewport
    bound_ms = peaks.bound(*r.cell.work("resample_u8").work(r.cell.batch, last, (vh, vw)))[0]
    return bound_ms * r.window.batches / (sum(times) * 1e3) * 100.0
