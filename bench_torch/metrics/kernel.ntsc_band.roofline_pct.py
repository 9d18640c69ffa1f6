"""kernel.ntsc_band.roofline_pct: the least time for ntsc-pass2's FIR at the
cell's shapes (``work/ntsc_band.py``: the FIR's own work, from the chain's
pass sizes), once an apply, times the applies of the traced window, over
the device time of every launch of the stage in it, in percent: the band
product's GEMM kernels (on an H100 with torch 2.11, cuBLAS's
``sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x64x8_...``), any
split-K reduction cuBLAS issues for them, and any kernel whose name holds
``ntsc`` (a FIR kernel that replaces the product). The cell's chain has no
other matrix product."""

from harness import peaks

KERNELS = ("gemm", "splitKreduce", "ntsc")


def read(r):
    if r.trace is None or not r.window.batches:
        return None
    times = [d for name, _, d in r.trace.records if any(k in name for k in KERNELS)]
    if not times:
        return None
    (h, w), (_, ow) = r.cell.work("passes").sizes(r.cell.config, r.cell.src_hw, r.cell.viewport)[:2]
    bound_ms = peaks.bound(*r.cell.work("ntsc_band").work(r.cell.batch, (h, w), (h, ow)))[0]
    return bound_ms * r.window.batches / (sum(times) * 1e3) * 100.0
