"""kernel.xbr_front.roofline_pct: the front section's work formula gives the
bytes bound at the cell's shapes, and the reader reads the window's
``xbr_front_kernel`` launches, and nothing without one."""

import pytest

from harness import loops, peaks
from harness.cell import Readings
from harness.spec import BENCH, load_module, resolve
from harness.trace import DeviceTrace

NAME = "kernel.xbr_front.roofline_pct"
CELL = "xbr-lv2-1080p.offline"
S_MS = 4 * 19 * 64 * 1080 * 320 / peaks.PEAK_BYTES_S * 1e3  # S written once: 0.5018 ms


def test_bound_at_the_cell_shapes():
    nbytes, ops = load_module(BENCH / "work" / "xbr_front.py").work(64, (240, 320), (1080, 1920))
    ms, by = peaks.bound(nbytes, ops)
    assert by == "bytes"
    assert S_MS == pytest.approx(0.5018, abs=0.0001)
    # S, the source's 3 channels (59.0 MB) and the index maps.
    assert ms == pytest.approx(S_MS + (12 * 64 * 240 * 320 + 8 * (324 + 5 * 1080)) / peaks.PEAK_BYTES_S * 1e3)
    assert ms == pytest.approx(0.5194, abs=0.0001)


def _read(records, workload=CELL, batches=4):
    cell = resolve(workload)
    win = loops.Window(t0=0.0, seconds=1.0, frames=batches * cell.batch, batches=batches, next_frame=0)
    r = Readings(cell, win, 10.0, 2**30, {}, DeviceTrace(1.0, records, []) if records is not None else None)
    return cell.reader(NAME).read(r)


def test_reads_the_kernel_launches():
    launches = [("(anonymous namespace)::xbr_front_kernel(float const*, long long)", 0.1 * k, 0.001) for k in range(4)]
    others = [("(anonymous namespace)::xbr_epilogue_kernel(float const*)", 0.5, 0.002),
              ("void at::native::vectorized_elementwise_kernel<4, Mul>", 0.6, 0.01)]
    bound = load_module(BENCH / "work" / "xbr_front.py").work(64, (240, 320), (1080, 1920))
    want = peaks.bound(*bound)[0] * 4 / (4 * 0.001 * 1e3) * 100.0
    assert _read(launches + others) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("case", ["no trace", "no launch", "no batch"])
def test_nothing_to_read(case):
    eager = [("void at::native::vectorized_elementwise_kernel<4, Mul>", 0.0, 0.5),
             ("(anonymous namespace)::xbr_epilogue_kernel(float const*)", 0.5, 0.002)]
    if case == "no trace":
        assert _read(None) is None
    elif case == "no launch":
        assert _read(eager) is None
    else:
        assert _read(eager + [("(anonymous namespace)::xbr_front_kernel()", 0.6, 0.001)], batches=0) is None
