"""kernel.mattias_epilogue.roofline_pct: the epilogue's work formula gives the
bytes counted by hand at the cell's shapes, and the reader reads the
window's ``mattias_epilogue_kernel`` launches, and nothing without one."""

import pytest

from harness import loops, peaks
from harness.cell import Readings
from harness.spec import BENCH, load_module, resolve
from harness.trace import DeviceTrace

NAME = "kernel.mattias_epilogue.roofline_pct"
CELL = "crt-mattias-1080p.offline"
# The 3 planes read (796 MB), RGBA written (1,062 MB), the 5 f32 maps and the
# one-byte inside test read once (43.5 MB), at [32, 1080, 1920].
BYTES = 3 * 4 * 32 * 1080 * 1920 + 16 * 32 * 1080 * 1920 + (5 * 4 + 1) * 1080 * 1920


def _work():
    return load_module(BENCH / "work" / "mattias_epilogue.py").work(32, (240, 320), (1080, 1920))


def test_bytes_at_the_cell_shapes():
    nbytes, ops = _work()
    assert nbytes == BYTES == 1_901_491_200
    ms, by = peaks.bound(nbytes, ops)
    assert by == "bytes"
    assert ms == pytest.approx(0.5676, abs=0.0001)
    assert ops / peaks.PEAK_F32_S * 1e3 < ms


def _read(records, workload=CELL, batches=4):
    cell = resolve(workload)
    win = loops.Window(t0=0.0, seconds=1.0, frames=batches * cell.batch, batches=batches, next_frame=0)
    r = Readings(cell, win, 10.0, 2**30, {}, DeviceTrace(1.0, records, []) if records is not None else None)
    return cell.reader(NAME).read(r)


def test_reads_the_kernel_launches():
    launches = [("void (anonymous namespace)::mattias_epilogue_kernel<4>(Args, Consts)", 0.1 * k, 0.002)
                for k in range(4)]
    others = [("(anonymous namespace)::blur_groups_kernel(float const*)", 0.5, 0.005),
              ("void at::native::vectorized_elementwise_kernel<4, Mul>", 0.6, 0.01)]
    want = peaks.bound(*_work())[0] * 4 / (4 * 0.002 * 1e3) * 100.0
    assert _read(launches + others) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("case", ["no trace", "no launch", "no batch"])
def test_nothing_to_read(case):
    eager = [("void at::native::vectorized_elementwise_kernel<4, Mul>", 0.0, 0.5),
             ("(anonymous namespace)::blur_groups_kernel(float const*)", 0.5, 0.005)]
    if case == "no trace":
        assert _read(None) is None
    elif case == "no launch":
        assert _read(eager) is None
    else:
        assert _read(eager + [("(anonymous namespace)::mattias_epilogue_kernel<4>()", 0.6, 0.002)], batches=0) is None
