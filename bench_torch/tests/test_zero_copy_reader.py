"""queue.zero_copy_pct.offline over synthetic traces: 0 where every batch
is copied out, 100 where every batch is lent, the share in between, and
nothing without a trace, without a ``copy_out`` span or in the open loop."""

import pytest

from harness import loops
from harness.cell import Readings
from harness.spec import resolve
from harness.trace import DeviceTrace

NAME = "queue.zero_copy_pct.offline"
OFFLINE, LIVE = "crt-mattias-1080p.offline", "crt-mattias-1080p.live"
BUSY = [("k1", 0.0, 0.5)]


def _batch(t, inner=None):
    spans = [("rctpu.queue.readback", t, t + 0.1), ("rctpu.queue.copy_out", t + 0.05, t + 0.1)]
    if inner:
        spans.append((inner, t + 0.06, t + 0.09))
    return spans


def read(host, workload=OFFLINE, trace=True):
    cell = resolve(workload)
    win = loops.Window(t0=0.0, seconds=2.0, frames=4 * cell.batch, batches=4, next_frame=0)
    r = Readings(cell, win, 10.0, 2**30, {}, DeviceTrace(2.0, BUSY, host) if trace else None)
    return cell.reader(NAME).read(r)


def test_every_batch_copied_reads_0():
    assert read(_batch(0.0) + _batch(0.5) + [("rctpu.queue.upload", 0.2, 0.3)]) == 0.0


def test_every_batch_lent_reads_100():
    assert read(_batch(0.0, "rctpu.queue.handout") + _batch(0.5, "rctpu.queue.handout")) == 100.0


def test_a_batch_copied_at_the_cap_counts_against():
    host = [s for k in range(3) for s in _batch(0.5 * k, "rctpu.queue.handout")] + _batch(1.5, "rctpu.queue.copy_held")
    assert read(host) == pytest.approx(75.0, rel=1e-12)


@pytest.mark.parametrize("case", ["no trace", "no copy_out", "open loop"])
def test_nothing_to_read(case):
    lent = _batch(0.0, "rctpu.queue.handout")
    if case == "no trace":
        assert read(lent, trace=False) is None
    elif case == "no copy_out":
        assert read([("bench.queue", 0.0, 2.0), ("rctpu.queue.upload", 0.1, 0.2)]) is None
    else:
        assert read(lent, workload=LIVE) is None
