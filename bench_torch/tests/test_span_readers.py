"""The readers of the program's spans (``rctpu.*`` host ranges) over a
synthetic trace: their exact values, idle time that a queue span overlaps
only in part, and nothing where the spans are absent (a program without
them) or the loop is the other kind."""

import pytest

from harness import loops
from harness.cell import Readings
from harness.spec import resolve
from harness.trace import DeviceTrace

OFFLINE, LIVE = "crt-mattias-1080p.offline", "crt-mattias-1080p.live"
QUEUE = ("queue.copy_out_ms_per_batch", "queue.wait_ms_per_batch", "device.idle_in_queue_pct.offline")
ENGINE = ("engine.launch_ms.live", "engine.readback_ms.live")

# Busy [0, 0.5], [0.6, 1.0], [1.5, 1.6] of a 2 s window.
BUSY = [("k1", 0.0, 0.5), ("k2", 0.6, 0.4), ("k3", 1.5, 0.1)]
QUEUE_SPANS = [
    ("rctpu.queue.stack", 0.40, 0.55),  # idle 0.50-0.55 only
    ("rctpu.queue.upload", 0.55, 0.70),  # idle 0.55-0.60 only
    ("rctpu.queue.upload_wait", 0.56, 0.58),
    ("rctpu.queue.readback", 1.10, 1.55),  # idle 1.10-1.50
    ("rctpu.queue.readback_wait", 1.10, 1.30),
    ("rctpu.queue.copy_out", 1.30, 1.55),
    ("rctpu.queue.copy_out", 1.80, 1.90),  # all idle
    ("bench.producer", 1.0, 1.1),  # idle, but no queue span
    ("rctpu.engine.apply", 0.0, 0.45),
]
# Frames k at 20 ms: (launch, readback) of 3+1, 1+5 and 2+4 ms.
LIVE_SPANS = []
for k, (launch, back) in enumerate([(3, 1), (1, 5), (2, 4)]):
    t0 = 0.02 * k
    LIVE_SPANS += [("rctpu.engine.apply_u8", t0, t0 + (launch + back) * 1e-3),
                   ("rctpu.engine.readback", t0 + launch * 1e-3, t0 + (launch + back) * 1e-3)]
LIVE_SPANS.append(("rctpu.engine.apply_u8", 0.08, 0.081))  # a call with no readback in it


def readings(workload, host, batches=4):
    cell = resolve(workload)
    win = loops.Window(t0=0.0, seconds=2.0, frames=batches * cell.batch, batches=batches, next_frame=0)
    return Readings(cell, win, 10.0, 2**30, {}, DeviceTrace(2.0, BUSY, host))


def read(r, name):
    return r.cell.reader(name).read(r)


def test_queue_readers_exact():
    r = readings(OFFLINE, QUEUE_SPANS + LIVE_SPANS)
    assert read(r, "queue.copy_out_ms_per_batch") == pytest.approx((0.25 + 0.10) / 4 * 1e3, rel=1e-12)
    assert read(r, "queue.wait_ms_per_batch") == pytest.approx((0.02 + 0.20) / 4 * 1e3, rel=1e-12)
    # Idle inside the queue's spans: 0.50-0.60, 1.10-1.50, 1.80-1.90.
    assert read(r, "device.idle_in_queue_pct.offline") == pytest.approx(0.6 / 2.0 * 100.0, rel=1e-12)


def test_idle_in_queue_counts_nested_spans_once():
    nested = [("rctpu.queue.readback", 1.10, 1.55), ("rctpu.queue.readback_wait", 1.10, 1.30),
              ("rctpu.queue.copy_out", 1.30, 1.55)]
    r = readings(OFFLINE, nested)
    assert read(r, "device.idle_in_queue_pct.offline") == pytest.approx(0.4 / 2.0 * 100.0, rel=1e-12)
    busy_only = readings(OFFLINE, [("rctpu.queue.stack", 0.1, 0.4)])
    assert read(busy_only, "device.idle_in_queue_pct.offline") == 0.0


def test_engine_readers_exact():
    r = readings(LIVE, LIVE_SPANS + QUEUE_SPANS, batches=3)
    assert read(r, "engine.launch_ms.live") == pytest.approx(2.0, rel=1e-9)  # of 3, 1, 2
    assert read(r, "engine.readback_ms.live") == pytest.approx(4.0, rel=1e-9)  # of 1, 5, 4


@pytest.mark.parametrize("name", QUEUE + ENGINE)
def test_nothing_without_the_programs_spans(name):
    parent = [("bench.queue", 0.0, 2.0), ("bench.process", 0.1, 0.4), ("bench.call", 0.5, 0.6)]
    workload = OFFLINE if name in QUEUE else LIVE
    assert read(readings(workload, parent), name) is None
    r = readings(workload, QUEUE_SPANS + LIVE_SPANS)
    r.trace = None
    assert read(r, name) is None


@pytest.mark.parametrize("name", QUEUE + ENGINE)
def test_nothing_in_the_other_loop(name):
    workload = LIVE if name in QUEUE else OFFLINE
    assert read(readings(workload, QUEUE_SPANS + LIVE_SPANS), name) is None


def test_wait_reads_either_wait():
    only_upload = readings(OFFLINE, [("rctpu.queue.upload_wait", 0.1, 0.3)])
    assert read(only_upload, "queue.wait_ms_per_batch") == pytest.approx(0.2 / 4 * 1e3, rel=1e-12)
