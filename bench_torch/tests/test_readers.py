"""Each metric's reader over a synthetic window and trace: what it reads,
and nothing where it finds nothing to read."""

import pytest

from harness import loops
from harness.cell import Readings
from harness.spec import load_benchmark, resolve
from harness.trace import DeviceTrace

TRACE = DeviceTrace(
    window_s=1.0,
    records=[
        ("void at::native::vectorized_elementwise_kernel<4, Mul>", 0.0, 0.2),
        ("(anonymous namespace)::blur_groups_kernel(float const*)", 0.1, 0.2),  # overlaps the one before
        ("(anonymous namespace)::xbr_epilogue_kernel(float const*)", 0.5, 0.1),
        ("Memcpy DtoH (Device -> Pinned)", 0.7, 0.1),
    ],
    host=[("bench.queue", 0.0, 1.0), ("bench.process", 0.35, 0.45)],
)


def readings(workload, trace=TRACE):
    cell = resolve(workload)
    closed = cell.traffic["loop"] == "closed"
    win = loops.Window(t0=0.0, seconds=1.0, frames=64 if closed else 60, batches=2 if closed else 60, next_frame=0)
    win.spans["process"] = [0.002, 0.004]
    win.spans["call"] = [0.003] * 60
    win.latency_s = [0.001 * (k + 1) for k in range(100)]
    return Readings(cell, win, 12.5, 2**30, {"capture_seconds": 6.5}, trace)


def test_trace_arithmetic():
    assert TRACE.busy_s() == pytest.approx(0.5)  # [0, 0.3] + [0.5, 0.6] + [0.7, 0.8]
    assert TRACE.kernel_s("blur_groups_kernel") == [0.2]
    assert TRACE.top_ops(2)[0][0].startswith("void at::native")
    gaps = TRACE.idle_gaps()
    assert [round(s, 6) for _, s in gaps] == [0.2, 0.2, 0.1]  # (0.3, 0.5), (0.8, 1.0), (0.6, 0.7)
    assert sorted(n for n, s in gaps[:2]) == ["bench.process", "bench.queue"]  # by the range open at the middle


EXPECT = {
    "crt-mattias-1080p.offline": {
        "frames_per_s": 64.0, "peak_mem_gib": 1.0, "setup_s": 12.5, "queue.host_ms_per_batch": 500.0 - 3.0,
        "engine.enqueue_ms_per_batch": 3.0, "replay.capture_s": 6.5, "device.idle_pct.offline": 50.0,
        "eager.device_ms_per_frame": 200.0 / 64,
        "kernel.blur_groups.roofline_pct": 0.44566925373134325 * 2 / 200.0 * 100.0,
    },
    "xbr-lv2-1080p.offline": {"kernel.xbr_epilogue.roofline_pct": 1.1356372358208955 * 2 / 100.0 * 100.0},
    "crt-mattias-1080p.live": {
        "latency_p50_ms": 50.5, "latency_p95_ms": 95.05, "device.busy_ms_per_frame.live": 500.0 / 60,
        "engine.exposed_host_ms.live": 3.0 - 500.0 / 60, "replay.capture_s": 6.5,
    },
}


@pytest.mark.parametrize("workload", [w["name"] for w in load_benchmark()["workloads"]])
def test_every_metric_of_a_cell_reads_a_number(workload):
    r = readings(workload)
    for m in r.cell.end_to_end + r.cell.per_layer:
        value = r.cell.reader(m["name"]).read(r)
        assert isinstance(value, float), m["name"]
        if m["name"] in EXPECT.get(workload, {}):
            assert value == pytest.approx(EXPECT[workload][m["name"]], rel=1e-9), m["name"]


def test_a_reader_with_nothing_to_read_returns_nothing():
    r = readings("crt-mattias-1080p.offline", trace=None)
    for name in ("device.idle_pct.offline", "eager.device_ms_per_frame", "kernel.blur_groups.roofline_pct",
                 "device.busy_ms_per_frame.live", "latency_p95_ms"):
        assert r.cell.reader(name).read(r) is None, name
    no_kernel = DeviceTrace(1.0, [("void at::native::k", 0.0, 0.1)])
    r = readings("xbr-lv2-1080p.offline", trace=no_kernel)
    assert r.cell.reader("kernel.xbr_epilogue.roofline_pct").read(r) is None


def test_a_roofline_does_not_move_with_the_launches_a_stage_takes():
    whole = readings("crt-mattias-1080p.offline")
    split = DeviceTrace(1.0, [("blur_groups_kernel", 0.1, 0.05), ("blur_groups_kernel", 0.2, 0.15)])
    halves = readings("crt-mattias-1080p.offline", trace=split)
    name = "kernel.blur_groups.roofline_pct"
    assert halves.cell.reader(name).read(halves) == pytest.approx(whole.cell.reader(name).read(whole), rel=1e-12)
