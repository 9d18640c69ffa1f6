"""Each metric's reader over a synthetic window and trace: what it reads,
and nothing where it finds nothing to read."""

import pytest

from harness import loops
from harness.cell import Readings
from harness.spec import load_benchmark, resolve
from harness.trace import DeviceTrace

# Every record lies inside the busy intervals of the first four, so that
# the arithmetic below holds; together they give each metric of each cell
# something to read: its kernels, the program's spans and its counters.
TRACE = DeviceTrace(
    window_s=1.0,
    records=[
        ("void at::native::vectorized_elementwise_kernel<4, Mul>", 0.0, 0.2),
        ("(anonymous namespace)::blur_groups_kernel(float const*)", 0.1, 0.2),  # overlaps the one before
        ("(anonymous namespace)::xbr_epilogue_kernel(float const*)", 0.5, 0.1),
        ("Memcpy DtoH (Device -> Pinned)", 0.7, 0.1),
        ("void nnedi3_kernel<64, 0>(float const*)", 0.2, 0.05),
        ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x64x8", 0.25, 0.04),
        ("(anonymous namespace)::xbr_front_kernel(float const*)", 0.52, 0.02),
        ("(anonymous namespace)::mattias_epilogue_kernel(float const*)", 0.55, 0.03),
        ("(anonymous namespace)::resample_u8_kernel(float const*)", 0.72, 0.02),
    ],
    host=[
        ("bench.queue", 0.0, 1.0), ("bench.process", 0.35, 0.8),
        ("rctpu.queue.upload_wait", 0.05, 0.07),
        ("rctpu.engine.apply_u8", 0.1, 0.3), ("rctpu.engine.readback", 0.25, 0.3),
        ("rctpu.queue.readback", 0.82, 0.88), ("rctpu.queue.readback_wait", 0.82, 0.84),
        ("rctpu.queue.copy_out", 0.84, 0.88), ("rctpu.queue.handout", 0.85, 0.87),
    ],
)
COUNTERS = {"capture_seconds": 6.5, "frames": 640, "fc_grouped_frames": 320, "nnedi3_passes": 2556,
            "nnedi3_declined": 4}


def readings(workload, trace=TRACE):
    cell = resolve(workload)
    closed = cell.traffic["loop"] == "closed"
    win = loops.Window(t0=0.0, seconds=1.0, frames=64 if closed else 60, batches=2 if closed else 60, next_frame=0)
    win.spans["process"] = [0.002, 0.004]
    win.spans["call"] = [0.003] * 60
    win.latency_s = [0.001 * (k + 1) for k in range(100)]
    return Readings(cell, win, 12.5, 2**30, dict(COUNTERS), trace)


def test_trace_arithmetic():
    assert TRACE.busy_s() == pytest.approx(0.5)  # [0, 0.3] + [0.5, 0.6] + [0.7, 0.8]
    assert TRACE.kernel_s("blur_groups_kernel") == [0.2]
    assert TRACE.top_ops(2)[0][0].startswith("void at::native")  # ties with blur_groups, named first
    gaps = TRACE.idle_gaps()
    assert [round(s, 6) for _, s in gaps] == [0.2, 0.2, 0.1]  # (0.3, 0.5), (0.8, 1.0), (0.6, 0.7)
    assert sorted(n for n, s in gaps[:2]) == ["bench.process", "bench.queue"]  # by the range open at the middle


QUEUE = {"queue.copy_out_ms_per_batch": 0.04 / 2 * 1e3, "queue.wait_ms_per_batch": (0.02 + 0.02) / 2 * 1e3,
         "device.idle_in_queue_pct.offline": 0.06 * 100.0, "queue.zero_copy_pct.offline": 100.0}
LIVE = {"engine.launch_ms.live": 150.0, "engine.readback_ms.live": 50.0}
EXPECT = {
    "crt-mattias-1080p.offline": {
        "frames_per_s": 64.0, "peak_mem_gib": 1.0, "setup_s": 12.5, "queue.host_ms_per_batch": 500.0 - 3.0,
        "engine.enqueue_ms_per_batch": 3.0, "replay.capture_s": 6.5, "device.idle_pct.offline": 50.0,
        "eager.device_ms_per_frame": (200.0 + 40.0) / 64,  # at::native and the gemm
        "kernel.blur_groups.roofline_pct": 0.44566925373134325 * 2 / 200.0 * 100.0,
        "kernel.mattias_epilogue.roofline_pct": 0.5676093134328358 * 2 / 30.0 * 100.0, **QUEUE,
    },
    "xbr-lv2-1080p.offline": {
        "kernel.xbr_epilogue.roofline_pct": 1.1356372358208955 * 2 / 100.0 * 100.0,
        "kernel.xbr_front.roofline_pct": 0.5194109229850746 * 2 / 20.0 * 100.0, **QUEUE,
    },
    "crt-mattias-1080p.live": {
        "latency_p50_ms": 50.5, "latency_p95_ms": 95.05, "device.busy_ms_per_frame.live": 500.0 / 60,
        "engine.exposed_host_ms.live": 3.0 - 500.0 / 60, "replay.capture_s": 6.5, **LIVE,
    },
    "ntsc-320px-1080p.offline": {
        "replay.fc_grouped_pct.offline": 50.0,
        "kernel.ntsc_band.roofline_pct": 0.21128023880597016 * 2 / 40.0 * 100.0,
        "kernel.resample_u8.roofline_pct": 0.5546249552238806 * 2 / 20.0 * 100.0,
    },
    "nnedi3-nns64-2x-nns32-4x-rgb-1080p.offline": {
        "replay.nnedi3_entry_pct.offline": 100.0 * 2556 / 2560,
        # Every kernel but the blit's and the copy: 200 + 200 + 100 + 50 + 40 + 20 + 30 ms.
        "kernel.nnedi3.roofline_pct": 4.0565805850746255 * 2 / 640.0 * 100.0,
        "kernel.resample_u8.roofline_pct": 0.10015235820895523 * 2 / 20.0 * 100.0,
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
