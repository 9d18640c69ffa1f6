"""ntsc-320px-1080p: its plain reference against the program's kernel
entries and chain, the faults its comparison must see, its work formulas
and the readers of its three metrics. On the CPU, at the configuration's
``rehearse`` size."""

import types

import numpy as np
import pytest
import torch

from harness import loops, peaks, system
from harness.cell import Readings, run_cell
from harness.compare import frame_numbers, verdict
from harness.frames import FrameSource
from harness.spec import BENCH, load_module, resolve
from harness.trace import DeviceTrace

WORKLOAD = "ntsc-320px-1080p.offline"
CELL = resolve(WORKLOAD)
REF = CELL.reference()
TINY = resolve(WORKLOAD, config=CELL.config["rehearse"], traffic={"sample_every": 2})


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def program():
    pkg = system.program()
    from retrocapture_tpu_torch.graph import kernels
    from retrocapture_tpu_torch.graph.scale import compute_chain_shapes
    from retrocapture_tpu_torch.presets.glslp import Preset

    return pkg, kernels, compute_chain_shapes, Preset


def preset(tmp_path):
    return program()[3].load(TINY.preset_writer().write(str(tmp_path)))


def ctx_of(p, i, tex, out_hw, frame_count=None):
    """What a kernel entry reads of its pass context."""
    oh, ow = out_hw
    return types.SimpleNamespace(program=types.SimpleNamespace(preset=p), i=i, out_size=(ow, oh),
                                 input_binding=types.SimpleNamespace(tex=tex), frame_count=frame_count)


# Pass 0: the program's phase rows use llvmpipe's sine and cosine
# polynomials and its YIQ dots round in another order; the encode is a
# few products of values of magnitude <= 2, so they agree to a few units
# in the last place.
ENCODE_ATOL = 2e-6
# Pass 1: the program sums the 65 taps as a GEMM, the reference in the
# fragment's order of pairs; the weights' absolute sums are 1.33 (luma)
# and 1.0 (chroma), the inputs of magnitude <= ~2.2, then yiq2rgb and pow
# 1.25: a few units in the last place of values <= ~2.
DECODE_ATOL = 2e-6


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("device_fc", [False, True], ids=["host-fc", "device-fc"])
def test_encode_matches_the_programs_pass(tmp_path, parity, device_fc):
    _, kernels, _, _ = program()
    p = preset(tmp_path)
    src = FrameSource(TINY.traffic, TINY.src_hw, 5 + parity).frame(parity)
    h, w = TINY.src_hw
    width = REF.WIDTH
    tex = torch.cat([torch.from_numpy(src).float() * (1.0 / 255.0), torch.ones((h, w, 1))], dim=-1)
    fc = torch.tensor(parity, dtype=torch.int32) if device_fc else np.int32(parity)
    got = kernels._ntsc_pass1_composite_2phase(ctx_of(p, 0, tex, (h, width), fc),
                                               types.SimpleNamespace(in_h=h, in_w=w))
    want = REF.encode(torch.from_numpy(src), parity)
    assert got.shape == (h, width, 4)
    torch.testing.assert_close(got[..., :3], want, rtol=0, atol=ENCODE_ATOL)
    other = REF.encode(torch.from_numpy(src), parity + 1)
    assert (got[..., :3] - other).abs().max() > 0.1  # the parity shows


@pytest.mark.parametrize("parity", [0, 1])
def test_decode_matches_the_programs_pass(tmp_path, parity):
    """Pass 1 on the reference's pass 0, with the rows expanded to the
    viewport's: the same NaNs (where the FIR rang below 0), the rest within
    ``DECODE_ATOL``."""
    _, kernels, _, _ = program()
    p = preset(tmp_path)
    h = TINY.src_hw[0]
    vh = TINY.viewport[1]
    signal = REF.encode(torch.from_numpy(FrameSource(TINY.traffic, TINY.src_hw, 9).frame(parity)), parity)
    tex = torch.cat([signal, torch.ones(signal.shape[:2] + (1,))], dim=-1)
    ow = signal.shape[1] // 2
    got = kernels._ntsc_pass2_2phase_gamma(ctx_of(p, 1, tex, (vh, ow)),
                                           types.SimpleNamespace(in_h=h, in_w=signal.shape[1]))[..., :3]
    want = REF.decode(signal)[REF.rows(ow, vh, h, "cpu")]
    assert got.shape == want.shape == (vh, ow, 3)
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and torch.isnan(want).any()
    torch.testing.assert_close(torch.nan_to_num(got), torch.nan_to_num(want), rtol=0, atol=DECODE_ATOL)


@pytest.mark.parametrize("out_w, out_h, h, naive_differs", [(640, 1080, 240, True), (640, 216, 48, False)])
def test_rows_are_the_rasterizers(out_w, out_h, h, naive_differs):
    """The reference's row map is the program's (its GL plane set-up); at a
    4.5 ratio it takes the naive centre formula's rows but on tie rows,
    where at 1080 rows it takes others."""
    _, kernels, _, _ = program()
    got = REF.rows(out_w, out_h, h, "cpu").numpy()
    np.testing.assert_array_equal(got, kernels._ntsc_row_index(out_w, out_h, h))
    naive = np.floor((np.arange(out_h) + 0.5) * h / out_h).astype(np.int64)
    ties = np.flatnonzero(((np.arange(out_h) + 0.5) * h) % out_h == 0)
    assert len(ties) == out_h // 9 and np.array_equal(got[np.setdiff1d(np.arange(out_h), ties)],
                                                      naive[np.setdiff1d(np.arange(out_h), ties)])
    assert bool((got[ties] != naive[ties]).any()) is naive_differs


def test_chain_within_the_limits(tmp_path):
    """The program's whole chain (the engine, batch 4 grouped, u8 out)
    against the reference, frame by frame, at both parities."""
    pkg = program()[0]
    e = pkg.Engine(viewport=TINY.viewport, device="cpu")
    assert e.load_preset(TINY.preset_writer().write(str(tmp_path))), e.last_error
    src = FrameSource(TINY.traffic, TINY.src_hw, 2**31 + 3)
    vw, vh = TINY.viewport
    limits = {k: v for k, v in CELL.config["compare"].items() if k != "frames"}
    for b in range(2):
        out = e.apply(torch.from_numpy(src.frames(4 * b, 4)), output="u8")
        for k in range(4):
            g = 4 * b + k
            want = REF.render(torch.from_numpy(src.frame(g)), g, {}, (vh, vw))
            off, mad = frame_numbers(out[k], want)
            ok, rows = verdict({"off_share": off, "mean_abs": mad}, limits)
            assert ok, (g, rows)
    assert e.replay_stats()["fc_grouped_frames"] == e.replay_stats()["frames"] == 8


def parity_flipped(process, e):
    """Every apply run with the engine's host FrameCount one ahead: each
    frame's chroma phase takes the other parity."""
    def f(frames):
        keys = list(e._fc_hosts)  # the first apply makes the key: it runs unshifted
        for k in keys:
            e._fc_hosts[k] += 1
        try:
            return process(frames)
        finally:
            for k in keys:
                e._fc_hosts[k] -= 1
    return f


def test_parity_flip_is_not_correct():
    out = run_cell(resolve(WORKLOAD, config=dict(CELL.config["rehearse"], compare=dict(CELL.config["compare"],
                                                                                        frames=4)),
                           traffic={"sample_every": 2}), 23, 1.0, False, device="cpu", wrap=parity_flipped)
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("kernel, batch, src_hw, out_hw, nbytes, flops, bound_ms, by", [
    ("ntsc_band", 128, (240, 1280), (240, 640), 707.8e6, 7.67e9, 0.2113, "bytes"),
    ("resample_u8", 128, (1080, 640), (1080, 1920), None, None, 0.5547, "bytes"),
    ("resample_u8", 128, (1080, 1920), (1080, 1920), None, None, 1.188, "bytes"),
])
def test_work_at_the_table_shapes(kernel, batch, src_hw, out_hw, nbytes, flops, bound_ms, by):
    moved, ops = load_module(BENCH / "work" / f"{kernel}.py").work(batch, src_hw, out_hw)
    if nbytes is not None:
        assert moved == pytest.approx(nbytes, rel=1e-3) and ops == pytest.approx(flops, rel=1e-3)
    ms, got_by = peaks.bound(moved, ops)
    assert got_by == by and ms == pytest.approx(bound_ms, abs=0.0006)


@pytest.mark.parametrize("size", ["full", "rehearse"])
def test_pass_sizes_are_the_programs(tmp_path, size):
    """The readers' pass sizes (``work/passes.py``) are the program's
    ``compute_chain_shapes`` of the preset the benchmark writes, and the
    configuration's ``passes`` are that preset's."""
    _, _, shapes_of, Preset = program()
    cell = CELL if size == "full" else TINY
    p = Preset.load(cell.preset_writer().write(str(tmp_path)))
    (h, w), (vw, vh) = cell.src_hw, cell.viewport
    want = [(s.out_h, s.out_w) for s in shapes_of(p, w, h, vw, vh)]
    assert cell.work("passes").sizes(cell.config, cell.src_hw, cell.viewport) == want
    if size == "full":
        assert want == [(240, 1280), (1080, 640)]
    for entry, got in zip(cell.config["passes"], p.passes):
        assert got.shader_path.endswith(entry["shader"])
        for key in ("filter_linear", "wrap_mode", "scale_type_x", "scale_x", "scale_type_y", "scale_y"):
            assert getattr(got, key) == entry[key], key
        assert got.frame_count_mod == entry.get("frame_count_mod", 0)
        assert got.float_framebuffer == entry.get("float_framebuffer", False)


GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x64x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas"
TRACE = DeviceTrace(
    window_s=1.0,
    records=[
        (GEMM, 0.0, 0.03),
        ("void splitKreduce_kernel<32, 16, int, float, float, float, float, true, false, false>", 0.03, 0.01),
        ("ntsc_fir_kernel(float const*)", 0.05, 0.02),
        ("void (anonymous namespace)::resample_u8_kernel<false, true, 3>(float const*)", 0.1, 0.04),
        ("void at::native::vectorized_elementwise_kernel<4, Mul>", 0.2, 0.3),
    ],
)


def readings(trace=TRACE, counters=None):
    win = loops.Window(t0=0.0, seconds=1.0, frames=256, batches=2, next_frame=0)
    win.spans["process"] = [0.002, 0.004]
    return Readings(CELL, win, 12.5, 2**30, counters if counters is not None else {}, trace)


def read(name, r):
    return CELL.reader(name).read(r)


def test_readers_exact():
    band = peaks.bound(*CELL.work("ntsc_band").work(128, (240, 1280), (240, 640)))[0]
    blit = peaks.bound(*CELL.work("resample_u8").work(128, (1080, 640), (1080, 1920)))[0]
    assert read("kernel.ntsc_band.roofline_pct", readings()) == pytest.approx(band * 2 / 60.0 * 100, rel=1e-12)
    assert read("kernel.resample_u8.roofline_pct", readings()) == pytest.approx(blit * 2 / 40.0 * 100, rel=1e-12)
    r = readings(counters={"frames": 4096, "fc_grouped_frames": 3072, "capture_seconds": 1.0})
    assert read("replay.fc_grouped_pct.offline", r) == 75.0


def test_readers_with_nothing_to_read():
    for name in ("kernel.ntsc_band.roofline_pct", "kernel.resample_u8.roofline_pct"):
        assert read(name, readings(trace=None)) is None
        assert read(name, readings(trace=DeviceTrace(1.0, [("void at::native::k", 0.0, 0.1)]))) is None
    # The parent's counters: no frame counts.
    assert read("replay.fc_grouped_pct.offline", readings(counters={"capture_seconds": 2.0})) is None
    assert read("replay.fc_grouped_pct.offline", readings(counters={"frames": 0, "fc_grouped_frames": 0})) is None


def test_the_cell_takes_the_grouped_branch():
    """Every frame of a run through the frame queue takes the fc-period
    grouped branch, as the cell's metric reads it."""
    e = system.engine(TINY, "cpu")
    src = FrameSource(TINY.traffic, TINY.src_hw, 31)
    win = loops.closed(lambda frames, proc, batch: system.stream(frames, proc, batch, "cpu"),
                       lambda b: e.apply(b, output="u8"), src, TINY.batch, 0.5, 0, 1, loops.Hooks())
    r = readings(counters=e.replay_stats())
    assert win.batches >= 1 and e.replay_stats()["frames"] >= win.frames
    assert read("replay.fc_grouped_pct.offline", r) == 100.0
