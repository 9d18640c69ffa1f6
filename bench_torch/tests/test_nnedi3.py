"""nnedi3-nns64-2x-nns32-4x-rgb-1080p: its preset writer's nets against the
program's parse, its plain reference against the program's entry and
chain, the lower-precision control, its work formula, the program's
counters and the readers of its two metrics. On the CPU, at small sizes."""

import types

import numpy as np
import pytest
import torch

from harness import loops, peaks, system
from harness.cell import Readings
from harness.compare import frame_numbers, verdict
from harness.frames import FrameSource
from harness.spec import load_module, resolve
from harness.trace import DeviceTrace

WORKLOAD = "nnedi3-nns64-2x-nns32-4x-rgb-1080p.offline"
CELL = resolve(WORKLOAD)
REF = CELL.reference()
WRITER = CELL.preset_writer()
TINY = resolve(WORKLOAD, config=CELL.config["rehearse"], traffic={"sample_every": 2})
SMALL = (24, 32)  # a source the writer's preset takes with its last pass at 4 x 24 rows
LIMITS = {k: v for k, v in CELL.config["compare"].items() if k != "frames"}


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


def small_engine(tmp_path, viewport):
    pkg = program()[0]
    e = pkg.Engine(viewport=viewport, device="cpu")
    assert e.load_preset(WRITER.write(str(tmp_path), height=4 * SMALL[0])), e.last_error
    return e


def test_writers_nets_are_the_programs(tmp_path):
    """Each shader's net as the program parses it from the text, bit for
    bit, at the published shapes; the pairs' nets differ."""
    _, kernels, _, _ = program()
    WRITER.write(str(tmp_path))
    nets = WRITER.weights()
    assert list(nets) == WRITER.PASSES
    for name, net in nets.items():
        nns = 64 if "-nns64-" in name else 32
        got = kernels._nnedi3_weights(str(tmp_path / name))
        assert got is not None, name
        for g, w, shape in zip(got, net, [(32, nns), (32, nns), (nns,), (nns,)]):
            assert g.shape == w.shape == shape and g.dtype == w.dtype == np.float32
            assert np.array_equal(g.view(np.int32), w.view(np.int32)), name
        assert np.abs(net[0].astype(np.float64).sum(axis=0)).max() < 1e-5  # centred
    assert not np.array_equal(nets[WRITER.PASSES[0]][0], nets[WRITER.PASSES[1]][0])


def ctx_of(p, i, tex, out_hw):
    """What a kernel entry reads of its pass context."""
    oh, ow = out_hw
    return types.SimpleNamespace(program=types.SimpleNamespace(preset=p), i=i, out_size=(ow, oh),
                                 input_binding=types.SimpleNamespace(tex=tex))


# One pass before its store: the program accumulates its sums in f64 and
# rounds once, the reference sums in f32 in torch's order, and their exps
# and square roots differ by an ulp; through the softsign mix and ``5 std``
# that is a few units in the last place of values in [0, 1].
PASS_ATOL = 1e-5


@pytest.mark.parametrize("i", range(4))
def test_one_pass_matches_the_programs_entry(tmp_path, i):
    """Each of the four passes on the same input: the reference's
    ``double`` against the program's entry for that pass."""
    _, kernels, _, Preset = program()
    p = Preset.load(WRITER.write(str(tmp_path), height=4 * SMALL[0]))
    rng = np.random.default_rng(40 + i)
    h, w = SMALL
    levels = torch.from_numpy(rng.integers(0, 256, (h, w, 3)).astype(np.float32))
    tex = levels / 255.0
    axis = 0 if "-pass1-" in WRITER.PASSES[i] else 1
    out_hw = (2 * h, w) if axis == 0 else (h, 2 * w)
    entry = kernels.find_kernel(WRITER.PASSES[i])
    got = entry(ctx_of(p, i, torch.cat([tex, torch.ones((h, w, 1))], dim=-1), out_hw), None)
    assert got is not None and got.shape == out_hw + (4,)
    want = REF.double(tex, axis, REF.passes("cpu", torch.float32)[i][1])
    torch.testing.assert_close(got[..., :3], want, rtol=0, atol=PASS_ATOL)
    even = want[0::2] if axis == 0 else want[:, 0::2]
    assert torch.equal(even, tex)  # the source's rows or columns pass through
    pred = want[1::2] if axis == 0 else want[:, 1::2]
    assert (pred - tex).abs().max() > 0.05  # the net's, not a copy


def test_chain_within_the_limits(tmp_path):
    """The program's whole chain (the engine, batch 2, u8 out) against the
    reference, frame by frame, and the counters of its entry."""
    viewport = (160, 120)
    e = small_engine(tmp_path, viewport)
    src = FrameSource(TINY.traffic, SMALL, 2**31 + 7)
    for b in range(2):
        out = e.apply(torch.from_numpy(src.frames(2 * b, 2)), output="u8")
        for k in range(2):
            want = REF.render(torch.from_numpy(src.frame(2 * b + k)), 2 * b + k, {}, viewport[::-1])
            ok, rows = verdict(dict(zip(("off_share", "mean_abs"), frame_numbers(out[k], want))), LIMITS)
            assert ok, (2 * b + k, rows)
    stats = e.replay_stats()
    assert stats["nnedi3_passes"] == 4 * 4 and stats["nnedi3_declined"] == 0


def test_lower_precision_is_not_correct():
    """The reference in bfloat16 in the program's place, against the
    float32 reference: at least one limit fails on every frame."""
    src = FrameSource(TINY.traffic, SMALL, 2**31 + 11)
    for g in range(3):
        x = torch.from_numpy(src.frame(g))
        low = REF.render(x, g, {}, (120, 160), torch.bfloat16)
        want = REF.render(x, g, {}, (120, 160), torch.float32)
        ok, rows = verdict(dict(zip(("off_share", "mean_abs"), frame_numbers(low, want))), LIMITS)
        assert not ok, rows


def test_work_at_the_cells_shapes():
    sizes = CELL.work("passes").sizes(CELL.config, CELL.src_hw, CELL.viewport)
    assert sizes == [(480, 320), (480, 640), (960, 640), (960, 1280)]
    net = CELL.work("nnedi3")
    stages = net.stages(CELL.config, CELL.src_hw, sizes)
    assert [s[0] for s in stages] == [64, 64, 32, 32]
    moved, ops = net.work(1, stages)
    assert ops == 16_986_931_200 and moved == 13_824_000
    ms, by = peaks.bound(*net.work(16, stages))
    assert by == "operations" and ms == pytest.approx(16 * 16_986_931_200 / 67e9, rel=1e-12)


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
    for entry, got in zip(cell.config["passes"], p.passes):
        assert got.shader_path.endswith(entry["shader"])
        for key in ("filter_linear", "wrap_mode", "scale_type_x", "scale_x", "scale_type_y", "scale_y"):
            assert getattr(got, key) == entry[key], key


def test_values_counter_is_the_formulas():
    """A run through the frame queue at the rehearsal size: every pass
    through the entry, and ``nnedi3_values`` the work formula's predicted
    values (3 a texel of each pass's input) times the frames."""
    e = system.engine(TINY, "cpu")
    src = FrameSource(TINY.traffic, TINY.src_hw, 2**31 + 5)
    win = loops.closed(lambda frames, proc, batch: system.stream(frames, proc, batch, "cpu"),
                       lambda b: e.apply(b, output="u8"), src, TINY.batch, 0.3, 0, 1, loops.Hooks())
    stats = e.replay_stats()
    frames = stats["frames"]
    assert win.batches >= 1 and frames >= win.frames
    sizes = TINY.work("passes").sizes(TINY.config, TINY.src_hw, TINY.viewport)
    stages = TINY.work("nnedi3").stages(TINY.config, TINY.src_hw, sizes)
    assert stats["nnedi3_values"] == frames * sum(3 * h * w for _, (h, w), _ in stages)
    assert stats["nnedi3_passes"] == 4 * frames and stats["nnedi3_declined"] == 0
    assert read("replay.nnedi3_entry_pct.offline", readings(counters=stats)) == 100.0


NNEDI3_TRACE = DeviceTrace(
    window_s=1.0,
    records=[
        ("void at::native::vectorized_elementwise_kernel<4, Mul>", 0.0, 0.2),
        ("void gemm_f64_kernel<double>(double const*)", 0.2, 0.1),
        ("rctpu mirror_kernel(float const*)", 0.3, 0.05),
        ("void (anonymous namespace)::resample_u8_kernel<true, true, 3>(float const*)", 0.4, 0.04),
        ("Memcpy DtoH (Device -> Pinned)", 0.5, 0.3),
        ("Memset (Device)", 0.8, 0.01),
    ],
)


def readings(trace=NNEDI3_TRACE, counters=None):
    win = loops.Window(t0=0.0, seconds=1.0, frames=32, batches=2, next_frame=0)
    return Readings(CELL, win, 20.0, 2**30, counters if counters is not None else {}, trace)


def read(name, r):
    return CELL.reader(name).read(r)


def test_readers_exact():
    bound = 16 * 16_986_931_200 / 67e9  # ms an apply of 16 frames, bound by operations
    got = read("kernel.nnedi3.roofline_pct", readings())
    assert got == pytest.approx(bound * 2 / (0.35 * 1e3) * 100.0, rel=1e-12)
    split = DeviceTrace(1.0, [("void at::native::k", 0.0, 0.1), ("void at::native::k", 0.2, 0.25)])
    assert read("kernel.nnedi3.roofline_pct", readings(trace=split)) == pytest.approx(got, rel=1e-12)
    counters = {"nnedi3_passes": 4 * 4096, "nnedi3_declined": 0, "frames": 4096}
    assert read("replay.nnedi3_entry_pct.offline", readings(counters=counters)) == 100.0
    counters = {"nnedi3_passes": 3 * 4096, "nnedi3_declined": 4096}
    assert read("replay.nnedi3_entry_pct.offline", readings(counters=counters)) == 75.0


def test_readers_with_nothing_to_read():
    name = "kernel.nnedi3.roofline_pct"
    assert read(name, readings(trace=None)) is None
    only = DeviceTrace(1.0, [("resample_u8_kernel", 0.0, 0.1), ("Memcpy HtoD (Pinned -> Device)", 0.1, 0.1)])
    assert read(name, readings(trace=only)) is None
    # A chain with no nnedi3 pass: the ntsc cell's.
    ntsc = resolve("ntsc-320px-1080p.offline")
    win = loops.Window(t0=0.0, seconds=1.0, frames=256, batches=2, next_frame=0)
    assert ntsc.reader(name).read(Readings(ntsc, win, 1.0, 0, {}, NNEDI3_TRACE)) is None
    # The parent's counters: none of the entry's.
    assert read("replay.nnedi3_entry_pct.offline", readings(counters={"capture_seconds": 2.0})) is None
    assert read("replay.nnedi3_entry_pct.offline", readings(counters={"nnedi3_passes": 0, "nnedi3_declined": 0})) \
        is None


def test_rehearsal():
    rehearse = load_module(CELL.bench / "rehearse.py")
    out = rehearse.rehearse(WORKLOAD, 1.5, seed=2**31 + 17)
    assert out["correct"] is True and out["attempted"] > 0, out
