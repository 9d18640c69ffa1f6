"""A stateful configuration's reference, replayed from frame 0.

The repository's own PassFeedback preset (``assets/presets/feedback-ghost.glslp``,
GHOST 0.35) as a configuration of the tests alone, with no entry in
``BENCHMARK.json``: each frame is ``mix(cur, prev, GHOST)`` through the RGBA8
store, ``prev`` the pass's own stored output of the frame before, zero at
frame 0, so every answer depends on every frame before it. On the CPU at a
tiny size, through the benchmark's own run (``run_cell``): the exact replay
reads ``correct`` in both loops; a chain whose state is reset before each
apply, and the same answers judged frame by frame from a cold state, do
not. And for each configuration of ``BENCHMARK.json`` the comparison's
stateless branch gives the numbers of the per-frame loop it replaced."""

import json
import os
import shutil
from dataclasses import dataclass

import pytest
import torch

from harness import compare
from harness.cell import run_cell
from harness.frames import FrameSource
from harness.spec import BENCH, ROOT, Cell, load_benchmark, load_module, resolve

calibrate = load_module(BENCH / "calibrate.py")
PRESET = ROOT / "assets" / "presets"
CONFIG = {
    "name": "feedback-ghost-test",
    "source_hw": [60, 80],
    "viewport": [80, 60],  # the pass's own size: the blit is the plain u8 pack
    "batch": 4,
    "parameters": {"GHOST": 0.35},
    "param_mode": "const",
    "precision": "float32",
    "compare": {"frames": 4, "off_share": 0.005, "mean_abs": 0.1},
}
BASE = {"offline": "crt-mattias-1080p.offline", "live": "crt-mattias-1080p.live"}


class Preset:
    """The preset writer: the repository's feedback-ghost preset, as it is."""

    @staticmethod
    def write(directory) -> str:
        for name in ("feedback-ghost.glslp", "feedback-ghost.glsl"):
            shutil.copy(PRESET / name, directory)
        return os.path.join(directory, "feedback-ghost.glslp")


def _store(x, dtype):
    """The RGBA8 framebuffer's store: the nearest of the 256 levels, as a
    level times the rounded ``1 / 255``."""
    return torch.round(x.clamp(0.0, 1.0) * 255.0) * _inv255(dtype)


def _inv255(dtype) -> float:
    return float(torch.tensor(1.0 / 255.0, dtype=torch.float64).to(dtype))


def _ghost(x, prev, params, dtype):
    """One frame of the pass: ``mix(cur, prev, GHOST) = cur + (prev - cur)
    * GHOST``, the product contracted into the add (rounded once, as a GPU
    compiles it), then stored; the texel ``cur`` is its level times the
    rounded ``1 / 255``. Where the mix lands on a half level, as
    ``0.65 i + 0.35 j`` often does, the program's rounding may take the
    other level: a level off, a share of the values, and never more."""
    a = float(torch.tensor(float(params["GHOST"]), dtype=torch.float64).to(dtype))
    cur = x.to(dtype) * _inv255(dtype)
    return _store((cur.double() + (prev - cur).double() * a).to(dtype), dtype)


def _u8(stored):
    return torch.round(stored.float() * 255.0).to(torch.uint8)


class Replayed:
    """feedback-ghost's plain reference: every frame from 0, its
    PassFeedback zero at the first."""

    STATEFUL = True

    @staticmethod
    def render_sequence(frames, gs, params, out_hw, dtype=torch.float32):
        want, out, prev, g = set(gs), {}, None, 0
        for chunk in frames:
            for x in chunk:
                prev = _ghost(x, torch.zeros_like(x, dtype=dtype) if prev is None else prev, params, dtype)
                if g in want:
                    out[g] = _u8(prev)
                g += 1
        return out


class Cold:
    """The same pass judged frame by frame, each from a cold PassFeedback:
    what a stateless reference can say of a stateful chain."""

    @staticmethod
    def render(src, frame_count, params, out_hw, dtype=torch.float32):
        return _u8(_ghost(src, torch.zeros_like(src, dtype=dtype), params, dtype))


@dataclass
class GhostCell(Cell):
    ref: object = None

    def reference(self):
        return self.ref

    def preset_writer(self):
        return Preset


def ghost(loop, ref=Replayed):
    base = resolve(BASE[loop])
    name = f"{CONFIG['name']}.{loop}"
    return GhostCell(name, dict(base.workload, name=name, config=CONFIG["name"]), dict(CONFIG),
                     dict(base.traffic, sample_every=2), base.end_to_end, base.per_layer, ref=ref)


def reset_each_apply(process, e):
    """The chain's state thrown away before every apply."""
    def f(frames):
        e.reset_state()
        return process(frames)
    return f


def one_apply_more(process, e):
    """The first apply run twice: the engine sees frames the loops never
    handed it."""
    calls = []

    def f(frames):
        if not calls:
            calls.append(process(frames))
        return process(frames)
    return f


@pytest.mark.parametrize("loop", ["offline", "live"])
def test_an_exact_replay_is_correct(loop):
    out = run_cell(ghost(loop), 2**31 + 7, 1.0, False, device="cpu")
    assert out["correct"] is True, out["compared"]
    assert out["compared"]["off_share"]["value"] == 0.0, out["compared"]


@pytest.mark.parametrize("loop", ["offline", "live"])
def test_a_state_reset_each_apply_is_not_correct(loop):
    out = run_cell(ghost(loop), 22, 1.0, False, device="cpu", wrap=reset_each_apply)
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("loop", ["offline", "live"])
def test_a_stateless_reference_of_a_stateful_chain_is_not_correct(loop):
    out = run_cell(ghost(loop, Cold), 23, 1.0, False, device="cpu")
    assert out["correct"] is False, out["compared"]


def test_a_broken_sequence_raises():
    with pytest.raises(RuntimeError, match="unbroken sequence"):
        run_cell(ghost("offline"), 24, 0.5, False, device="cpu", wrap=one_apply_more)


def test_a_stateful_reference_is_fed_from_frame_0_in_chunks():
    seen = []

    class Recorder:
        STATEFUL = True

        @staticmethod
        def render_sequence(frames, gs, params, out_hw, dtype):
            g = 0
            for chunk in frames:
                seen.append((g, chunk.shape[0], chunk.device.type, chunk.dtype))
                assert torch.equal(chunk[0], torch.from_numpy(src.frame(g)))
                g += chunk.shape[0]
            return {g: torch.full((2, 2, 3), g % 251, dtype=torch.uint8) for g in gs}

    cell = ghost("offline", Recorder)
    src = FrameSource(cell.traffic, (6, 8), 5)
    got = list(compare.rendered(cell, src, [700, 3, 300], torch.float32, "cpu"))
    assert [g for g, _ in got] == [3, 300, 700]
    assert [int(x[0, 0, 0]) for _, x in got] == [3, 300 % 251, 700 % 251]
    assert seen == [(0, 256, "cpu", torch.uint8), (256, 256, "cpu", torch.uint8), (512, 189, "cpu", torch.uint8)]
    assert list(compare.rendered(cell, src, [], torch.float32, "cpu")) == []


def _per_frame_control(cell, seed, frames, device):
    """The control's numbers as the comparison computed them frame by
    frame before stateful references: each answer from ``src.frame(g)``."""
    src = FrameSource(cell.traffic, cell.src_hw, seed)
    ref = cell.reference()
    vw, vh = cell.viewport
    params = cell.config["parameters"]
    kept = {}
    for g in frames:
        x = torch.from_numpy(src.frame(g)).to(device)
        kept[g] = ref.render(x, g, params, (vh, vw), calibrate.LOWER[cell.config["precision"]]).cpu()
    off = mad = 0.0
    for g in sorted(kept):
        x = torch.from_numpy(src.frame(g)).to(device)
        want = ref.render(x, g, params, (vh, vw), torch.float32)
        o, m = compare.frame_numbers(torch.as_tensor(kept[g]).to(device), want)
        off, mad = max(off, o), max(mad, m)
    return {"frames": len(kept), "off_share": off, "mean_abs": mad}


@pytest.mark.parametrize("config", sorted({w["config"] for w in load_benchmark()["workloads"]}))
def test_the_stateless_branch_gives_the_per_frame_numbers(config):
    cell = resolve(f"{config}.offline", config=resolve(f"{config}.offline").config["rehearse"],
                   traffic={"sample_every": 2})
    assert not compare.is_stateful(cell.reference())
    seed = 2**31 + 17
    frames = calibrate.sampled_frames(cell, seed, 0, 8)
    assert frames
    assert calibrate.control_numbers(cell, seed, frames, "cpu") == _per_frame_control(cell, seed, frames, "cpu")


def test_the_ring_budgets_reference_is_motionblurs_blend():
    """``ring_budget.py``'s ring reference: each frame ``src/2 + P0/4 + ... +
    P5/128 + P6/128`` of its own stored outputs, the cold ring its first
    frame; against the sum in float64, a level at most where the pairwise
    float32 sums round a half level the other way."""
    ring = load_module(BENCH / "ring_budget.py")
    with open(BENCH / "traffic" / "offline.json") as f:
        src = FrameSource(json.load(f), (3, 4), 9)
    n, out_hw = 30, (6, 8)
    got = ring.Ring.render_sequence(iter([torch.from_numpy(src.frames(0, n))]), range(n), {}, out_hw)
    up = [ring._upscale(torch.from_numpy(src.frame(g)), out_hw, torch.float64)[..., :3] for g in range(n)]
    stored = []
    for g in range(n):
        prev = [stored[g - 1 - k] if g - 1 - k >= 0 else torch.round(up[0] * 255.0) / 255.0 for k in range(7)]
        w = [1 / 4, 1 / 8, 1 / 16, 1 / 32, 1 / 64, 1 / 128, 1 / 128]
        v = up[g] / 2 + sum(wk * p for wk, p in zip(w, prev))
        stored.append(torch.round(v * 255.0) / 255.0)
        d = (got[g].int() - torch.round(stored[g] * 255.0).int()).abs()
        assert int(d.max()) <= 1, g
        stored[g] = got[g].double() / 255.0  # carry the reference's own state on
