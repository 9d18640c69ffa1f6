"""The slice as a whole: retrocapture_tpu_torch.Engine (on the CPU)
against retrocapture_tpu.Engine (JAX on the CPU), same presets, same
parameters, same input frames (numpy, from a seed).

Tolerance. Expected bit-equal; accepted: u8 outputs differ by at most
1 step in at most 0.1% of values, f32 outputs by at most 1e-6 except
where an in-chain RGBA8 store flipped one code (then by at most
1/255 + 1e-6, in at most 0.1% of values). Reason: the port mirrors what
XLA-CPU does to the reference's f32 arithmetic where the compiled HLO
shows it (it contracts ``a*b + c`` into FMAs inside its fusions: the
evaluator's ``+``/``-``, ``mix``, the LINEAR tap sums; it folds scalar
constants into the u8 scale of a re-quantised tap), but not the
accumulation order of its dot products, so a value within an ulp of a
u8 rounding boundary can still round the other way. Measured on this
suite (CPU): feedback-ghost bit-equal (u8 and f32, batches 1, 4 and 8;
held bit-equal at batches 1 and 8 below); the warped pass bit-equal (u8
and f32); the history shader u8 max 1 step in <= 1.04e-4 of values. With
weights 0.5 / 0.3 / 0.2 the history shader differs in at most 4.34e-5 of
u8 values (the ring's seed entry, a LINEAR resize through XLA's dot),
held to the 10x gate of ROADMAP queue 3 below.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import retrocapture_tpu as jax_pkg
import retrocapture_tpu_torch as torch_pkg
from _presets import VERTEX_GLSL as VERTEX
from _presets import WARP_GLSL, WARP_GLSLP
from retrocapture_tpu_torch.runtime.engine import chain_state_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEEDBACK = os.path.join(REPO, "assets", "presets", "feedback-ghost.glslp")
SRC_HW = (48, 64)
VIEWPORT = (160, 120)

# Weighted sums of u8-grid texels land exactly on .5 code boundaries
# whenever the weights are short decimals, where the rounding of every
# product and sum decides the code (test_history_tie_weights_fault_is_
# bounded). Three-digit weights make exact ties rare, so this test
# measures the history ring rather than the tie rule.
HISTORY_GLSL = VERTEX + """
varying vec2 vTexCoord;
uniform sampler2D Texture;
uniform sampler2D PrevTexture;
uniform sampler2D Prev1Texture;

void main()
{
    vec4 c = texture2D(Texture, vTexCoord);
    vec4 p = texture2D(PrevTexture, vTexCoord);
    vec4 p1 = texture2D(Prev1Texture, vTexCoord);
    gl_FragColor = 0.437 * c + 0.331 * p + 0.232 * p1;
}

#endif
"""

BROKEN_GLSL = VERTEX + """
varying vec2 vTexCoord;
uniform sampler2D Texture;

void main()
{
    gl_FragColor = not_a_function(Texture, vTexCoord);
}

#endif
"""


def _engines(path, fmt="rgb", viewport=VIEWPORT):
    je = jax_pkg.Engine(viewport=viewport)
    te = torch_pkg.Engine(viewport=viewport, device="cpu")
    for e in (je, te):
        assert e.load_preset(path), e.last_error
        e.set_input_format(fmt)
    return je, te


def _apply(je, te, frames, output):
    a = np.asarray(je.apply(frames, output=output))
    b = te.apply(torch.from_numpy(frames), output=output)
    assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
    return a, b.numpy()


def _close(a, b, output):
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    if output == "u8":
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1, f"max {d.max()} u8 steps"
        assert (d != 0).mean() <= 1e-3, f"{(d != 0).mean():.2e} of values differ"
    else:
        assert np.isfinite(b).all()
        d = np.abs(a.astype(np.float64) - b)
        assert d.max() <= 1.0 / 255.0 + 1e-6, f"max |d| {d.max():.3e}"
        assert (d > 1e-6).mean() <= 1e-3, f"{(d > 1e-6).mean():.2e} of values beyond 1e-6"


def _nv12(seed, b):
    h, w = SRC_HW
    return np.random.default_rng(seed).integers(0, 256, (b, h * 3 // 2, w), dtype=np.uint8)


def _rgb(seed, b):
    h, w = SRC_HW
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("output", ["u8", "f32"])
@pytest.mark.parametrize("batch", [1, 4, 8])
def test_feedback_ghost_nv12_matches_jax(batch, output):
    je, te = _engines(FEEDBACK, "nv12")
    for i in range(3):  # the feedback ping-pong carries across applies
        a, b = _apply(je, te, _nv12(100 + i, batch), output)
        assert b.shape == (batch, VIEWPORT[1], VIEWPORT[0], 3)
        _close(a, b, output)
    assert te.shader_active and te.last_error is None
    key = SRC_HW + VIEWPORT
    assert int(te._states[key].frame_count) == 3 * batch == int(np.asarray(je._states[key].frame_count))


def test_set_parameter_and_state_handover_match_jax():
    je, te = _engines(FEEDBACK, "nv12")
    for e in (je, te):
        assert e.set_parameter("GHOST", 0.6)
        assert e.get_parameter("GHOST") == pytest.approx(0.6)
    for i in range(2):
        a, b = _apply(je, te, _nv12(200 + i, 2), "u8")
        _close(a, b, "u8")
    # The JAX engine's checkpoint continues in a fresh port engine.
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "state.npz")
        je.save_state(path)
        te2 = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
        assert te2.load_preset(FEEDBACK)
        te2.set_input_format("nv12")
        te2.set_parameter("GHOST", 0.6)
        te2.load_state(path)
    key = SRC_HW + VIEWPORT
    js_state = je._states[key]
    ts_state = te2._states[key]
    assert np.array_equal(np.asarray(js_state.feedback[0]), ts_state.feedback[0].numpy())
    assert int(ts_state.frame_count) == 4 and ts_state.frame_count.dtype == torch.int32
    # chain_state_from_numpy builds the same state from the arrays.
    direct = chain_state_from_numpy(
        [np.asarray(h) for h in js_state.history],
        {j: np.asarray(t) for j, t in js_state.feedback.items()},
        np.asarray(js_state.frame_count),
        np.asarray(js_state.time),
        "cpu",
    )
    assert torch.equal(direct.feedback[0], ts_state.feedback[0])
    assert torch.equal(direct.time, ts_state.time)
    frames = _nv12(300, 2)
    a, b = _apply(je, te2, frames, "u8")
    _close(a, b, "u8")
    # And the port's own checkpoint round-trips.
    with tempfile.TemporaryDirectory() as td:
        te2.save_state(os.path.join(td, "port"))
        te3 = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
        assert te3.load_preset(FEEDBACK)
        te3.set_input_format("nv12")
        te3.set_parameter("GHOST", 0.6)
        te3.load_state(os.path.join(td, "port"))
    assert torch.equal(te3._states[key].feedback[0], te2._states[key].feedback[0])


@pytest.mark.parametrize("output", ["u8", "f32"])
def test_warped_pass_matches_jax(output):
    with tempfile.TemporaryDirectory() as td:
        with open(os.path.join(td, "warp-curve.glslp"), "w") as f:
            f.write(WARP_GLSLP)
        with open(os.path.join(td, "warp-curve.glsl"), "w") as f:
            f.write(WARP_GLSL)
        je, te = _engines(os.path.join(td, "warp-curve.glslp"))
        a, b = _apply(je, te, _rgb(400, 2), output)
    assert te.shader_active and te.last_error is None
    _close(a, b, output)
    # Corners fall outside the curved texture: clamp_to_border is black.
    assert (b[:, 0, 0] == 0).all() and (b[:, -1, -1] == 0).all()


def test_history_ring_matches_jax():
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "history.glsl")
        with open(path, "w") as f:
            f.write(HISTORY_GLSL)
        je, te = _engines(path)
        for i in range(3):
            a, b = _apply(je, te, _rgb(500 + i, 2), "u8")
            _close(a, b, "u8")
    key = SRC_HW + VIEWPORT
    assert len(te._states[key].history) == 7
    for hj, ht in zip(je._states[key].history, te._states[key].history):
        d = np.abs(np.asarray(hj) - ht.numpy())
        assert d.max() <= 1.0 / 255.0 + 1e-6 and (d > 1e-6).mean() <= 1e-3


def test_history_tie_weights_fault_is_bounded():
    """ROADMAP queue 3's fault and its gate: with short-decimal weights
    ``0.5*c + 0.3*p + 0.2*p1`` over u8-grid texels, sums land exactly on
    .5 code boundaries, where every rounding decides the code. The
    reference's compiled HLO folds ``0.5 * f32(1/255)`` into the
    re-quantised NEAREST tap of ``c`` (its saturating u8 convert keeps
    that product out of any FMA) and LLVM contracts ``0.3*p`` and
    ``0.2*p1`` into the adds, as well as the LINEAR history taps' sums;
    the port mirrors all three. Before: 1.07e-2, 7.20e-3 and 7.38e-3 of
    u8 values differed (3 applies of 2 frames); now 4.34e-5, 3.47e-5 and
    8.68e-6, all in the ring's seed entry (the first frame resized through
    XLA's dot, whose accumulation order the port does not mirror). The
    gate is 10x fewer than before: <= 1.07e-3 per apply."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "history-tie.glsl")
        with open(path, "w") as f:
            f.write(HISTORY_GLSL.replace("0.437 * c + 0.331 * p + 0.232 * p1", "0.5 * c + 0.3 * p + 0.2 * p1"))
        je, te = _engines(path)
        for i in range(3):
            a, b = _apply(je, te, _rgb(500 + i, 2), "u8")
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1, f"max {d.max()} u8 steps"
            assert (d != 0).mean() <= 1.07e-3, f"{(d != 0).mean():.2e} of values differ"


@pytest.mark.parametrize("output", ["u8", "f32"])
@pytest.mark.parametrize("batch", [1, 8])
def test_feedback_ghost_nv12_bit_equal_to_jax(batch, output):
    """With ``mix`` and the PassFeedback LINEAR taps contracted as the
    reference's fusion contracts them, feedback-ghost-nv12 is bit-equal
    to the JAX engine (before: up to 3.47e-5 of u8 values at batch 1 and
    1.24e-4 at batch 8 differed)."""
    je, te = _engines(FEEDBACK, "nv12")
    for i in range(3):
        a, b = _apply(je, te, _nv12(100 + i, batch), output)
        assert np.array_equal(a, b), f"apply {i}: {(a != b).mean():.2e} of values differ"


def test_engine_defaults_to_the_card(monkeypatch):
    """``Engine()`` targets CUDA; without a card it raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_pkg.Engine(viewport=VIEWPORT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert torch_pkg.Engine(viewport=VIEWPORT).device == torch.device("cuda", 0)
    assert torch_pkg.Engine(viewport=VIEWPORT, device="cpu").device == torch.device("cpu")


def test_broken_shader_degrades_to_passthrough_alike():
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "broken.glsl")
        with open(path, "w") as f:
            f.write(BROKEN_GLSL)
        je, te = _engines(path)
        a, b = _apply(je, te, _rgb(600, 2), "u8")
    for e in (je, te):
        assert e.shader_active is False
        assert e.last_error is not None and "not_a_function" in e.last_error
    _close(a, b, "u8")


def test_engine_checks_its_arguments():
    te = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
    assert te.load_preset(FEEDBACK)
    with pytest.raises(ValueError):
        te.apply(_rgb(1, 1), output="bogus")
    # Frames on another device are refused, never moved or computed
    # elsewhere.
    with pytest.raises(ValueError):
        te.apply(torch.empty((1, 48, 64, 3), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError):
        te.set_input_format("rgb565")


# -- apply_streams, apply_u8, concrete FrameCount ---------------------------

HISTORY_FEEDBACK_FC_GLSL = VERTEX + """
varying vec2 vTexCoord;
uniform sampler2D Texture;
uniform sampler2D PrevTexture;
uniform int FrameCount;
uniform float Time;

void main()
{
    vec4 c = texture2D(Texture, vTexCoord);
    vec4 p = texture2D(PrevTexture, vTexCoord);
    float phase = 0.5 + 0.5 * sin(float(FrameCount) * 0.37 + vTexCoord.y * 40.0);
    float drift = fract(Time * 3.0 + vTexCoord.x);
    gl_FragColor = vec4(0.6 * c.rgb + 0.3 * p.rgb * phase + 0.1 * drift, 1.0);
}

#endif
"""


def _streams(seed, s=3, t=4):
    h, w = SRC_HW
    return np.random.default_rng(seed).integers(0, 256, (s, t, h, w, 3), dtype=np.uint8)


def test_multi_stream_temporal_matches_sequential():
    """[S,T,H,W,C] streams, mirroring tests/test_engine.py's case: stream s
    equals an engine of its own fed that stream alone (bit for bit within
    the port), equals the JAX engine's apply_streams (the gate of _close),
    and the 5-D branch of apply() is apply_streams."""
    je, te = _engines(FEEDBACK)
    frames = _streams(800)
    for i in range(2):  # the per-stream feedback carries across applies
        a = np.asarray(je.apply(frames))
        b = te.apply(torch.from_numpy(frames))
        assert tuple(b.shape) == (3, 4, VIEWPORT[1], VIEWPORT[0], 3) and b.dtype == torch.float32
        _close(a, b.numpy(), "f32")
    for si in range(3):
        own = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
        assert own.load_preset(FEEDBACK)
        for i in range(2):
            ref = own.apply(torch.from_numpy(frames[si]))
        assert torch.equal(b[si], ref), f"stream {si} differs from an engine of its own"
    key = SRC_HW + VIEWPORT + (3, "const")
    st = te._states[key]
    assert st.frame_count.tolist() == [8, 8, 8] and st.frame_count.dtype == torch.int32
    assert tuple(st.feedback[0].shape) == (3,) + tuple(np.asarray(je._states[key].feedback[0]).shape[1:])
    assert np.array_equal(st.feedback[0].numpy(), np.asarray(je._states[key].feedback[0]))
    with pytest.raises(ValueError):
        te.apply_streams(torch.from_numpy(frames[0]))


def test_multi_stream_history_seeds_each_stream_from_its_own_first_frame():
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "history.glsl")
        with open(path, "w") as f:
            f.write(HISTORY_GLSL)
        je, te = _engines(path)
        frames = _streams(801, s=2, t=3)
        a = np.asarray(je.apply_streams(frames))
        b = te.apply_streams(torch.from_numpy(frames))
        _close(a, b.numpy(), "f32")
        for si in range(2):
            own = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
            assert own.load_preset(path)
            assert torch.equal(b[si], own.apply(torch.from_numpy(frames[si])))
    key = SRC_HW + VIEWPORT + (2, "const")
    assert len(te._states[key].history) == 7 and te._states[key].history[0].shape[0] == 2


def test_multi_stream_passthrough_without_a_preset():
    je = jax_pkg.Engine(viewport=VIEWPORT)
    te = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
    frames = _streams(802, s=2, t=2)
    a = np.asarray(je.apply_streams(frames))
    b = te.apply_streams(torch.from_numpy(frames)).numpy()
    assert b.shape == (2, 2, VIEWPORT[1], VIEWPORT[0], 3)
    assert np.abs(a.astype(np.float64) - b).max() <= 2.4e-7  # one LINEAR matmul resize


def test_state_checkpoint_resume(tmp_path):
    """Mid-stream save/restore, mirroring tests/test_engine.py's case, with
    single-stream and per-stream state in one checkpoint: the port's own
    continuation is exact, the JAX engine's checkpoint continues in the
    port, and chain_state_from_numpy takes the stream state as it is."""
    je, te = _engines(FEEDBACK)
    streams, single = _streams(803), _rgb(804, 2)
    for e, wrap in ((je, np.asarray), (te, torch.from_numpy)):
        e.apply(wrap(single))
        e.apply_streams(wrap(streams))
    te.save_state(str(tmp_path / "port"))
    je.save_state(str(tmp_path / "jax.npz"))
    nxt = _streams(805)
    cont_a = te.apply_streams(torch.from_numpy(nxt))
    cont_j = np.asarray(je.apply_streams(nxt))

    for ckpt in ("port", "jax.npz"):
        e2 = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
        assert e2.load_preset(FEEDBACK)
        e2.load_state(str(tmp_path / ckpt))
        assert set(e2._states) == set(te._states) | {SRC_HW + VIEWPORT}
        cont_b = e2.apply_streams(torch.from_numpy(nxt))
        if ckpt == "port":
            assert torch.equal(cont_a, cont_b)
        _close(cont_j, cont_b.numpy(), "f32")

    key = SRC_HW + VIEWPORT + (3, "const")
    js_state = je._states[key]
    direct = chain_state_from_numpy(
        [np.asarray(h) for h in js_state.history],
        {j: np.asarray(t) for j, t in js_state.feedback.items()},
        np.asarray(js_state.frame_count),
        np.asarray(js_state.time),
        "cpu",
    )
    assert tuple(direct.frame_count.shape) == (3,) and direct.frame_count.dtype == torch.int32
    assert tuple(direct.time.shape) == (3,) and direct.time.dtype == torch.float32
    assert direct.feedback[0].shape[0] == 3
    # The JAX engine's stream state, handed over directly, continues alike.
    e3 = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
    assert e3.load_preset(FEEDBACK)
    e3._states[key] = direct
    more = _streams(806)
    _close(np.asarray(je.apply_streams(more)), e3.apply_streams(torch.from_numpy(more)).numpy(), "f32")


def test_apply_u8_device_output():
    """apply_u8 returns numpy uint8 equal to apply(output="u8") brought to
    the host, within one level of the quantized f32 path (mirroring
    tests/test_engine.py's case on feedback-ghost), and equal to the JAX
    engine's apply_u8 within the gate of _close."""
    je, te = _engines(FEEDBACK)
    te2 = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
    te3 = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
    assert te2.load_preset(FEEDBACK) and te3.load_preset(FEEDBACK)
    for i in range(2):
        frames = _rgb(810 + i, 2)
        got = te.apply_u8(frames)
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8 and got.shape == (2, VIEWPORT[1], VIEWPORT[0], 3)
        np.testing.assert_array_equal(got, te2.apply(torch.from_numpy(frames), output="u8").numpy())
        f32 = te3.apply(torch.from_numpy(frames)).numpy()
        ref = np.round(np.clip(f32, 0, 1) * 255.0).astype(np.int32)
        assert np.abs(got.astype(np.int32) - ref).max() <= 1
        _close(np.asarray(je.apply_u8(frames)), got, "u8")
    one = te.apply_u8(_rgb(812, 1)[0])
    assert one.shape == (VIEWPORT[1], VIEWPORT[0], 3)
    # Without a program: the quantized passthrough.
    bare = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
    jbare = jax_pkg.Engine(viewport=VIEWPORT)
    _close(np.asarray(jbare.apply_u8(frames)), bare.apply_u8(frames), "u8")


@pytest.mark.parametrize(
    "error",
    [
        RuntimeError("resample_u8 kernel launch failed: cudaError 700"),
        ValueError("resample_u8: C = 5 channels, the kernel takes 1 to 4"),
        TypeError("resample_u8: tex must be float32"),
    ],
    ids=lambda e: type(e).__name__,
)
def test_apply_u8_does_not_swallow_a_kernel_failure(monkeypatch, error):
    """A chain that fails to lower retreats to the quantized f32 path; an
    error of the blit wrapper (a build or launch failure is a
    RuntimeError, a refused input a ValueError or TypeError) is raised to
    the caller by apply_u8 and by apply(output="u8"), and is not taken
    for a lowering failure."""
    from retrocapture_tpu_torch.runtime import engine as eng_mod

    te = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
    assert te.load_preset(FEEDBACK)

    def boom(*a, **k):
        raise error

    monkeypatch.setattr(eng_mod, "blit_u8", boom)
    for call in (te.apply_u8, lambda f: te.apply(f, output="u8")):
        with pytest.raises(type(error), match="resample_u8"):
            call(_rgb(813, 1))
        assert te.shader_active and not te._lowering_failed and te.last_error is None


@pytest.mark.parametrize("output", ["u8", "f32"])
def test_concrete_frame_count_matches_jax(monkeypatch, output):
    """RCTPU_CONCRETE_FC=1 through both engines (each module's flag set
    here, as the environment variable sets it at import) on a shader that
    reads FrameCount and Time and keeps history: FrameCount and Time
    reach the evaluator as numpy scalars, Time as f32(0.016) * f32(fc)."""
    from retrocapture_tpu.runtime import engine as jeng
    from retrocapture_tpu_torch.graph import plan as tplan
    from retrocapture_tpu_torch.runtime import engine as teng

    monkeypatch.setattr(jeng, "_CONCRETE_FC", True)
    monkeypatch.setattr(teng, "_CONCRETE_FC", True)
    seen = []
    real_init = tplan.PassContext.__init__

    def spy(self, *a, **k):
        real_init(self, *a, **k)
        seen.append((self.frame_count, self.frame_time))

    monkeypatch.setattr(tplan.PassContext, "__init__", spy)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "fc.glsl")
        with open(path, "w") as f:
            f.write(HISTORY_FEEDBACK_FC_GLSL)
        je, te = _engines(path)
        for i in range(3):
            a, b = _apply(je, te, _rgb(820 + i, 2), output)
            _close(a, b, output)
    assert te.shader_active and je.shader_active, (te.last_error, je.last_error)
    assert [int(fc) for fc, _ in seen] == list(range(6))
    for fc, tm in seen:
        assert isinstance(fc, np.int32) and isinstance(tm, np.float32)
        assert tm == np.float32(0.016) * np.float32(int(fc))
    key = SRC_HW + VIEWPORT
    assert int(te._states[key].frame_count) == 6 == int(np.asarray(je._states[key].frame_count))
    assert float(te._states[key].time) == float(np.asarray(je._states[key].time))


def test_frame_count_is_a_tensor_by_default(monkeypatch):
    from retrocapture_tpu_torch.graph import plan as tplan

    seen = []
    real_init = tplan.PassContext.__init__
    monkeypatch.setattr(tplan.PassContext, "__init__", lambda self, *a, **k: (real_init(self, *a, **k), seen.append(self.frame_count))[0])
    te = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
    assert te.load_preset(FEEDBACK)
    te.apply(torch.from_numpy(_rgb(830, 2)))
    assert len(seen) == 2 and all(isinstance(fc, torch.Tensor) for fc in seen)


def test_param_mode_traced_runs_through_engine():
    """set_param_mode("traced") is accepted (a bogus mode is not); the
    parameters reach the walk as the engine's f32 0-d buffers, and a
    set_parameter writes its buffer and keeps the programs."""
    te = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
    with pytest.raises(ValueError):
        te.set_param_mode("bogus")
    assert te.load_preset(FEEDBACK)
    te.set_input_format("nv12")
    te.set_param_mode("traced")
    first = te.apply(torch.from_numpy(_nv12(7, 2)), output="u8")
    assert te._effective_param_mode() == "traced" and not te._param_const_fallback
    buf = te._param_bufs["GHOST"]
    assert buf.dtype == torch.float32 and buf.dim() == 0 and float(buf) == np.float32(0.35)
    programs = dict(te._programs)
    assert te.set_parameter("GHOST", 0.8)
    assert float(buf) == np.float32(0.8) and te._param_bufs["GHOST"] is buf
    assert te._programs == programs and len(programs) == 1
    second = te.apply(torch.from_numpy(_nv12(7, 2)), output="u8")
    assert first.shape == second.shape == (2, VIEWPORT[1], VIEWPORT[0], 3)
    assert te.shader_active and te.last_error is None
    te.set_param_mode("const")
    assert te._programs == {}
