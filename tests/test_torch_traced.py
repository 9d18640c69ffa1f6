"""Traced parameters: retrocapture_tpu_torch.Engine (on the CPU) against
retrocapture_tpu.Engine (JAX on the CPU), both after
``set_param_mode("traced")``, on the same presets, parameters and input
frames (numpy, from a seed).

In traced mode the reference feeds each parameter to its jitted chain as
an f32 device scalar, and the port feeds the walk its f32 0-d parameter
buffer; a ``set_parameter`` between applies changes the output with no
program rebuilt (glUniform's behaviour, ShaderEngine.cpp:3353). The port
is held to the reference in traced mode, not to its own const mode: the
two modes round differently where the const path folds a parameter into a
constant (tests/test_engine.py:276-312 of the reference).

Tolerance: feedback-ghost-nv12 bit-equal, u8 and f32. The crt-mattias
stand-in: bit-equal to the port's own const mode on the same frames and
parameters (so is the reference's traced mode to its const mode there),
and within max 1 u8 step of the reference in traced mode: the residue of
ROADMAP queue 3 #1, the blur's summation order, which the reference's
jitted Pallas body takes from XLA's vectorisation of its row reduce (eight
rows a vector, then a horizontal tree; not mirrored). On the frames of
tests/test_torch_mattias.py (its four frames and two more of its generator,
seed 5) the share of values
that differ is held to that test's bound, <= 2e-5 a frame (measured, CPU:
0 or 1 value of 110,592 a frame, 9.0e-6). The residue depends on the
frames: on seed 15 it reaches 4 values a frame (3.6e-5; 0 to 4, in traced
and const mode alike), which the second case holds to <= 5e-5 and ROADMAP
queue 3 #1 records.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import retrocapture_tpu as jax_pkg
import retrocapture_tpu_torch as torch_pkg
from _mattias_standin import write_standin
from retrocapture_tpu.graph import kernels as jk
from retrocapture_tpu.ops.pallas import blur_groups as jbg
from retrocapture_tpu_torch.graph import kernels as tk
from test_torch_mattias import BATCH, SRC_HW as MATTIAS_HW, VIEWPORT as MATTIAS_VIEWPORT, _recording, _TPUJax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEEDBACK = os.path.join(REPO, "assets", "presets", "feedback-ghost.glslp")
SRC_HW = (48, 64)
VIEWPORT = (160, 120)

# A parameter as a loop bound: the reference's tracer cannot give the
# loop a trip count, nor can the port's buffer; both engines retreat to
# const mode for the preset.
LOOP_GLSL = """#pragma parameter TAPS "Taps" 3.0 1.0 8.0 1.0

#if defined(VERTEX)

attribute vec4 VertexCoord;
attribute vec4 TexCoord;
varying vec2 vTexCoord;
uniform mat4 MVPMatrix;

void main()
{
    gl_Position = MVPMatrix * VertexCoord;
    vTexCoord = TexCoord.xy;
}

#elif defined(FRAGMENT)

varying vec2 vTexCoord;
uniform sampler2D Texture;
uniform vec2 TextureSize;

#ifdef PARAMETER_UNIFORM
uniform float TAPS;
#else
#define TAPS 3.0
#endif

void main()
{
    vec4 acc = vec4(0.0);
    for (int i = 0; i < int(TAPS); i++)
        acc += texture2D(Texture, vTexCoord + vec2(float(i) / TextureSize.x, 0.0));
    gl_FragColor = acc / TAPS;
}

#endif
"""

LOOP_GLSLP = """shaders = 1
shader0 = loop-taps.glsl
filter_linear0 = false
scale_type0 = source
scale0 = 1.0
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: torch's CPU thread pool only adds its start-up cost
    per operation (tens of milliseconds a call under a parallel test run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nv12(seed, b):
    h, w = SRC_HW
    return np.random.default_rng(seed).integers(0, 256, (b, h * 3 // 2, w), dtype=np.uint8)


def _traced(path, fmt="rgb", viewport=VIEWPORT):
    je = jax_pkg.Engine(viewport=viewport)
    te = torch_pkg.Engine(viewport=viewport, device="cpu")
    for e in (je, te):
        assert e.load_preset(path), e.last_error
        e.set_input_format(fmt)
        e.set_param_mode("traced")
    return je, te


def _both(je, te, frames, output):
    a = np.asarray(je.apply(frames, output=output))
    b = te.apply(torch.from_numpy(frames), output=output).numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    return a, b


@pytest.mark.parametrize("output", ["u8", "f32"])
def test_feedback_ghost_nv12_traced_bit_equal_to_jax(output):
    """Three applies of 2 frames, GHOST set to 0.8 after the first and to
    0.1 after the second: bit-equal each time, and the new value shows."""
    je, te = _traced(FEEDBACK, "nv12")
    outs = []
    for i, ghost in enumerate((None, 0.8, 0.1)):
        if ghost is not None:
            assert je.set_parameter("GHOST", ghost) and te.set_parameter("GHOST", ghost)
        a, b = _both(je, te, _nv12(300 + i, 2), output)
        np.testing.assert_array_equal(b, a)
        outs.append(b)
    assert te._effective_param_mode() == je._effective_param_mode() == "traced"
    assert not te._param_const_fallback and not je._param_const_fallback
    # The same frames at another GHOST give another picture.
    te2 = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
    assert te2.load_preset(FEEDBACK)
    te2.set_input_format("nv12")
    te2.set_param_mode("traced")
    te2.apply(torch.from_numpy(_nv12(300, 2)), output=output)
    other = te2.apply(torch.from_numpy(_nv12(301, 2)), output=output).numpy()
    assert np.abs(other.astype(np.float64) - outs[1]).max() > 0


def test_set_parameter_in_traced_mode_keeps_the_programs():
    """The reference's invariants (tests/test_engine.py:276-312) on the
    port: no program is built anew by set_parameter, and the parameter
    has an effect; in const mode set_parameter drops them."""
    te = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
    assert te.load_preset(FEEDBACK)
    te.set_input_format("nv12")
    te.set_param_mode("traced")
    frames = torch.from_numpy(_nv12(11, 2))
    te.apply(frames)
    programs = dict(te._programs)
    state = te._states[SRC_HW + VIEWPORT]
    out1 = te.apply(frames)
    te._states[SRC_HW + VIEWPORT] = state  # the same state for both
    assert te.set_parameter("GHOST", 0.0)
    out2 = te.apply(frames)
    assert te._programs == programs and all(te._programs[k] is p for k, p in programs.items())
    assert (out1 - out2).abs().mean() > 1e-3, "parameter had no effect"
    te.set_param_mode("const")
    te.apply(frames)
    assert te._programs and te._programs.keys() != programs.keys()
    kept = dict(te._programs)
    assert te.set_parameter("GHOST", 0.5)
    assert te._programs == {} and kept


@pytest.fixture(scope="module")
def standin():
    with tempfile.TemporaryDirectory() as td:
        yield write_standin(td)


def _mattias_frames(seed):
    return np.random.default_rng(seed).integers(0, 256, (3 * BATCH,) + MATTIAS_HW + (3,), dtype=np.uint8)


MATTIAS_STEPS = ((None, None), ("CURVATURE", 0.8), ("SCANSPEED", 3.5))


def _jax_mattias_traced(standin, seed):
    """The JAX engine in traced mode: three applies of BATCH frames, with
    CURVATURE and then SCANSPEED changed before the second and third."""
    frames = _mattias_frames(seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RCTPU_KERNELS", "interpret")
        mp.setattr(jbg, "jax", _TPUJax())
        wrapped, calls = _recording(jk._REGISTRY, "crt-mattias.glsl")
        mp.setitem(jk._REGISTRY, "crt-mattias.glsl", wrapped)
        e = jax_pkg.Engine(viewport=MATTIAS_VIEWPORT)
        assert e.load_preset(standin), e.last_error
        e.set_param_mode("traced")
        outs = []
        for i, (name, value) in enumerate(MATTIAS_STEPS):
            if name is not None:
                assert e.set_parameter(name, value)
            outs.append(np.asarray(e.apply(frames[i * BATCH:(i + 1) * BATCH], output="u8")))
        assert e.shader_active is True and e.last_error is None
        assert e._effective_param_mode() == "traced"
    assert calls and all(calls), "the reference's crt-mattias kernel did not engage"
    return np.concatenate(outs)


@pytest.fixture(scope="module")
def jax_mattias_traced(standin):
    """On tests/test_torch_mattias.py's frames (its generator, seed 5)."""
    return _jax_mattias_traced(standin, 5)


@pytest.fixture(scope="module")
def jax_mattias_traced_seed15(standin):
    return _jax_mattias_traced(standin, 15)


def _check_mattias_traced(standin, want, seed, bound, monkeypatch):
    """The port's traced run against ``want``: max 1 u8 step in <= ``bound``
    of values a frame; the port's const mode renders the same bits."""
    frames = _mattias_frames(seed)
    wrapped, calls = _recording(tk._REGISTRY, "crt-mattias.glsl")
    monkeypatch.setitem(tk._REGISTRY, "crt-mattias.glsl", wrapped)
    e = torch_pkg.Engine(viewport=MATTIAS_VIEWPORT, device="cpu")
    assert e.load_preset(standin)
    e.set_param_mode("traced")
    outs = []
    for i, (name, value) in enumerate(MATTIAS_STEPS):
        if name is not None:
            assert e.set_parameter(name, value)
        outs.append(e.apply(torch.from_numpy(frames[i * BATCH:(i + 1) * BATCH]), output="u8").numpy())
    got = np.concatenate(outs)
    assert e.shader_active and e._effective_param_mode() == "traced" and len(e._programs) == 1
    assert len(calls) >= len(MATTIAS_STEPS) and all(calls), "the port's crt-mattias kernel did not engage"
    assert got.shape == want.shape
    for i in range(len(got)):
        d = np.abs(got[i].astype(np.int32) - want[i].astype(np.int32))
        assert d.max() <= 1, (i, d.max())
        assert (d != 0).mean() <= bound, (seed, i, (d != 0).mean())
    # Const mode with the same parameter changes renders the same bits.
    c = torch_pkg.Engine(viewport=MATTIAS_VIEWPORT, device="cpu")
    assert c.load_preset(standin)
    for i, (name, value) in enumerate(MATTIAS_STEPS):
        if name is not None:
            assert c.set_parameter(name, value)
        out = c.apply(torch.from_numpy(frames[i * BATCH:(i + 1) * BATCH]), output="u8").numpy()
        np.testing.assert_array_equal(out, got[i * BATCH:(i + 1) * BATCH])
    # CURVATURE moved the picture's edge.
    assert not np.array_equal(got[0] == 0, got[BATCH] == 0)


def test_crt_mattias_traced_matches_jax(standin, jax_mattias_traced, monkeypatch):
    """The hand kernel on tensor parameters, held to the reference's
    traced mode on tests/test_torch_mattias.py's frames within that
    test's bound, 2e-5."""
    _check_mattias_traced(standin, jax_mattias_traced, 5, 2e-5, monkeypatch)


def test_crt_mattias_traced_residue_on_other_frames(standin, jax_mattias_traced_seed15, monkeypatch):
    """The same on frames where the blur's residue is larger (module
    docstring): up to 4 values a frame, held to 5e-5."""
    _check_mattias_traced(standin, jax_mattias_traced_seed15, 15, 5e-5, monkeypatch)


def test_concrete_parameter_falls_back_to_const_alike():
    """A loop bound from a parameter: both engines warn, set their const
    fallback and render what const mode renders, in u8 and f32."""
    with tempfile.TemporaryDirectory() as td:
        with open(os.path.join(td, "loop-taps.glsl"), "w") as f:
            f.write(LOOP_GLSL)
        path = os.path.join(td, "loop-taps.glslp")
        with open(path, "w") as f:
            f.write(LOOP_GLSLP)
        frames = np.random.default_rng(21).integers(0, 256, (2,) + SRC_HW + (3,), dtype=np.uint8)
        je, te = _traced(path)
        const = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
        assert const.load_preset(path)
        for output in ("u8", "f32"):
            a, b = _both(je, te, frames, output)
            assert je._param_const_fallback and te._param_const_fallback
            assert te._effective_param_mode() == "const" and te.shader_active
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(const.apply(torch.from_numpy(frames), output=output).numpy(), b)
        # The fallback holds: set_parameter now rebuilds, as in const mode.
        assert te.set_parameter("TAPS", 2.0) and te._programs == {}
