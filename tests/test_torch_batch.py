"""The batched branches of retrocapture_tpu_torch.Engine on the CPU: the
reference's vmap of a stateless chain (its runtime/engine.py:845-880) and
its fc-period grouped batch (:370-392, :774-818), against
retrocapture_tpu.Engine (JAX on the CPU, Pallas in interpret mode as its
own tests run it) and against the port's own applies of one frame each.

A stateless chain's batch is one walk: ``torch.func.vmap`` of the frame's
chain over the frames (runtime/replay.stateless_batch), frame i with
FrameCount fc + i and Time time + 0.016 i as device tensors; the kernels'
operators batch by their vmap rules (one launch for a batch of textures
that shares its coordinates). A grouped batch is m such walks of B/m
frames, each with one host FrameCount. Every test here turns vmap's
per-example fallback warning into an error, so no op of a batched walk
falls back to a loop over the frames unseen.

Tolerances, each with its reason:

* the evaluator's chains (a FrameCount shader, warp-curve in const mode)
  and xbr-lv2: bit-equal to the JAX engine (as tests/test_torch_engine.py
  and tests/test_torch_xbr.py hold them one frame at a time);
* warp-curve in traced mode: the gate of tests/test_torch_engine.py (u8
  at most 1 step in at most 0.1% of values; f32 at most 1/255 + 1e-6, in
  at most 0.1% of values beyond 1e-6). Measured on the CPU: 4.3e-5 of the
  values one RGBA8 code apart, the same one frame at a time before this
  branch existed: the traced coordinates' f32 arithmetic, not the batch;
* ntsc-320px and nnedi3: at most 1 u8 step in at most 0.1% of values (the
  f32 band product's and the contractions' accumulation order, as
  tests/test_torch_ntsc.py and tests/test_torch_nnedi3.py hold them);
* crt-mattias, const and traced: at most 1 u8 step in at most 2e-5 of a
  frame's values on seed 5 (ROADMAP queue 3 #1, the blur's summation
  order; tests/test_torch_mattias.py);
* a batch against B applies of one frame each, and a grouped batch against
  ``RCTPU_FC_GROUP=0``: bit-equal (the same arithmetic for every frame).
"""

import os
import tempfile
import warnings

import numpy as np
import pytest
import torch

import retrocapture_tpu as jax_pkg
import retrocapture_tpu_torch as torch_pkg
from _mattias_standin import write_standin as write_mattias
from _nnedi3_standin import write_chain as write_nnedi3
from _ntsc_standin import write_chain as write_ntsc
from _xbr_standin import write_standin as write_xbr
from retrocapture_tpu.graph.plan import compile_preset as jax_compile
from retrocapture_tpu.presets.glslp import Preset as JaxPreset
from retrocapture_tpu_torch.graph import kernels as tk
from retrocapture_tpu_torch.graph.plan import compile_preset as torch_compile
from retrocapture_tpu_torch.ops.cuda import blur_groups as bg
from retrocapture_tpu_torch.ops.cuda import warp_sample as ws
from retrocapture_tpu_torch.ops.cuda import xbr_epilogue as xe
from retrocapture_tpu_torch.presets.glslp import Preset as TorchPreset
from retrocapture_tpu_torch.runtime import engine as engine_module
from test_torch_engine import VERTEX, WARP_GLSL, WARP_GLSLP, _close
from test_torch_mattias import jax_slice, standin  # noqa: F401 - fixtures
from test_torch_mattias import _frames as mattias_frames
from test_torch_replay import _HostArrays, _HostWork

SRC_HW = (48, 64)
VIEWPORT = (160, 120)
B = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: torch's CPU thread pool only adds its start-up cost."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    """vmap's per-example fallback (an op with no batching rule, run frame
    by frame) is an error in every test of this module."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*batching rule.*")
            yield
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


@pytest.fixture(scope="module")
def tmp():
    with tempfile.TemporaryDirectory() as td:
        yield td


# A shader that reads FrameCount (and, in its variants, Time, or nothing
# that changes from frame to frame).
FC_GLSL = """#pragma parameter GAIN "Gain" 0.6 0.0 1.0 0.05

""" + VERTEX + """
varying vec2 vTexCoord;
uniform sampler2D Texture;
uniform int FrameCount;
uniform float Time;

#ifdef PARAMETER_UNIFORM
uniform float GAIN;
#else
#define GAIN 0.6
#endif

void main()
{
    vec4 c = texture2D(Texture, vTexCoord);
    BODY
}

#endif
"""

BODIES = {
    "frame-count": "gl_FragColor = c * (GAIN + fract(float(FrameCount) * 0.37));",
    "time": "gl_FragColor = c * (GAIN + fract(Time * 3.0));",
    "unread": "gl_FragColor = c * GAIN;",
}


FC_VIEWPORT = (128, 96)  # the pass's own size: no LINEAR viewport blit


def write_fc(directory, body="frame-count", mod=0):
    """A one-pass preset (NEAREST, source x2: LINEAR taps would bring in
    ROADMAP queue 3 #3) of FC_GLSL with ``body``, ``frame_count_mod0 =
    mod``; its path."""
    name = f"fc-{body}-{mod}"
    with open(os.path.join(directory, name + ".glsl"), "w") as f:
        f.write(FC_GLSL.replace("BODY", BODIES[body]))
    path = os.path.join(directory, name + ".glslp")
    with open(path, "w") as f:
        f.write(
            f"shaders = 1\nshader0 = {name}.glsl\nfilter_linear0 = false\nscale_type0 = source\nscale0 = 2.0\n"
            f"frame_count_mod0 = {mod}\n"
        )
    return path


def write_warp(directory):
    with open(os.path.join(directory, "warp-curve.glsl"), "w") as f:
        f.write(WARP_GLSL)
    path = os.path.join(directory, "warp-curve.glslp")
    with open(path, "w") as f:
        f.write(WARP_GLSLP)
    return path


# name -> (preset writer, viewport, source (h, w), traced parameter change,
# JAX kernels in interpret mode)
FAMILIES = {
    "frame-count": (write_fc, FC_VIEWPORT, SRC_HW, None, False),
    "warp-const": (write_warp, VIEWPORT, SRC_HW, None, False),
    "warp-traced": (write_warp, VIEWPORT, SRC_HW, ("CURV", 0.6), False),
    "xbr": (write_xbr, (192, 144), SRC_HW, None, True),
    "ntsc": (lambda d: write_ntsc(d, 256), (128, 96), SRC_HW, None, True),
    "nnedi3": (lambda d: write_nnedi3(d, 16, "rgb", seed=16), (64, 48), (24, 32), None, True),
}


def _frames(seed, n, hw=SRC_HW):
    return np.random.default_rng(seed).integers(0, 256, (n,) + hw + (3,), dtype=np.uint8)


def _port_engine(path, viewport, traced=None):
    e = torch_pkg.Engine(viewport=viewport, device="cpu")
    assert e.load_preset(path), e.last_error
    if traced is not None:
        e.set_param_mode("traced")
    return e


def _port(path, viewport, batches, output, traced=None):
    """Each batch applied in turn on a fresh port engine (a traced
    parameter changed after the first); the outputs and the engine."""
    e = _port_engine(path, viewport, traced)
    outs = []
    for i, b in enumerate(batches):
        if traced is not None and i == 1:
            assert e.set_parameter(*traced)
        outs.append(e.apply(torch.from_numpy(b), output=output).numpy())
    assert e.shader_active is True and e.last_error is None
    return np.concatenate(outs), e


def _jax(path, viewport, batches, output, monkeypatch, traced=None, interpret=False):
    with monkeypatch.context() as mp:
        if interpret:
            mp.setenv("RCTPU_KERNELS", "interpret")
        e = jax_pkg.Engine(viewport=viewport)
        assert e.load_preset(path), e.last_error
        if traced is not None:
            e.set_param_mode("traced")
        outs = []
        for i, b in enumerate(batches):
            if traced is not None and i == 1:
                assert e.set_parameter(*traced)
            outs.append(np.asarray(e.apply(b, output=output)))
        assert e.shader_active is True and e.last_error is None
    return np.concatenate(outs)


def _u8_budget(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d != 0).mean() <= 1e-3, (d != 0).mean()


def _stateless_keys(e):
    """The program keys of the engine's stateless batches: (..., B, fc_group)."""
    return [k for k in e._programs if len(k) == 8 and k[6] != "streams"]


# -- 1. the batched port against the JAX engine's batched apply ---------------


@pytest.mark.parametrize(
    "family,output",
    [("frame-count", "u8"), ("frame-count", "f32"), ("warp-const", "u8"), ("warp-traced", "f32"), ("xbr", "u8"),
     ("ntsc", "u8"), ("nnedi3", "u8")],
)
def test_batch_matches_jax_engine(tmp, monkeypatch, family, output):
    """Two applies of B frames each (FrameCount 0 to 2B - 1): one walk an
    apply in the port, the JAX engine's vmap branch (or its grouped one)."""
    write, viewport, hw, traced, interpret = FAMILIES[family]
    path = write(tmp)
    batches = [_frames(10, B, hw), _frames(11, B, hw)]
    walks = []
    real = engine_module._run_chain_impl
    monkeypatch.setattr(engine_module, "_run_chain_impl", lambda *a, **k: (walks.append(1), real(*a, **k))[1])
    got, e = _port(path, viewport, batches, output, traced)
    grouped = bool(_stateless_keys(e)) and all(k[-1] is not None for k in _stateless_keys(e))
    assert len(walks) == 2 * (2 if grouped else 1), walks  # ntsc: a walk per FrameCount parity
    assert grouped == (family == "ntsc")
    want = _jax(path, viewport, batches, output, monkeypatch, traced, interpret)
    assert got.shape == want.shape and got.dtype == want.dtype
    if family in ("ntsc", "nnedi3"):
        _u8_budget(got, want)
    elif family == "warp-traced":
        _close(want, got, output)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["const", "traced"])
def test_mattias_batch_within_the_blur_bound(standin, jax_slice, monkeypatch, mode):  # noqa: F811
    """crt-mattias: the four frames of tests/test_torch_mattias.py (seed 5)
    in one apply, blur_groups once for the batch; within ROADMAP queue 3
    #1's bound of the JAX engine's two applies of two, in const mode and
    in traced mode (which gives the port's const bits)."""
    frames = mattias_frames()
    launches = []
    real = bg._plain
    monkeypatch.setattr(bg, "_plain", lambda tex, *a: (launches.append(tex.shape[0]), real(tex, *a))[1])
    got, _ = _port(standin, (256, 144), [frames], "u8", ("CURVATURE", 0.5) if mode == "traced" else None)
    assert launches == [len(frames)], launches  # one blur of the whole batch
    assert got.shape == jax_slice.shape
    for i in range(len(got)):
        d = np.abs(got[i].astype(np.int32) - jax_slice[i].astype(np.int32))
        assert d.max() <= 1 and (d != 0).mean() <= 2e-5, (i, d.max(), (d != 0).mean())
    if mode == "traced":
        const, _ = _port(standin, (256, 144), [frames], "u8")
        np.testing.assert_array_equal(got, const)


# -- 2. a batch against applies of one frame each -----------------------------


@pytest.mark.parametrize("family", ["frame-count", "warp-traced", "xbr", "ntsc", "nnedi3", "mattias"])
def test_batch_equals_single_frame_applies(tmp, family, monkeypatch):
    """B frames in one apply equal B applies of one frame each on a fresh
    engine (FrameCount 0 to B-1 in both), bit for bit."""
    if family == "mattias":
        write, viewport, hw, traced = write_mattias, (256, 144), SRC_HW, None
    else:
        write, viewport, hw, traced, _ = FAMILIES[family]
    path = write(tmp)
    frames = _frames(20, B, hw)
    e = _port_engine(path, viewport, traced)
    if traced is not None:
        assert e.set_parameter(*traced)
    batch = e.apply(torch.from_numpy(frames)).numpy()
    e1 = _port_engine(path, viewport, traced)
    if traced is not None:
        assert e1.set_parameter(*traced)
    singles = np.stack([e1.apply(torch.from_numpy(f)).numpy() for f in frames])
    np.testing.assert_array_equal(batch, singles)
    assert int(e._states[hw + viewport].frame_count) == int(e1._states[hw + viewport].frame_count) == B
    assert e._fc_hosts[hw + viewport] == e1._fc_hosts[hw + viewport] == B


# -- 3. fc_period, port against JAX ---------------------------------------------


FC_PERIODS = {  # name -> (preset writer, the expected period or "jax")
    "mod-declared": (lambda d: write_fc(d, "frame-count", mod=3), 3),
    "frame-count-without-mod": (lambda d: write_fc(d, "frame-count"), None),
    "time-read": (lambda d: write_fc(d, "time", mod=2), None),
    "declared-never-read": (lambda d: write_fc(d, "unread"), 1),
    "ntsc": (lambda d: write_ntsc(d, 256), 2),
    "xbr": (write_xbr, "jax"),
    "mattias": (write_mattias, "jax"),
    "nnedi3": (lambda d: write_nnedi3(d, 16, "rgb", seed=16), "jax"),
}


@pytest.mark.parametrize("name", sorted(FC_PERIODS))
def test_fc_period_matches_jax(tmp, name):
    write, want = FC_PERIODS[name]
    path = write(tmp)
    got = torch_compile(TorchPreset.load(path)).fc_period()
    ref = jax_compile(JaxPreset.load(path)).fc_period()
    assert got == ref, (got, ref)
    if want != "jax":
        assert got == want


# -- 4. fc-period grouping ----------------------------------------------------


def _apply_with(e, frames, group: bool, monkeypatch, output="u8"):
    with monkeypatch.context() as mp:
        mp.setenv("RCTPU_FC_GROUP", "1" if group else "0")
        return e.apply(torch.from_numpy(frames), output=output).numpy()


GROUPED = {  # name -> (preset writer, viewport, batch, period)
    "ntsc": (lambda d: write_ntsc(d, 256), (128, 96), 4, 2),
    "mod-3": (lambda d: write_fc(d, "frame-count", mod=3), FC_VIEWPORT, 6, 3),
}


@pytest.mark.parametrize("name", sorted(GROUPED))
def test_grouped_equals_ungrouped(tmp, monkeypatch, name):
    """The grouped batch (one host FrameCount a position) is bit-identical
    to RCTPU_FC_GROUP=0 over two consecutive applies (mirroring
    tests/test_engine.py:384-408), and to the JAX engine's grouped batch
    (the mod-3 shader, bit-equal)."""
    write, viewport, nb, m = GROUPED[name]
    path = write(tmp)
    g, u = _port_engine(path, viewport), _port_engine(path, viewport)
    batches = [_frames(30, nb), _frames(31, nb)]
    got = []
    for frames in batches:
        got.append(_apply_with(g, frames, True, monkeypatch))
        np.testing.assert_array_equal(got[-1], _apply_with(u, frames, False, monkeypatch))
    assert [k[-1] for k in _stateless_keys(g)] == [(m, 0)]
    assert [k[-1] for k in _stateless_keys(u)] == [None]
    if name == "mod-3":
        np.testing.assert_array_equal(np.concatenate(got), _jax(path, viewport, batches, "u8", monkeypatch))


def test_odd_batch_bypasses_grouping(tmp, monkeypatch):
    """A batch that is not a whole number of periods takes the vmap branch;
    the next even batch groups from FrameCount % 2 = 1."""
    path = write_ntsc(tmp, 256)
    g, u = _port_engine(path, (128, 96)), _port_engine(path, (128, 96))
    for frames in (_frames(40, 3), _frames(41, 4)):
        np.testing.assert_array_equal(_apply_with(g, frames, True, monkeypatch), _apply_with(u, frames, False, monkeypatch))
    assert sorted(k[-2:] for k in _stateless_keys(g)) == [(3, None), (4, (2, 1))]
    assert g._fc_hosts[SRC_HW + (128, 96)] == 7


def test_fc_hosts_through_save_and_load_state(tmp, monkeypatch):
    """``_fc_hosts`` comes back from a checkpoint of either package
    (``s{k}_fc``), so a grouped batch after ``load_state`` starts from the
    right parity."""
    path = write_ntsc(tmp, 256)
    key = SRC_HW + (128, 96)
    e, u = _port_engine(path, (128, 96)), _port_engine(path, (128, 96))
    for x in (e, u):
        _apply_with(x, _frames(50, 3), x is e, monkeypatch)
        x.save_state(os.path.join(tmp, f"fc-{id(x)}"))
        _apply_with(x, _frames(51, 4), x is e, monkeypatch)
        x.load_state(os.path.join(tmp, f"fc-{id(x)}.npz"))
    assert e._fc_hosts == {key: 3}
    frames = _frames(52, 4)
    np.testing.assert_array_equal(_apply_with(e, frames, True, monkeypatch), _apply_with(u, frames, False, monkeypatch))
    assert (4, (2, 1)) in [k[-2:] for k in _stateless_keys(e)]
    # A checkpoint of the JAX engine after 3 frames.
    with monkeypatch.context() as mp:
        mp.setenv("RCTPU_KERNELS", "interpret")
        je = jax_pkg.Engine(viewport=(128, 96))
        assert je.load_preset(path)
        je.apply(_frames(50, 3))
        je.save_state(os.path.join(tmp, "fc-jax"))
        want = np.asarray(je.apply(frames, output="u8"))
    e.load_state(os.path.join(tmp, "fc-jax.npz"))
    assert e._fc_hosts == {key: 3}
    _u8_budget(_apply_with(e, frames, True, monkeypatch), want)


def test_fc_hosts_cleared_where_the_reference_clears_it(tmp, monkeypatch):
    path = write_fc(tmp, "frame-count", mod=3)
    key = SRC_HW + VIEWPORT
    e = _port_engine(path, VIEWPORT)
    frames = torch.from_numpy(_frames(60, 3))

    def fresh(event):
        e.apply(frames)
        assert e._fc_hosts == {key: 3}
        event()
        assert e._fc_hosts == {}, event

    fresh(e.reset_state)
    fresh(lambda: e.set_max_shader_resolution(0, 0))
    fresh(lambda: e.load_preset(path))

    def broken(*a, **k):
        raise engine_module.GlslEvalError("broken on purpose")

    e.apply(frames)
    e.reset_state()
    monkeypatch.setattr(engine_module, "_run_chain_impl", broken)
    e.apply(frames)
    assert e._lowering_failed and e._fc_hosts == {}
    monkeypatch.undo()
    e.load_preset(path)
    e.apply(frames)
    e.unload()
    assert e._fc_hosts == {}


# -- 5. what the batched walk does ---------------------------------------------


@pytest.mark.parametrize("family", ["frame-count", "warp-traced"])
def test_batched_walks_do_no_host_work(tmp, family):
    """The dispatch-mode guards of tests/test_torch_replay.py over one
    replayed batched walk: no host synchronisation, no host array."""
    write, viewport, hw, traced, _ = FAMILIES[family]
    e = _port_engine(write(tmp), viewport, traced)
    frames = torch.from_numpy(_frames(70, B, hw))
    e.apply(frames)
    if traced is not None:
        e.set_parameter(*traced)
    (program,) = e._programs.values()
    replayed = program.walk.uploads_replayed
    sync = _HostWork()
    with sync, _HostArrays(sync.hits):
        e._run_batch(hw + viewport, frames, e._states[hw + viewport])
    assert not sync.hits, "\n".join(f"{f} x{n}\n{s}" for (f, s), n in sync.hits.items())
    assert program.walk.uploads_replayed == replayed + len(program.walk.tensors)  # one walk


def test_one_walk_an_apply_and_a_program_per_batch_size(tmp, monkeypatch):
    """A stateless apply is one walk; its program is kept per batch size
    (the reference's jit cache keys on the shape), and a second apply of a
    size replays it."""
    path = write_fc(tmp)
    e = _port_engine(path, VIEWPORT)
    walks = []
    real = engine_module._run_chain_impl
    monkeypatch.setattr(engine_module, "_run_chain_impl", lambda *a, **k: (walks.append(1), real(*a, **k))[1])
    for n in (4, 4, 2, 4):
        e.apply(torch.from_numpy(_frames(80 + n, n)))
    assert len(walks) == 4
    assert sorted(k[-2:] for k in _stateless_keys(e)) == [(2, None), (4, None)]
    assert e._fc_hosts[SRC_HW + VIEWPORT] == 14 and int(e._states[SRC_HW + VIEWPORT].frame_count) == 14
    assert e.replay_stats() == {"graphs_captured": 0, "replays": 0, "uncaptured_applies": 0, "capture_seconds": 0.0}


# -- 6. the kernels' batching rules -----------------------------------------------


def _counting(monkeypatch, module, name):
    """Record the batch size of each call of ``module.name`` (an operator's
    CPU implementation)."""
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda t, *a, **k: (calls.append(t.shape[0]), real(t, *a, **k))[1])
    return calls


def _ops(kind, rng):
    """(the operator with coordinates shared by the batch ``f(tex)``, with
    a frame's own coordinates ``g(tex, coords)``, the textures, per-frame
    coordinates)."""
    if kind == "xbr_epilogue":
        S = torch.from_numpy(rng.integers(0, 256, (B, 19, 40, 32)).astype(np.float32))
        S[:, 15:] = torch.from_numpy(rng.integers(0, 32, (B, 4, 40, 32)).astype(np.float32))
        bx = np.repeat(np.arange(32), 2)[:56].astype(np.int32)
        maps = xe.prepare_maps(bx, (np.arange(56, dtype=np.float32) * 0.5) % 1.0, np.zeros(40, np.float32), 32, "cpu")
        fpy = torch.from_numpy(rng.random((B, 40), np.float32))
        return (
            lambda s: xe.xbr_epilogue(s[None], maps)[0],
            lambda s, fp: xe._xbr_epilogue_op(s[None], maps.bx, maps.fpx, fp, None, None, 0, 0, 0, 0)[0],
            S,
            fpy,
        )
    tex = torch.from_numpy(rng.random((B, 24, 32, 3), np.float32))
    uv = torch.from_numpy(rng.random((B, 2, 40, 56), np.float32) * 1.2 - 0.1)
    if kind == "warp_sample":
        def op(t, u, v):
            return ws.warp_sample(t, u, v, filter_linear=True, wrap_mode="clamp_to_edge")
    else:
        groups = tk.mattias_groups(56, 40)

        def op(t, u, v):
            return torch.stack([p for _, p in sorted(bg.blur5x5_groups(t, u, v, groups).items())])
    return (lambda t: op(t, uv[0, 0], uv[0, 1])), (lambda t, c: op(t, c[0], c[1])), tex, uv


@pytest.mark.parametrize("kind", ["warp_sample", "blur_groups", "xbr_epilogue"])
def test_vmap_rule_launches_once_for_shared_coordinates(monkeypatch, kind):
    """The reference's custom_vmap rules: a batch of textures with shared
    coordinates is one call of the operator over the batch; per-frame
    coordinates are a call a frame (its lax.map). Both give each frame
    what the call on that frame alone gives, bit for bit."""
    plain = {"warp_sample": (ws, "sample2d_gather"), "blur_groups": (bg, "_plain"),
             "xbr_epilogue": (xe, "xbr_epilogue_plain")}[kind]
    shared, own, tex, coords = _ops(kind, np.random.default_rng(90))
    want = torch.stack([shared(t) for t in tex])
    calls = _counting(monkeypatch, *plain)
    got = torch.func.vmap(shared)(tex)
    assert calls == [B], calls
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    calls.clear()
    got = torch.func.vmap(own)(tex, coords)
    assert calls == [1] * B, calls
    want = torch.stack([own(t, c) for t, c in zip(tex, coords)])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_bitcast_under_vmap_is_the_view():
    """policy.bitcast views the whole batch's tensor under vmap (torch
    versions differ in a batching rule for ``view(dtype)``), whatever the
    batch dimension, nested too."""
    from retrocapture_tpu_torch.policy import bitcast

    x = torch.from_numpy(np.random.default_rng(91).standard_normal((3, 5, 7)).astype(np.float32))
    want = x.view(torch.int32)
    got = torch.func.vmap(lambda t: bitcast(t, torch.int32), in_dims=1, out_dims=1)(x)
    assert torch.equal(got, want)
    got = torch.func.vmap(torch.func.vmap(lambda t: bitcast(bitcast(t, torch.int32), torch.float32)), in_dims=2)(x)
    assert torch.equal(got, x.permute(2, 0, 1))
