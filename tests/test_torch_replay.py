"""The program per key of retrocapture_tpu_torch.Engine on the CPU
(runtime/replay.py, policy.WalkProgram): the counterpart of the
reference's compile-once ``Engine._get_jit`` cache.

The first walk of a key records its host->device uploads; every later
walk takes them back (and checks them, bit for bit) instead of uploading.
On the CPU there is no CUDA graph; the program cache is what these tests
hold: a second apply uploads nothing and renders the same bits, each event
that changes what the walk computes drops the programs, and state handed
in by ``reset_state`` / ``load_state`` gives the JAX engine's output. The
walk that a card captures must make no host decision from device values
and pass no host array to a torch op; the last test holds the replayed
walks of the slice's presets to that on the CPU, where the card's capture
cannot be run.
"""

import collections
import os
import tempfile
import traceback

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import retrocapture_tpu as jax_pkg
import retrocapture_tpu_torch as torch_pkg
from retrocapture_tpu_torch import policy
from retrocapture_tpu_torch.runtime import engine as engine_module
from retrocapture_tpu_torch.runtime import replay as replay_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEEDBACK = os.path.join(REPO, "assets", "presets", "feedback-ghost.glslp")
SRC_HW = (48, 64)
VIEWPORT = (160, 120)
KEY = SRC_HW + VIEWPORT


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: torch's CPU thread pool only adds its start-up cost
    per operation (tens of milliseconds a call under a parallel test run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nv12(seed, b=2):
    h, w = SRC_HW
    return np.random.default_rng(seed).integers(0, 256, (b, h * 3 // 2, w), dtype=np.uint8)


def _engine(path=FEEDBACK, fmt="nv12", viewport=VIEWPORT):
    te = torch_pkg.Engine(viewport=viewport, device="cpu")
    assert te.load_preset(path), te.last_error
    te.set_input_format(fmt)
    return te


class _Uploads:
    """Counts host values that reach ``policy.to_device`` (numpy arrays,
    numpy or Python scalars, host tensors bound elsewhere)."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = policy.to_device

        def counting(x, device):
            if not (isinstance(x, torch.Tensor) and x.device == torch.device(device)):
                self.n += 1
            return real(x, device)

        monkeypatch.setattr(policy, "to_device", counting)


@pytest.mark.parametrize("output", ["u8", "f32"])
def test_second_apply_uploads_nothing_and_renders_the_same(monkeypatch, output):
    te = _engine()
    frames = torch.from_numpy(_nv12(1))
    uploads = _Uploads(monkeypatch)
    first = te.apply(frames, output=output)
    assert uploads.n > 0, "the first walk uploads its constants"
    (program,) = te._programs.values()
    assert program.walk.recorded and program.walk.tensors
    te.reset_state()  # the same state as the first apply's
    uploads.n = 0
    replayed = program.walk.uploads_replayed
    second = te.apply(frames, output=output)
    assert uploads.n == 0, f"{uploads.n} host values uploaded by a cached walk"
    assert program.walk.uploads_replayed - replayed == 2 * len(program.walk.tensors)  # two frames
    assert te._programs == {next(iter(te._programs)): program}
    torch.testing.assert_close(second, first, rtol=0, atol=0)


def test_plane_varyings_are_built_once_per_program(monkeypatch):
    """The rasterizer planes (43% of feedback-ghost's host time a frame on
    the card, PERF.md) come from the program after its first walk."""
    calls = []
    real = engine_module._plane_varyings
    monkeypatch.setattr(engine_module, "_plane_varyings", lambda *a: (calls.append(1), real(*a))[1])
    te = _engine()
    te.apply(torch.from_numpy(_nv12(2, 4)))
    te.apply(torch.from_numpy(_nv12(3, 4)))
    assert len(calls) == 1


def test_a_diverging_walk_raises():
    """A recorded program whose walk meets another host value raises (a
    host value that changed without a key change would be a fault)."""
    wp = policy.WalkProgram()
    with policy.walking(wp):
        a = policy.upload(np.arange(3, dtype=np.float32), "cpu")
    with policy.walking(wp):
        assert policy.upload(np.arange(3, dtype=np.float32), "cpu") is a
    with pytest.raises(RuntimeError, match="upload 0"):
        with policy.walking(wp):
            policy.upload(np.arange(3, dtype=np.float32) + 1, "cpu")
    with pytest.raises(RuntimeError, match="not recorded"):
        with policy.walking(wp):
            policy.upload(np.arange(3, dtype=np.float32), "cpu")
            policy.upload(np.zeros(2, np.float32), "cpu")
    with pytest.raises(RuntimeError, match="took 0 of 1"):
        with policy.walking(wp):
            pass


def test_upload_while_capturing_raises(monkeypatch):
    """A capture that meets an unrecorded upload raises before any copy
    (the card test repeats this inside a real capture)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="while a CUDA graph is captured"):
        policy.to_device(np.zeros(3, np.float32), "cuda")
    with pytest.raises(RuntimeError, match="while a CUDA graph is captured"):
        policy.upload(np.zeros(3, np.float32), torch.device("cuda", 0))
    wp = policy.WalkProgram()
    wp.recorded = True
    with pytest.raises(RuntimeError, match="not recorded"):
        with policy.walking(wp):
            policy.upload(np.zeros(3, np.float32), "cuda")


def _drops():
    """(what, event) pairs: each event must drop every kept program."""
    return [
        ("set_parameter (const)", lambda e: e.set_parameter("GHOST", 0.7)),
        ("set_param_mode", lambda e: e.set_param_mode("traced")),
        ("set_viewport", lambda e: e.set_viewport(128, 96)),
        ("set_max_shader_resolution", lambda e: e.set_max_shader_resolution(32, 24)),
        ("set_input_format", lambda e: e.set_input_format("nv12")),
        ("load_preset", lambda e: e.load_preset(FEEDBACK)),
        ("unload", lambda e: e.unload()),
    ]


@pytest.mark.parametrize("what,event", _drops(), ids=[w for w, _ in _drops()])
def test_each_drop_rebuilds(what, event):
    te = _engine()
    frames = torch.from_numpy(_nv12(4))
    te.apply(frames)
    (before,) = te._programs.values()
    event(te)
    assert te._programs == {}, what
    if te._program is None:
        return  # unload: passthrough, no program to build
    te.set_input_format("nv12")
    te.apply(frames)
    assert te._programs and all(p is not before for p in te._programs.values()), what
    assert all(p.walk.recorded for p in te._programs.values())


def test_a_lowering_failure_drops_the_programs(monkeypatch):
    te = _engine()
    frames = torch.from_numpy(_nv12(5))
    te.apply(frames)
    assert te._programs

    def broken(*a, **k):
        raise engine_module.GlslEvalError("broken on purpose")

    monkeypatch.setattr(engine_module, "_run_chain_impl", broken)
    te.reset_state()
    te.apply(frames)
    assert te._lowering_failed and te._programs == {}


@pytest.mark.parametrize("output", ["u8", "f32"])
def test_reset_and_load_state_after_a_cached_apply_match_jax(tmp_path, output):
    je = jax_pkg.Engine(viewport=VIEWPORT)
    te = _engine()
    assert je.load_preset(FEEDBACK)
    je.set_input_format("nv12")

    def both(seed):
        f = _nv12(seed)
        a = np.asarray(je.apply(f, output=output))
        b = te.apply(torch.from_numpy(f), output=output).numpy()
        np.testing.assert_array_equal(b, a)

    both(10)
    je.save_state(str(tmp_path / "jax"))
    te.save_state(str(tmp_path / "torch"))
    both(11)  # a cached walk
    je.reset_state()
    te.reset_state()
    both(12)  # from a fresh state, through the kept program
    (program,) = te._programs.values()
    assert program.walk.uploads_replayed > 0
    je.load_state(str(tmp_path / "torch.npz"))
    te.load_state(str(tmp_path / "jax.npz"))
    both(13)  # from the checkpoint of the other package
    assert int(te._states[KEY].frame_count) == 4 == int(np.asarray(je._states[KEY].frame_count))
    assert te._programs == {next(iter(te._programs)): program}


# -- the walk a card captures --------------------------------------------------

# Host synchronisations (a read of a device value by the host), and torch
# ops handed a host array (an implicit host->device copy on a card).
_SYNCS = {
    "aten._local_scalar_dense.default", "aten.nonzero.default", "aten.masked_select.default",
    "aten.repeat_interleave.Tensor", "aten._unique2.default", "aten.item.default", "aten.equal.default",
    "aten.is_nonzero.default",
}
# sinf32's bound check reads the host, on a CPU tensor only.
_CPU_ONLY = ("in sinf32",)


def _host_array(a):
    if isinstance(a, np.ndarray) and a.ndim > 0:
        return True
    if isinstance(a, (list, tuple)):
        return any(_host_array(x) for x in a)
    if isinstance(a, dict):
        return any(_host_array(x) for x in a.values())
    return False


class _HostWork(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.hits = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in _SYNCS:
            stack = "".join(traceback.format_stack(limit=14)[:-1])
            if not any(s in stack for s in _CPU_ONLY):
                self.hits[(str(func), stack)] += 1
        return func(*args, **(kwargs or {}))


class _HostArrays(TorchFunctionMode):
    def __init__(self, hits):
        super().__init__()
        self.hits = hits

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _host_array(args) or _host_array(kwargs):
            self.hits[("host array to " + getattr(func, "__name__", str(func)), "".join(traceback.format_stack(limit=10)[:-1]))] += 1
        return func(*args, **kwargs)


def _slice_presets(td):
    from _mattias_standin import write_standin as mattias
    from _ntsc_standin import write_chain as ntsc
    from _xbr_standin import write_standin as xbr

    h, w = SRC_HW
    return [
        ("feedback-ghost-nv12", FEEDBACK, "nv12", VIEWPORT, None),
        ("feedback-ghost-nv12 traced", FEEDBACK, "nv12", VIEWPORT, ("GHOST", 0.8)),
        ("xbr-lv2", xbr(td), "rgb", (192, 144), None),
        ("ntsc-320px", ntsc(td, 4 * w), "rgb", (256, 144), None),
        ("crt-mattias traced", mattias(td), "rgb", (256, 144), ("CURVATURE", 0.8)),
    ]


def test_replayed_walks_of_the_slice_do_no_host_work():
    with tempfile.TemporaryDirectory() as td:
        for name, path, fmt, viewport, param in _slice_presets(td):
            te = _engine(path, fmt, viewport)
            h, w = SRC_HW
            shape = (2, h * 3 // 2, w) if fmt == "nv12" else (2, h, w, 3)
            frames = torch.from_numpy(np.random.default_rng(6).integers(0, 256, shape, dtype=np.uint8))
            if param is not None:
                te.set_param_mode("traced")
            te.apply(frames)
            if param is not None:
                te.set_parameter(*param)
            (program,) = te._programs.values()
            replayed = program.walk.uploads_replayed
            sync = _HostWork()
            arrays = _HostArrays(sync.hits)
            with sync, arrays:
                # The walks alone: the blit runs outside a captured frame.
                te._run_batch(SRC_HW + viewport, frames, te._states[SRC_HW + viewport])
            assert not sync.hits, f"{name}: " + "\n".join(f"{f} x{n}\n{s}" for (f, s), n in sync.hits.items())
            assert program.walk.recorded and program.walk.uploads_replayed == replayed + 2 * len(program.walk.tensors), name
            assert te._effective_param_mode() == ("traced" if param else "const"), name


# -- the replay path over fixed buffers (runtime/replay.run_captured) ---------

HISTORY_GLSL = """#pragma parameter MIXW "Mix" 0.4 0.0 1.0 0.05

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
uniform sampler2D PrevTexture;
uniform sampler2D Prev3Texture;
uniform sampler2D Prev6Texture;
uniform int FrameCount;

#ifdef PARAMETER_UNIFORM
uniform float MIXW;
#else
#define MIXW 0.4
#endif

void main()
{
    vec4 c = texture2D(Texture, vTexCoord);
    vec4 p = texture2D(PrevTexture, vTexCoord);
    vec4 p3 = texture2D(Prev3Texture, vTexCoord);
    vec4 p6 = texture2D(Prev6Texture, vTexCoord);
    float t = fract(float(FrameCount) * 0.37);
    gl_FragColor = mix(c, 0.5 * p + 0.3 * p3 + 0.2 * p6, MIXW) * (0.8 + 0.2 * t);
}

#endif
"""

STATELESS_GLSL = HISTORY_GLSL.replace(
    "gl_FragColor = mix(c, 0.5 * p + 0.3 * p3 + 0.2 * p6, MIXW) * (0.8 + 0.2 * t);",
    "gl_FragColor = c * (MIXW + t);",
)


def _write(td, name, glsl):
    with open(os.path.join(td, name + ".glsl"), "w") as f:
        f.write(glsl)
    path = os.path.join(td, name + ".glslp")
    with open(path, "w") as f:
        f.write(f"shaders = 1\nshader0 = {name}.glsl\nfilter_linear0 = true\nscale_type0 = source\nscale0 = 2.0\n")
    return path


def _plain_run(prog, walk_fn, src_b, state, out_shape, temporal, make_state, stats, graph):
    """``replay.run_captured`` as a plain walk: each frame's chain with the
    state threaded through it, no program and no fixed buffers (the
    reference's frame loop, engine.py:838-864: FrameCount and Time advance
    per frame in a temporal chain, fc+i and Time + 0.016 i in a stateless
    one)."""
    dt = np.float32(0.016)
    nb = src_b.shape[0]
    hist, fb, fc, tm = state.history, state.feedback, state.frame_count, state.time
    outs = []
    if temporal:
        for i in range(nb):
            out, hist, fb = walk_fn(src_b[i], hist, fb, fc, tm)
            outs.append(out)
            fc, tm = fc + 1, tm + dt
    else:
        fcs = fc + torch.arange(nb, dtype=torch.int32)
        tms = tm + dt * torch.arange(nb, dtype=torch.float32)
        for i in range(nb):
            outs.append(walk_fn(src_b[i], hist, fb, fcs[i], tms[i])[0])
        fc, tm = fc + nb, tm + dt * np.float32(nb)
    return torch.stack(outs), make_state(hist, fb, fc, tm)


@pytest.mark.parametrize("output", ["u8", "f32"])
@pytest.mark.parametrize("which", ["feedback", "history", "stateless"])
def test_replay_path_equals_the_walk(tmp_path, monkeypatch, which, output):
    """The replay path over fixed buffers (ring rotation and feedback by
    copies, FrameCount and Time advanced in the captured frame or set per
    frame: the code a card captures, run here without a graph) renders the
    bits of the plain walk, across set_parameter in traced mode,
    set_viewport, reset_state, load_state and apply_streams."""
    h, w = SRC_HW
    if which == "feedback":
        path, fmt, name = FEEDBACK, "nv12", "GHOST"
        shape = (3, h * 3 // 2, w)
    else:
        path = _write(str(tmp_path), which, HISTORY_GLSL if which == "history" else STATELESS_GLSL)
        fmt, name, shape = "rgb", "MIXW", (3, h, w, 3)
    rp, wk = _engine(path, fmt), _engine(path, fmt)
    for e in (rp, wk):
        e.set_param_mode("traced")
    rng = np.random.default_rng(40)

    def plain(fn, *args):
        with monkeypatch.context() as mp:
            mp.setattr(replay_module, "run_captured", _plain_run)
            return fn(*args)

    def both(step):
        f = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
        a = rp.apply(f, output=output)
        b = plain(wk.apply, f, output)
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"{which} {output}: {step}")

    both("first apply (walk + capture)")
    both("replay")
    for e in (rp, wk):
        assert e.set_parameter(name, 0.9)
    both("set_parameter")
    for e in (rp, wk):
        e.save_state(str(tmp_path / f"s{id(e)}"))
    both("after save")
    for e in (rp, wk):
        e.reset_state()
    both("reset_state")
    for e in (rp, wk):
        e.load_state(str(tmp_path / f"s{id(e)}.npz"))
    both("load_state")
    streams = torch.from_numpy(rng.integers(0, 256, (2,) + shape, dtype=np.uint8))
    if fmt == "rgb":
        torch.testing.assert_close(rp.apply_streams(streams), plain(wk.apply_streams, streams), rtol=0, atol=0)
    both("after apply_streams")
    for e in (rp, wk):
        e.set_viewport(96, 80)
    both("set_viewport")
    both("replay at the new viewport")
    key = SRC_HW + (96, 80)
    assert int(rp._states[key].frame_count) == int(wk._states[key].frame_count) == 6
    (program,) = rp._programs.values()
    assert program.captured and program.walk.recorded
    assert wk._programs and not any(p.captured or p.walk.recorded for p in wk._programs.values())
