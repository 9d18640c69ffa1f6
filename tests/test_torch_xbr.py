"""The xbr-lv2 hand kernel of the port (graph/kernels.py and
ops/cuda/xbr_epilogue.py) against the JAX package's, piece by piece and
through both engines, on the CPU. The JAX side runs under
``RCTPU_KERNELS=interpret`` (its Pallas epilogue in interpret mode).

1. The FMA repair. ``jax.jit`` contracts ``a*b + c`` into one rounding
   (XLA's CPU code): in ``lum()``, ``x1*w1`` is rounded and ``x0*w0`` and
   ``x2*w2`` are contracted into the running sum, and each mix ``a + (b -
   a) * m`` is contracted. The port calls ``policy.fma32`` there; each is
   held bit-equal to the jitted reference. Measured: eager (uncontracted)
   ``lum`` differs in ~19% of values, the uncontracted mix in 6-8% of
   epilogue values, each by 1 ulp, enough to flip an edge flag or the
   final ``c_df`` select.
2. ``_xbr_axis_maps`` equal to the reference's, element for element, at
   the geometries of tests/test_kernels_xbr.py.
3. ``xbr_epilogue_plain`` against ``xbr_epilogue(interpret=True)`` on
   random S (colours integers 0..255, codes 0..31) at x ratios 2, 3 and
   6: bit-equal (measured: bit-equal).
4. The front section's S inside both engines: bit-equal for u8 and f32
   input frames, small_details 0 and 1 (measured: bit-equal). XLA folds
   ``(k * f32(1/255)) * 255`` of the u8 chain input into the level k;
   the port rounds to the level for a texture on the k/255 grid.
5. The slice: a stand-in ``xbr-lv2.glsl`` (tests/_xbr_standin.py)
   through both engines, 60x80 RGB -> 480x270 (y ratio 4.5, where the
   f32 row flips of the exact y gathers show), u8 and f32 output, batch 1
   and 4, small_details 0 and 1, with the hand kernel engaged in both.
   Tolerance: u8 at most 1 step in at most 1e-3 of values, f32 at most
   1e-6 outside 1e-3 of values; measured: bit-equal in every case. A
   ``filter_linear0 = true`` preset is declined by both kernels, and the
   evaluators' passthrough outputs agree within the same tolerance.
6. The axis maps kept per geometry: the port builds ``_xbr_axis_maps``
   once per (pass, source size, output size) while parameters and viewport
   stand. At batch 4 the slice stays bit-equal to the JAX engine with the
   maps from the cache, after ``set_viewport`` to another size and back,
   and after ``set_parameter("small_details", 1)``; the kept maps are the
   arrays a fresh build gives; a vertex stage that reads FrameCount is
   rebuilt per frame. Tolerance: bit-equal.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import retrocapture_tpu as jax_pkg
import retrocapture_tpu_torch as torch_pkg
from _xbr_standin import write_standin
from retrocapture_tpu.graph import kernels as jk
from retrocapture_tpu.ops.pallas import xbr_epilogue as jxe
from retrocapture_tpu_torch.graph import kernels as tk
from retrocapture_tpu_torch import policy
from retrocapture_tpu_torch.ops.cuda import xbr_epilogue as xe
from retrocapture_tpu_torch.policy import fma32

f32 = np.float32
NAME = "xbr-lv2.glsl"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _u8_grid(rng, shape):
    return (rng.integers(0, 256, shape).astype(f32) * f32(1.0 / 255.0)).astype(f32)


# -- 1. the FMA repair ------------------------------------------------------


@pytest.mark.parametrize("weights", ["rgbw", "y"])
def test_lum_contracted_as_jitted_reference(weights):
    """The reference's lum() (kernels.py:403-404) and lumY (:433-434)
    jitted over taps on the u8 grid and off it."""
    rng = np.random.default_rng(1)
    x = np.concatenate([_u8_grid(rng, (1 << 16, 3)), rng.random((1 << 16, 3), f32)])
    w = jk._XBR_RGBW if weights == "rgbw" else np.array([0.2126, 0.7152, 0.0722], f32) * f32(48.0)

    def lum(v):
        r = jnp.asarray(w)
        return v[..., 0] * r[0] + v[..., 1] * r[1] + v[..., 2] * r[2]

    want = np.asarray(jax.jit(lum)(x))
    np.testing.assert_array_equal(tk._xbr_lum(_t(x), w).numpy(), want)
    eager = (x[:, 0] * w[0] + x[:, 1] * w[1]).astype(f32) + x[:, 2] * w[2]
    assert (eager != want).mean() > 0.05


def test_mix_contracted_as_jitted_reference():
    """mixc ``a + (b - a) * m`` (xbr_epilogue.py:105-106) jitted, with a
    fractional m: one rounding, as fma32."""
    rng = np.random.default_rng(2)
    a, b = (_u8_grid(rng, 1 << 16) for _ in range(2))
    m = rng.random(1 << 16, f32)
    want = np.asarray(jax.jit(lambda p, q, r: p + (q - p) * r)(a, b, m))
    np.testing.assert_array_equal(fma32(_t(b - a), _t(m), _t(a)).numpy(), want)
    assert ((a + (b - a) * m).astype(f32) != want).mean() > 0.01


# -- shared: the stand-in and spies on both engines ---------------------------


@pytest.fixture(scope="module")
def standin():
    with tempfile.TemporaryDirectory() as td:
        yield write_standin(td), write_standin(td, filter_linear=True)


def _spy(registry, kernels, maps=None):
    """Wrap registry[NAME]: record whether each call engaged (returned a
    frame) and, with ``maps``, the kernel's axis maps."""
    fn = registry[NAME]
    calls = []

    def wrapped(ctx, sh):
        if maps is not None:
            tex = ctx.input_binding.tex
            ow, oh = ctx.out_size
            maps.append(kernels._xbr_axis_maps(ctx, ow, oh, int(tex.shape[1]), int(tex.shape[0])))
        out = fn(ctx, sh)
        calls.append(out is not None)
        return out

    return wrapped, calls


def _jax_run(path, viewport, frames, output, small, monkeypatch, maps=None):
    monkeypatch.setenv("RCTPU_KERNELS", "interpret")
    wrapped, calls = _spy(jk._REGISTRY, jk, maps)
    monkeypatch.setitem(jk._REGISTRY, NAME, wrapped)
    e = jax_pkg.Engine(viewport=viewport)
    assert e.load_preset(path), e.last_error
    assert e.set_parameter("small_details", small)
    out = np.asarray(e.apply(frames, output=output))
    assert e.shader_active is True and e.last_error is None
    return out, calls


def _port_run(path, viewport, frames, output, small, monkeypatch, maps=None):
    wrapped, calls = _spy(tk._REGISTRY, tk, maps)
    monkeypatch.setitem(tk._REGISTRY, NAME, wrapped)
    e = torch_pkg.Engine(viewport=viewport, device="cpu")
    assert e.load_preset(path), e.last_error
    assert e.set_parameter("small_details", small)
    out = e.apply(_t(frames), output=output)
    assert e.shader_active is True and e.last_error is None
    return out.numpy(), calls


def _frames(seed, n, hw, dtype="u8"):
    rng = np.random.default_rng(seed)
    if dtype == "u8":
        return rng.integers(0, 256, (n,) + hw + (3,), dtype=np.uint8)
    return rng.random((n,) + hw + (3,), f32)


# -- 2. the axis maps ---------------------------------------------------------

MAP_GEOMETRIES = [  # tests/test_kernels_xbr.py:17-22 and :70-72
    (48, 64, 256, 144),
    (60, 80, 480, 270),
    (48, 64, 384, 216),
    (30, 40, 240, 135),
    (48, 64, 384, 288),
    (40, 64, 128, 120),
]


@pytest.mark.parametrize("h,w,vw,vh", MAP_GEOMETRIES)
def test_axis_maps_equal_reference(standin, monkeypatch, h, w, vw, vh):
    frames = _frames(3, 1, (h, w))
    jmaps, tmaps = [], []
    _, jcalls = _jax_run(standin[0], (vw, vh), frames, "u8", 0.0, monkeypatch, jmaps)
    _, tcalls = _port_run(standin[0], (vw, vh), frames, "u8", 0.0, monkeypatch, tmaps)
    assert jcalls and all(jcalls) and tcalls == [True]
    ref, got = jmaps[0], tmaps[0]
    assert ref is not None and got is not None
    for i in (0, 1, 3, 4):  # bx, fpx, by, fpy
        assert got[i].dtype == ref[i].dtype
        np.testing.assert_array_equal(got[i], ref[i])
    for i in (2, 5):  # tx, ty
        assert sorted(got[i]) == sorted(ref[i]) == [-2, -1, 0, 1, 2]
        for k in ref[i]:
            np.testing.assert_array_equal(got[i][k], ref[i][k])


# -- 3. the epilogue ----------------------------------------------------------


@pytest.mark.parametrize("w,r,oh", [(64, 2, 48), (43, 3, 40), (40, 6, 36)])
def test_epilogue_plain_equals_pallas_interpret(w, r, oh):
    """x ratios of 2 or more: where the reference's 128-lane window
    holds (xbr_epilogue.py:46-51)."""
    rng = np.random.default_rng(w * r)
    ow = w * r
    S = np.concatenate(
        [rng.integers(0, 256, (2, 15, oh, w)), rng.integers(0, 32, (2, 4, oh, w))], axis=1
    ).astype(f32)
    bx = np.repeat(np.arange(w), r).astype(np.int32)
    fpx = ((np.arange(ow) + 0.5) / ow * w % 1.0).astype(f32)
    fpy = rng.random(oh, f32)
    before = xe.LAUNCHES
    got = xe.xbr_epilogue(_t(S), bx, fpx, fpy).numpy()
    assert xe.LAUNCHES == before  # the CPU takes the plain version
    assert got.shape == (2, oh, ow, 4) and got.dtype == np.float32
    for b in range(2):
        want = np.asarray(jxe.xbr_epilogue(jnp.asarray(S[b]), bx, fpx, fpy, interpret=True))
        np.testing.assert_array_equal(got[b], want)
    assert (got[..., 3] == 1).all()


def test_epilogue_checks_its_arguments():
    S = torch.zeros((1, 19, 4, 8))
    bx, fp = np.arange(16) // 2, np.zeros(16, f32)
    with pytest.raises(TypeError):
        xe.xbr_epilogue(S.double(), bx, fp, np.zeros(4, f32))
    with pytest.raises(ValueError):
        xe.xbr_epilogue(S[:, :18], bx, fp, np.zeros(4, f32))
    with pytest.raises(ValueError):
        xe.xbr_epilogue(S, bx, fp, np.zeros(5, f32))
    with pytest.raises(ValueError):
        xe.xbr_epilogue(S, bx + 1, fp, np.zeros(4, f32))
    with pytest.raises(RuntimeError):
        xe.xbr_epilogue(S.to("meta"), bx, fp, np.zeros(4, f32))


# -- 4. the front section inside both engines ---------------------------------


@pytest.mark.parametrize("small", [0.0, 1.0])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_front_section_S_equals_reference(standin, monkeypatch, dtype, small):
    jS, tS = [], []
    orig_j, orig_t = jxe.xbr_epilogue, xe.xbr_epilogue

    def jspy(S, bx, fpx, fpy, interpret=False):
        jax.debug.callback(lambda s: jS.append(np.asarray(s)), S)
        return orig_j(S, bx, fpx, fpy, interpret=interpret)

    def tspy(S, *maps):
        # The stateless walk is vmapped over the batch: S is one frame of
        # the whole batch's tensor.
        whole = policy._whole_batch(S)
        tS.append(whole.reshape((-1,) + tuple(S.shape[1:]))[0].numpy().copy())
        return orig_t(S, *maps)

    monkeypatch.setattr(jxe, "xbr_epilogue", jspy)
    monkeypatch.setattr(xe, "xbr_epilogue", tspy)
    frames = _frames(4, 1, (60, 80), dtype)
    _jax_run(standin[0], (480, 270), frames, "u8", small, monkeypatch)
    _port_run(standin[0], (480, 270), frames, "u8", small, monkeypatch)
    assert len(jS) == len(tS) == 1
    assert tS[0].shape == (19, 270, 80)
    np.testing.assert_array_equal(tS[0], jS[0])
    codes = tS[0][15:]
    assert (codes == np.round(codes)).all() and codes.min() >= 0 and codes.max() <= 31 and codes.max() > 0


# -- 5. the slice -------------------------------------------------------------

SRC_HW = (60, 80)
VIEWPORT = (480, 270)


def _close(a, b, output):
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    if output == "u8":
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1, f"max {d.max()} u8 steps"
        assert (d != 0).mean() <= 1e-3, f"{(d != 0).mean():.2e} of values differ"
    else:
        assert np.isfinite(b).all()
        d = np.abs(a.astype(np.float64) - b)
        assert (d > 1e-6).mean() <= 1e-3, f"{(d > 1e-6).mean():.2e} of values beyond 1e-6"


@pytest.mark.parametrize("small", [0.0, 1.0])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("output", ["u8", "f32"])
def test_slice_matches_jax_engine(standin, monkeypatch, output, batch, small):
    frames = _frames(10 + batch, batch, SRC_HW)
    want, jcalls = _jax_run(standin[0], VIEWPORT, frames, output, small, monkeypatch)
    got, tcalls = _port_run(standin[0], VIEWPORT, frames, output, small, monkeypatch)
    assert jcalls and all(jcalls), "the reference's xbr-lv2 kernel did not engage"
    # One walk of the whole batch (the stateless branch).
    assert len(tcalls) == 1 and all(tcalls), "the port's xbr-lv2 kernel did not engage"
    assert got.shape == (batch, VIEWPORT[1], VIEWPORT[0], 3)
    _close(want, got, output)
    # Not the passthrough: xbr blends the NEAREST upscale at edges.
    ys = (np.arange(VIEWPORT[1]) * SRC_HW[0]) // VIEWPORT[1]
    xs = (np.arange(VIEWPORT[0]) * SRC_HW[1]) // VIEWPORT[0]
    nearest = frames[:, ys][:, :, xs]
    if output == "u8":
        assert (got != nearest).mean() > 0.05


def test_filter_linear_preset_declined_by_both(standin, monkeypatch):
    frames = _frames(20, 2, SRC_HW)
    want, jcalls = _jax_run(standin[1], VIEWPORT, frames, "u8", 0.0, monkeypatch)
    got, tcalls = _port_run(standin[1], VIEWPORT, frames, "u8", 0.0, monkeypatch)
    assert jcalls and not any(jcalls)
    assert tcalls == [False]  # one walk of the batch
    _close(want, got, "u8")


def test_registry_entry():
    assert tk.find_kernel("/any/dir/xbr-lv2.glsl") is tk._xbr_lv2_kernel


# -- 6. the axis maps kept per geometry ---------------------------------------


def _count_map_builds(monkeypatch):
    """Count the port's calls of _xbr_axis_maps (the per-geometry build)."""
    real = tk._xbr_axis_maps
    builds = []

    def counted(*a, **k):
        builds.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tk, "_xbr_axis_maps", counted)
    return builds


def _port_engine(path, viewport):
    e = torch_pkg.Engine(viewport=viewport, device="cpu")
    assert e.load_preset(path), e.last_error
    return e


def _kept(e):
    """What the xbr entry keeps, over the engine's programs: {key: value}."""
    return {k: v for p in e._programs.values() for k, v in p.walk.tables.items() if k[0] == "xbr-lv2"}


def _apply(e, frames):
    out = e.apply(_t(frames), output="u8").numpy()
    assert e.shader_active is True and e.last_error is None
    return out


def test_slice_bit_equal_to_jax_with_cached_maps(standin, monkeypatch):
    frames = _frames(31, 4, SRC_HW)
    other = (320, 240)
    want = {
        (vp, small): _jax_run(standin[0], vp, frames, "u8", small, monkeypatch)[0]
        for vp, small in ((VIEWPORT, 0.0), (other, 0.0), (VIEWPORT, 1.0))
    }
    builds = _count_map_builds(monkeypatch)
    e = _port_engine(standin[0], VIEWPORT)
    np.testing.assert_array_equal(_apply(e, frames), want[VIEWPORT, 0.0])
    assert len(builds) == 1  # 4 frames, one build
    np.testing.assert_array_equal(_apply(e, frames), want[VIEWPORT, 0.0])
    assert len(builds) == 1  # a second apply: from the cache
    e.set_viewport(*other)
    assert _kept(e) == {}
    np.testing.assert_array_equal(_apply(e, frames), want[other, 0.0])
    e.set_viewport(*VIEWPORT)
    np.testing.assert_array_equal(_apply(e, frames), want[VIEWPORT, 0.0])
    assert len(builds) == 3
    assert e.set_parameter("small_details", 1.0)
    assert _kept(e) == {}
    np.testing.assert_array_equal(_apply(e, frames), want[VIEWPORT, 1.0])
    assert len(builds) == 4
    assert (want[VIEWPORT, 1.0] != want[VIEWPORT, 0.0]).any()
    # Another source size is another key; both stay.
    _apply(e, _frames(32, 1, (48, 64)))
    assert len(builds) == 5 and len(_kept(e)) == 2
    # The cache goes with the program.
    assert e.load_preset(standin[0]) and e._programs == {}
    e.unload()
    assert e._program is None


def test_cached_maps_are_the_fresh_build(standin, monkeypatch):
    """What the cache holds equals what _xbr_axis_maps gives anew."""
    fresh = []
    wrapped, _ = _spy(tk._REGISTRY, tk, fresh)
    monkeypatch.setitem(tk._REGISTRY, NAME, wrapped)
    e = _port_engine(standin[0], VIEWPORT)
    _apply(e, _frames(33, 2, SRC_HW))
    (key, (gathers, maps)), = _kept(e).items()
    assert key[:6] == ("xbr-lv2", 0, SRC_HW[1], SRC_HW[0], VIEWPORT[0], VIEWPORT[1])
    bx, fpx, _, _, fpy, ty = fresh[-1]
    np.testing.assert_array_equal(maps.bx.numpy(), np.clip(bx, 0, SRC_HW[1] - 1))
    np.testing.assert_array_equal(maps.fpx.numpy(), fpx)
    np.testing.assert_array_equal(maps.fpy.numpy(), fpy)
    for k in (-2, -1, 0, 1, 2):
        np.testing.assert_array_equal(gathers[1][k].numpy(), np.clip(ty[k], 0, SRC_HW[0] - 1))


def test_vertex_stage_reading_frame_count_is_not_cached(standin, monkeypatch, tmp_path):
    """A vertex stage that reads FrameCount: its varyings are frame state
    (the corner run sees a tensor, so the hand kernel declines in both
    engines), the geometry is derived anew for every frame and nothing is
    kept. The stand-in's own stage with caching switched off gives the
    cached run's bytes."""
    frames = _frames(34, 3, SRC_HW)
    builds = _count_map_builds(monkeypatch)
    e = _port_engine(standin[0], VIEWPORT)
    assert e._program.passes[0].vertex_static is True
    cached = _apply(e, frames)
    assert len(builds) == 1 and len(_kept(e)) == 1
    plain = _port_engine(standin[0], VIEWPORT)
    plain._program.passes[0].vertex_static = False
    np.testing.assert_array_equal(_apply(plain, frames), cached)
    assert len(builds) == 1 + 1 and _kept(plain) == {}  # one walk of the 3 frames

    path = write_standin(str(tmp_path), reads_frame_count=True)
    moving = _port_engine(path, VIEWPORT)
    assert moving._program.passes[0].vertex_static is False
    got = _apply(moving, frames)
    assert len(builds) == 2 + 1  # derived for each walk
    assert _kept(moving) == {}
    want, jcalls = _jax_run(path, VIEWPORT, frames, "u8", 0.0, monkeypatch)
    assert jcalls and not any(jcalls)
    _close(want, got, "u8")


@pytest.mark.parametrize(
    "vertex,static",
    [
        ("uniform int FrameCount; void main() { gl_Position = MVPMatrix * VertexCoord; TEX0 = TexCoord.xy; }", True),
        ("uniform int FrameCount; void main() { gl_Position = MVPMatrix * VertexCoord; "
         "TEX0 = TexCoord.xy + vec2(float(FrameCount)); }", False),
        ("uniform int FrameCount; float t() { return float(FrameCount); } void main() { "
         "gl_Position = MVPMatrix * VertexCoord; TEX0 = TexCoord.xy * t(); }", False),
        ("uniform sampler2D Texture; void main() { gl_Position = MVPMatrix * VertexCoord; "
         "TEX0 = texture2D(Texture, TexCoord.xy).xy; }", False),
    ],
    ids=["declared-only", "read-in-main", "read-in-helper", "sampler"],
)
def test_vertex_is_static_reads_the_stage(tmp_path, vertex, static):
    src = (
        "#if defined(VERTEX)\nattribute vec4 VertexCoord; attribute vec4 TexCoord; varying vec2 TEX0; "
        f"uniform mat4 MVPMatrix; {vertex}\n"
        "#elif defined(FRAGMENT)\nvarying vec2 TEX0; uniform sampler2D Texture; "
        "void main() { gl_FragColor = texture2D(Texture, TEX0); }\n#endif\n"
    )
    (tmp_path / "probe.glsl").write_text(src)
    (tmp_path / "probe.glslp").write_text("shaders = 1\nshader0 = probe.glsl\n")
    e = torch_pkg.Engine(viewport=(32, 24), device="cpu")
    assert e.load_preset(str(tmp_path / "probe.glslp")), e.last_error
    assert e._program.passes[0].vertex_static is static


# -- 7. the epilogue's prepared maps and tile plan ----------------------------

TILE_PLANS = [
    pytest.param(320, 1920, "nearest", id="r6-main"),
    pytest.param(64, 250, "nearest", id="non-integer"),
    pytest.param(20, 45, "nearest", id="below-a-tile"),
    pytest.param(300, 700, "random", id="non-monotone"),
    pytest.param(3000, 700, "random", id="scattered"),
    pytest.param(1920, 640, "nearest", id="downscale"),
]


@pytest.mark.parametrize("w,ow,kind", TILE_PLANS)
def test_tile_plan_covers_bx_within_the_budget(w, ow, kind):
    if kind == "random":
        bx = np.random.default_rng(w).integers(0, w, ow)
    else:
        bx = (np.arange(ow) * w) // ow
    tile_px, rows, max_n, lo, n = xe._tile_plan(bx.astype(np.int64))
    assert tile_px % 32 == 0 and 32 <= tile_px <= 256 and 1 <= rows <= xe._ROWS_MAX
    assert len(lo) == len(n) == -(-ow // tile_px) and max_n == n.max()
    assert rows * max_n * xe._TEXEL_BYTES <= xe._SHARED_BUDGET
    for t in range(len(lo)):
        cols = bx[t * tile_px : (t + 1) * tile_px]
        assert lo[t] == cols.min()
        span = cols.max() - cols.min() + 1
        assert n[t] == (span if span * xe._TEXEL_BYTES <= xe._SHARED_BUDGET else 0)
    if kind == "nearest" and ow >= w:
        assert (n > 0).all()
    if w == 3000:
        assert (n == 0).all() and max_n == 0


def test_prepared_maps_equal_the_three_arrays():
    rng = np.random.default_rng(5)
    w, ow, oh = 40, 240, 36
    S = _t(np.concatenate([rng.integers(0, 256, (2, 15, oh, w)), rng.integers(0, 32, (2, 4, oh, w))], 1).astype(f32))
    bx = np.repeat(np.arange(w), 6).astype(np.int32)
    fpx, fpy = rng.random(ow, f32), rng.random(oh, f32)
    maps = xe.prepare_maps(bx, fpx, fpy, w, "cpu")
    assert maps.tile_lo is None and maps.general_tiles == 0  # no tile plan off the card
    np.testing.assert_array_equal(maps.bx.numpy(), bx)
    assert torch.equal(xe.xbr_epilogue(S, maps), xe.xbr_epilogue(S, bx, fpx, fpy))
    with pytest.raises(ValueError):
        xe.xbr_epilogue(S[..., :39], maps)  # maps of another width
    with pytest.raises(ValueError):
        xe.xbr_epilogue(S[:, :, :35], maps)  # and of another height
    with pytest.raises(ValueError):
        xe.prepare_maps(bx.astype(f32), fpx, fpy, w, "cpu")
    with pytest.raises(ValueError):
        xe.prepare_maps(bx, fpx[:-1], fpy, w, "cpu")
    with pytest.raises(RuntimeError):
        xe.prepare_maps(bx, fpx, fpy, w, "meta")
    before = xe.general_blocks()
    assert xe.general_blocks(reset=True) == before and xe.general_blocks() == 0
