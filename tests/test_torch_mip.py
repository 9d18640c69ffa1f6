"""Mip sampling of the port (ops/sampling.py: the box pyramid,
sample2d_affine_mip, sample2d_warped_mip, sample2d_lod; the mip branches of
frontend/interp.py) against the JAX package's, function by function and
through both engines on ``mipmap_input`` presets.

The reference functions are compared as ``jax.jit`` compiles them, since
that is how the engine runs them: XLA's CPU code contracts the level blend
``s0 + (s1 - s0) * frac`` and the running ``out + s * wt`` into FMAs, which
the port repeats with ``fma32``.

Tolerances.
* NEAREST taps: bit-equal (index selects and gathers only).
* LINEAR affine taps: each level's sample goes through the separable f32
  matmul, within 1 ulp (1.2e-7 on [0, 1]) of XLA's dot; two of them blended
  stay within 2.4e-7.
* LINEAR warped taps: bit-equal (the port's gather contracts the tap
  position and the lerps as the reference's jitted gather does), and so is
  ``sample2d_lod`` on a warped grid, its blend included.
* Per-pixel LOD: ``log2(rho)`` is XLA's inline polynomial ``log`` times
  ``f32(1/ln 2)`` in the jitted reference, which ``policy.log2f32`` repeats
  op by op (its multiply-adds as FMAs where the compiled code fuses them):
  bit-equal to ``jax.jit(jnp.log2)`` over normal, subnormal and special
  input, and ``sample2d_warped_mip`` bit-equal to the jitted reference
  (torch's ``log2`` differed by an ulp in 0.7% to 9.7% of values).
* Through the engines: u8 within 1 step in at most 0.1% of values, f32
  within 1e-6 (the gate of tests/test_torch_engine.py). The 0.25x glow
  pass renders 12x16 texels that the blit stretches tenfold, so one
  RGBA8 code flipped in that pass (a LINEAR matmul tap 1 ulp apart)
  shows in ~70 output values: measured 1.4e-3 of u8 values, budget 5e-3.
"""

import functools
import tempfile

import jax
import numpy as np
import pytest
import torch

import retrocapture_tpu as jax_pkg
import retrocapture_tpu_torch as torch_pkg
from _presets import write_mip_presets
from retrocapture_tpu.ops import sampling as js
from retrocapture_tpu_torch.ops import sampling as ts
from retrocapture_tpu_torch.policy import log2f32
from test_torch_engine import _close

WRAPS = ["clamp_to_edge", "clamp_to_border", "repeat", "mirrored_repeat"]
LODS = [0.0, 0.5, 1.0, 2.3, 9.0]  # 9.0 is above max_lod of every texture here
f32 = np.float32


def _tex(seed, h=37, w=53, c=4):
    return np.random.default_rng(seed).random((h, w, c), f32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_close(got, want, linear, tol=2.4e-7):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if not linear:
        np.testing.assert_array_equal(got, want)
    else:
        d = np.abs(got.astype(np.float64) - want)
        assert d.max() <= tol, d.max()


@pytest.mark.parametrize("hw", [(37, 53), (16, 32), (1, 9)])
def test_box_downsample_bit_equal(hw):
    tex = _tex(1, *hw)
    level_j, level_t = tex, _t(tex)
    for _ in range(4):
        level_j = np.asarray(jax.jit(js._box_downsample)(level_j))
        level_t = ts._box_downsample(level_t)
        np.testing.assert_array_equal(level_t.numpy(), level_j)


@pytest.mark.parametrize("lod", LODS)
@pytest.mark.parametrize("wrap", WRAPS)
@pytest.mark.parametrize("linear", [False, True], ids=["nearest", "linear"])
def test_affine_mip_matches_jitted_reference(linear, wrap, lod):
    tex = _tex(2)
    h, w, _ = tex.shape
    oh, ow = 20, 24
    # rho = max(|a_u| * w, |a_v| * h) = 2 ** lod, on the u axis.
    u_aff = (2.0 ** lod / w, 0.0, 0.013)
    v_aff = (0.0, 0.9 * 2.0 ** lod / h, -0.02)
    kw = dict(filter_linear=linear, wrap_mode=wrap)
    want = jax.jit(functools.partial(js.sample2d_affine_mip, u_aff=u_aff, v_aff=v_aff, oh=oh, ow=ow, **kw))(tex)
    got = ts.sample2d_affine_mip(_t(tex), u_aff, v_aff, oh, ow, **kw)
    _assert_close(got, want, linear)


def _warp(oh, ow, zoom, seed=0):
    """A curvature warp whose footprint grows outward: rho crosses
    several powers of two."""
    y = (np.arange(oh, dtype=f32) + f32(0.5)) / f32(oh) - f32(0.5)
    x = (np.arange(ow, dtype=f32) + f32(0.5)) / f32(ow) - f32(0.5)
    cx, cy = np.meshgrid(x, y)
    k = f32(zoom) * (f32(1.0) + f32(6.0) * (cx * cx + cy * cy))
    return (f32(0.5) + cx * k).astype(f32), (f32(0.5) + cy * k).astype(f32)


@pytest.mark.parametrize("lod", LODS)
@pytest.mark.parametrize("wrap", WRAPS)
@pytest.mark.parametrize("linear", [False, True], ids=["nearest", "linear"])
def test_lod_matches_jitted_reference(linear, wrap, lod):
    tex = _tex(3)
    u, v = _warp(18, 22, 1.7)
    kw = dict(filter_linear=linear, wrap_mode=wrap)
    want = jax.jit(lambda t, a, b: js.sample2d_lod(t, a, b, lod, **kw))(tex, u, v)
    got = ts.sample2d_lod(_t(tex), _t(u), _t(v), lod, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lod", [0.5, 2.3])
def test_lod_on_a_concrete_separable_grid(lod):
    """numpy coordinates (a constant grid): the separable lowering, as in
    the reference."""
    tex = _tex(4)
    x = ((np.arange(24, dtype=f32) + f32(0.5)) / f32(24)).astype(f32)
    y = ((np.arange(20, dtype=f32) + f32(0.5)) / f32(20)).astype(f32)
    u, v = np.broadcast_to(x[None, :], (20, 24)), np.broadcast_to(y[:, None], (20, 24))
    want = jax.jit(lambda t: js.sample2d_lod(t, u, v, lod, filter_linear=True))(tex)
    got = ts.sample2d_lod(_t(tex), u, v, lod, filter_linear=True)
    _assert_close(got, want, True)


@pytest.mark.parametrize("hw", [(37, 53), (48, 64)])
@pytest.mark.parametrize("wrap", WRAPS)
@pytest.mark.parametrize("linear", [False, True], ids=["nearest", "linear"])
def test_warped_mip_within_the_lod_budget(linear, wrap, hw):
    """Bit-equal, the per-pixel LOD included (``policy.log2f32``)."""
    tex = _tex(5, *hw)
    u, v = _warp(60, 80, 3.0)
    # The warp's footprint crosses levels: rho from under 2 to over 8.
    rho = np.maximum(np.abs(np.diff(u, axis=1)).max() * hw[1], np.abs(np.diff(v, axis=0)).max() * hw[0])
    assert rho > 8 and np.abs(np.diff(u, axis=1)).min() * hw[1] < 2.5
    kw = dict(filter_linear=linear, wrap_mode=wrap)
    want = np.asarray(jax.jit(lambda t, a, b: js.sample2d_warped_mip(t, a, b, **kw))(tex, u, v))
    got = ts.sample2d_warped_mip(_t(tex), _t(u), _t(v), **kw).numpy()
    assert got.shape == want.shape == (60, 80, 4)
    np.testing.assert_array_equal(got, want)


def test_log2f32_bit_equal_to_jitted_log2():
    """Random magnitudes over the whole f32 range, every power of two and
    its neighbours, subnormals, zeros, infinities, NaN and negatives."""
    rng = np.random.default_rng(7)
    p2 = (2.0 ** np.arange(-149, 128)).astype(f32)
    x = np.concatenate([
        rng.integers(0, 0x7F800000, 1 << 18).astype(np.int32).view(f32),
        (rng.random(1 << 18, f32) * 20).astype(f32),
        p2, np.nextafter(p2, f32(np.inf)), np.nextafter(p2, f32(0)),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, -1e-40, 1e-12], f32),
    ])
    want = np.asarray(jax.jit(jax.numpy.log2)(x))
    got = log2f32(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (torch.log2(_t(x)).numpy() != want).mean() > 0.05  # torch's own log2 is another function


def test_warped_mip_blends_levels():
    """Not level 0 alone: a minifying warp averages fine texture away."""
    tex = _tex(6, 64, 64)
    u, v = _warp(40, 40, 6.0)
    mip = ts.sample2d_warped_mip(_t(tex), _t(u), _t(v), filter_linear=True, wrap_mode="repeat")
    base = ts.sample2d(_t(tex), _t(u), _t(v), filter_linear=True, wrap_mode="repeat")
    assert float(mip.std()) < 0.6 * float(base.std())


# -- through both engines ---------------------------------------------------

SRC_HW = (48, 64)
VIEWPORT = (160, 120)


def _engines(path, viewport=VIEWPORT):
    je = jax_pkg.Engine(viewport=viewport)
    te = torch_pkg.Engine(viewport=viewport, device="cpu")
    for e in (je, te):
        assert e.load_preset(path), e.last_error
    return je, te


def _frames(seed, b=2):
    return np.random.default_rng(seed).integers(0, 256, (b,) + SRC_HW + (3,), dtype=np.uint8)


@pytest.mark.parametrize("output", ["u8", "f32"])
@pytest.mark.parametrize("scale", [0.25, 0.3])
def test_affine_mip_preset_matches_jax(scale, output):
    with tempfile.TemporaryDirectory() as td:
        glow, _ = write_mip_presets(td, scale=scale)
        je, te = _engines(glow)
        frames = _frames(700)
        a = np.asarray(je.apply(frames, output=output))
        b = te.apply(torch.from_numpy(frames), output=output).numpy()
    assert te.shader_active and te.last_error is None and je.shader_active
    if (scale, output) == (0.25, "u8"):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1 and (d != 0).mean() <= 5e-3, (d.max(), (d != 0).mean())
    else:
        _close(a, b, output)


@pytest.mark.parametrize("output", ["u8", "f32"])
@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nearest"])
def test_warped_mip_preset_matches_jax(linear, output):
    with tempfile.TemporaryDirectory() as td:
        _, warp = write_mip_presets(td, linear=linear)
        je, te = _engines(warp)
        frames = _frames(701)
        a = np.asarray(je.apply(frames, output=output))
        b = te.apply(torch.from_numpy(frames), output=output).numpy()
    assert te.shader_active and te.last_error is None and je.shader_active
    _close(a, b, output)


def test_warped_mip_preset_samples_every_level(monkeypatch):
    """One warped sample per pyramid level and frame (on the card: one
    warp-kernel launch each): max_lod + 1 = 6 for a 48x64 texture."""
    from retrocapture_tpu_torch.ops.cuda import warp_sample as ws

    calls = []
    real = ws.warp_sample
    monkeypatch.setattr(ws, "warp_sample", lambda tex, *a, **k: calls.append(tuple(tex.shape)) or real(tex, *a, **k))
    with tempfile.TemporaryDirectory() as td:
        _, warp = write_mip_presets(td)
        te = torch_pkg.Engine(viewport=VIEWPORT, device="cpu")
        assert te.load_preset(warp)
        te.apply(torch.from_numpy(_frames(702, b=1)))
    assert calls == [(48, 64, 4), (24, 32, 4), (12, 16, 4), (6, 8, 4), (3, 4, 4), (1, 2, 4)]


def test_texture_lod_builtin_matches_jax():
    """textureLod with a constant LOD on a mipmapped input."""
    from _presets import VERTEX_GLSL

    glsl = VERTEX_GLSL + """
varying vec2 vTexCoord;
uniform sampler2D Texture;

void main()
{
    gl_FragColor = textureLod(Texture, vTexCoord, 1.5);
}

#endif
"""
    glslp = "shaders = 1\nshader0 = lod.glsl\nfilter_linear0 = true\nmipmap_input0 = true\nscale_type0 = source\nscale0 = 1.0\n"
    with tempfile.TemporaryDirectory() as td:
        with open(td + "/lod.glsl", "w") as f:
            f.write(glsl)
        with open(td + "/lod.glslp", "w") as f:
            f.write(glslp)
        je, te = _engines(td + "/lod.glslp")
        frames = _frames(703)
        a = np.asarray(je.apply(frames, output="f32"))
        b = te.apply(torch.from_numpy(frames), output="f32").numpy()
    assert te.shader_active and je.shader_active, (te.last_error, je.last_error)
    _close(a, b, "f32")
