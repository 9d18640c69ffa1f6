"""The crt-mattias hand kernel of the port (graph/kernels.py) against the
JAX package's, piece by piece and through both engines.

1. The FMA repair. ``jax.jit`` compiles the reference's coordinate and
   hash math with XLA's CPU code generator, which contracts ``a*b + c``
   into one rounding; eager torch rounds twice. The port contracts
   (``policy.fma32``) exactly where these tests show the jitted
   reference does, and each such intermediate is held bit for bit:
   ``_mattias_curve``, the uv mix, and rand()'s ``dt`` and ``sn``.
2. The hash as a whole. XLA's CPU code calls the C library's ``sinf``
   for the f32 sine (its LLVM IR holds ``llvm.sin.v8f32``, the object
   file an undefined ``sinf``); glibc's ``sinf`` works in float64 with
   fixed polynomials, and ``policy.sinf32`` repeats it in float64 tensor
   ops. ``_rand`` is bit-equal to the jitted reference. (Before, ``sin``
   taken in f64 and rounded once was 1 ulp off in 1.3% of values, which
   ``* 43758.5453`` amplified to 24 u8 steps.)
3. The pre-convolution lowering (``RCTPU_MATTIAS=preconv``) against the
   naive tap sum, mirroring tests/test_preconv_blur.py:77-114.
4. The slice: a stand-in ``crt-mattias.glsl`` (its two parameters and a
   passthrough body; the hand kernel never evaluates the GLSL body)
   through ``retrocapture_tpu.Engine`` (Pallas in interpret mode, the
   TPU platform check of ``blur_groups_fits`` answered "tpu") and the
   port's ``Engine(device="cpu")``, 48x64 RGB -> 256x144, batch 2, two
   applies (FrameCount 0..3), u8. The port computes each step in the
   form of the reference's jitted fusions (XLA_FLAGS=--xla_dump_to, the
   fusions' LLVM IR and object code): XLA's own ``log`` and ``exp`` in
   every pow (``policy.logf32``/``expf32``; torch's differ in most
   values), the cross-axis ``q - 0.5`` contracted where a fusion computes
   the blur's u or v (or the scanline's v) alone, the epilogue's
   single-use products contracted and its constant chains folded.
   Measured (CPU): 0 or 1 u8 value of 110,592 differs per frame (9.0e-6),
   by 1 step, in the frames of FrameCount 1 and 2; before this repair up
   to 6 (5.4e-5). What is left is the blur's summation order: the port's
   blur and the Pallas kernel under jit differ by an ulp or two in ~84%
   of blur values (tests/test_torch_blur_groups.py bounds them). With ``sin`` rounded from f64: 2.8e-4 to 4.3e-4, max 24
   steps. Without the FMA repair 47% of values differ (max 31). Bound:
   max 1 step, <= 2e-5 of values.
"""

import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import retrocapture_tpu as jax_pkg
import retrocapture_tpu_torch as torch_pkg
from _mattias_standin import write_standin
from retrocapture_tpu.graph import kernels as jk
from retrocapture_tpu.ops.pallas import blur_groups as jbg
from retrocapture_tpu.ops.pallas import preconv_blur as jpc
from retrocapture_tpu_torch.graph import kernels as tk
from retrocapture_tpu_torch.ops import preconv_blur as pc
from retrocapture_tpu_torch.ops.cuda import blur_groups as bg
from retrocapture_tpu_torch.policy import fma32

f32 = np.float32


def _fma_np(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f32)


def _grid(ow, oh):
    xg, yg = np.meshgrid(np.arange(ow, dtype=f32), np.arange(oh, dtype=f32))
    return (xg + f32(0.5)) * f32(1.0 / ow), (yg + f32(0.5)) * f32(1.0 / oh)


def _coords():
    """Pixel centres of the slice's and the bench's viewports, and random
    points of [-0.1, 1.1]^2."""
    rng = np.random.default_rng(0)
    us, vs = [], []
    for ow, oh in ((256, 144), (1920, 1080)):
        u, v = _grid(ow, oh)
        us.append(u.ravel())
        vs.append(v.ravel())
    us.append(rng.uniform(-0.1, 1.1, 1 << 18).astype(f32))
    vs.append(rng.uniform(-0.1, 1.1, 1 << 18).astype(f32))
    return np.concatenate(us), np.concatenate(vs)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- 1. the FMA repair ------------------------------------------------------


def test_fma32_rounds_once_like_jitted_xla():
    rng = np.random.default_rng(1)
    a, b, c = (rng.standard_normal(1 << 16).astype(f32) for _ in range(3))
    got = fma32(_t(a), _t(b), _t(c)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, _fma_np(a, b, c))
    jitted = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    np.testing.assert_array_equal(got, jitted)
    # Eager (two roundings) differs somewhere: the repair is needed.
    assert ((a * b + c) != got).any()
    # Scalars are rounded to f32 first, as weak-typed constants are.
    np.testing.assert_array_equal(fma32(_t(a), 0.92, 0.04).numpy(), _fma_np(a, f32(0.92), f32(0.04)))


def test_fmaf32_is_a_true_fused_multiply_add():
    """policy.fmaf32 (the warp kernel's plain arithmetic) rounds the exact
    a*b + c once. On operands whose float64 sum is inexact and lands on an
    f32 tie, fma32's second rounding goes the other way; the exact value
    is taken in rational arithmetic. Bit-equal."""
    from fractions import Fraction

    from retrocapture_tpu_torch.policy import fmaf32

    rng = np.random.default_rng(2)
    n = 512
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24: half an f32 ulp above 1 + 2^-11,
    # and c (about 2^-70) decides the side but is lost in float64.
    a = np.full(n, 1 + 2.0**-12, f32)
    c = (rng.standard_normal(n) * 2.0**-70).astype(f32)
    r = rng.standard_normal((3, n)).astype(f32)
    a, b, c = np.concatenate([a, r[0]]), np.concatenate([a, r[1]]), np.concatenate([c, r[2]])

    def exact(x, y, z):
        f = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        e = int(np.floor(np.log2(abs(float(f))))) - 23  # the f32 ulp of f, or half of it
        while Fraction(2) ** (e + 24) <= abs(f):
            e += 1
        q = f / Fraction(2) ** e
        k = q.numerator // q.denominator
        rem = q - k
        if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and k % 2):
            k += 1
        return f32(float(k * Fraction(2) ** e))

    want = np.array([exact(*t) for t in zip(a, b, c)], f32)
    got = fmaf32(_t(a), _t(b), _t(c)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (fma32(_t(a), _t(b), _t(c)).numpy()[:n] != want[:n]).sum() > n // 4
    np.testing.assert_array_equal(got[n:], np.asarray(jax.jit(lambda x, y, z: x * y + z)(a[n:], b[n:], c[n:])))
    # Scalars as fma32 takes them; a non-finite sum passes through.
    np.testing.assert_array_equal(fmaf32(_t(a), 320, -0.5).numpy(), _fma_np(a, f32(320), f32(-0.5)))
    odd = fmaf32(_t(np.array([np.inf, np.nan, 1.0], f32)), 0.0, 1.0).numpy()
    assert np.isnan(odd[0]) and np.isnan(odd[1]) and odd[2] == 1.0


def _near_multiples(c, n, seed):
    """f32 values within 3 ulps of k*c, k = 1..40: where floor(x / c)
    depends on the last bits."""
    rng = np.random.default_rng(seed)
    k = rng.integers(1, 40, n).astype(f32)
    bits = (k * f32(c)).view(np.int32) + rng.integers(-3, 4, n).astype(np.int32)
    return bits.view(f32)


def test_division_by_a_constant_is_a_reciprocal_multiply_under_jit():
    """XLA rewrites x / c as x * r with r = f32(1) / f32(c), the
    reciprocal rounded in f32 (for c = 3.14 one ulp below f32(1/c)): the
    port's rand() and FrameCount / 60 do the same."""
    x = _near_multiples(3.14, 1 << 16, 2)
    got = np.asarray(jax.jit(lambda d: d / f32(3.14))(x))
    np.testing.assert_array_equal(got, x * (f32(1.0) / f32(3.14)))
    assert (got != x / f32(3.14)).any() and (got != x * f32(1.0 / 3.14)).any()
    fc = np.arange(0, 100000, dtype=np.int32)
    got = np.asarray(jax.jit(lambda n: n.astype(jnp.float32) / 60.0)(fc))
    np.testing.assert_array_equal(got, fc.astype(f32) * (f32(1.0) / f32(60.0)))


def test_curve_bit_equal_to_jitted_reference():
    u, v = _coords()
    want_u, want_v = (np.asarray(a) for a in jax.jit(jk._mattias_curve)(u, v))
    got_u, got_v = tk._mattias_curve(_t(u), _t(v))
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    # The reference's expression rounded op by op (numpy, eager) is not
    # what jit computes: the contraction is real.
    eager_u, _ = jk._mattias_curve(u, v)
    assert (np.asarray(eager_u) != want_u).mean() > 0.1


@pytest.mark.parametrize("curvature", [0.5, 0.37, 1.0])
def test_uv_mix_bit_equal_to_jitted_reference(curvature):
    """mattias_uv against the reference's base warp (kernels.py:156-158:
    curve, then q + (curve(q) - q) * CURVATURE) jitted over the pixel
    centres, with CURVATURE traced and as a constant.

    Inside the engine's one big jit the centres come from an iota in the
    same fusion, and XLA then also contracts ``q - 0.5`` where q's
    product has no other use: the other axis's term of a fusion that
    computes u or v alone, which ``mattias_uv(cross=True)`` repeats
    (test_cross_uv_contracts_the_other_axis)."""
    ow, oh = 1920, 1080
    q_u, q_v = _grid(ow, oh)

    def warp(qu, qv, c):
        cu, cv = jk._mattias_curve(qu, qv)
        return qu + (cu - qu) * c, qv + (cv - qv) * c

    traced = [np.asarray(a) for a in jax.jit(warp)(q_u, q_v, jnp.float32(curvature))]
    const = [np.asarray(a) for a in jax.jit(lambda a, b: warp(a, b, jnp.float32(curvature)))(q_u, q_v)]
    got = [a.numpy() for a in tk.mattias_uv(ow, oh, float(f32(curvature)), "cpu")]
    for g, a, b in zip(got, traced, const):
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(g, b)
    if curvature not in (0.5, 1.0):  # k * d is exact for k = 0.5 and 1: nothing to contract
        eager = (q_u + (np.asarray(jax.jit(jk._mattias_curve)(q_u, q_v)[0]) - q_u) * f32(curvature)).astype(f32)
        assert (eager != got[0]).any()


def test_cross_uv_contracts_the_other_axis():
    """``cross=True``: u with the row term ``fma(i + 0.5, f32(1/oh), -0.5)``
    and v with the column term contracted, each otherwise the default
    warp; both differ from it somewhere at 1920x1080."""
    ow, oh = 1920, 1080
    u0, v0 = tk.mattias_uv(ow, oh, 0.5, "cpu")
    u1, v1 = tk.mattias_uv(ow, oh, 0.5, "cpu", cross=True)
    xg, yg = np.meshgrid(np.arange(ow, dtype=f32), np.arange(oh, dtype=f32))
    q_u, q_v = _grid(ow, oh)
    dv = _fma_np(yg + f32(0.5), f32(1.0 / oh), f32(-0.5))
    du = _fma_np(xg + f32(0.5), f32(1.0 / ow), f32(-0.5))
    want_u = tk._mattias_curve(_t(q_u), _t(q_v), dv=_t(dv))[0]
    want_v = tk._mattias_curve(_t(q_u), _t(q_v), du=_t(du))[1]
    np.testing.assert_array_equal(u1.numpy(), fma32(want_u - _t(q_u), 0.5, _t(q_u)).numpy())
    np.testing.assert_array_equal(v1.numpy(), fma32(want_v - _t(q_v), 0.5, _t(q_v)).numpy())
    assert (u1 != u0).any() and (v1 != v0).any()


@pytest.mark.parametrize("p", [2.2, 0.3, 0.9, 0.45, 1.25, 2.4])
def test_glsl_pow_bit_equal_to_jitted_reference(p):
    """The kernels' pow (mattias 2.2, 0.3, 0.9, 0.45; ntsc gamma 1.25 and
    2.4) over [0, 1), negatives, 0, inf and NaN."""
    rng = np.random.default_rng(int(p * 100))
    x = np.concatenate([rng.random(1 << 18, f32), rng.uniform(-1, 3, 1 << 14).astype(f32),
                        np.array([0.0, -0.0, np.inf, np.nan, -1.0, 1e-40], f32)])
    want = np.asarray(jax.jit(lambda a: jk._glsl_pow(a, p))(x))
    np.testing.assert_array_equal(tk._glsl_pow(_t(x), p).numpy(), want)


def _jax_dt_sn(co_u, co_v):
    # The first two lines of the reference's _rand (kernels.py:42-43).
    dt = co_u * np.float32(12.9898) + co_v * np.float32(78.233)
    sn = dt - np.float32(3.14) * jnp.floor(dt / np.float32(3.14))
    return dt, sn


def _hash_coords():
    """rand()'s arguments as the fragment forms them, uv + 1e-4 t + {0,
    0.3, 0.5}, for FrameCount 0 and 7, plus random points."""
    u, v = _coords()
    t = f32(7) * f32(1.0 / 60.0)
    us, vs = [], []
    for off in (f32(0.0), f32(0.3), f32(0.5)):
        for tt in (f32(0.0), t):
            us.append(u + f32(0.0001) * tt + off)
            vs.append(v + f32(0.0001) * tt + off)
    # dt within ulps of a multiple of 3.14, where sn's floor turns.
    us.append((_near_multiples(3.14, 1 << 14, 4) / f32(12.9898)).astype(f32))
    vs.append(np.zeros(1 << 14, f32))
    return np.concatenate(us).astype(f32), np.concatenate(vs).astype(f32)


def test_rand_dt_sn_bit_equal_to_jitted_reference():
    cu, cv = _hash_coords()
    want_dt, want_sn = (np.asarray(a) for a in jax.jit(_jax_dt_sn)(cu, cv))
    dt, sn = tk._rand_dt_sn(_t(cu), _t(cv))
    np.testing.assert_array_equal(dt.numpy(), want_dt)
    np.testing.assert_array_equal(sn.numpy(), want_sn)


def test_rand_within_bound_of_jitted_reference():
    """Bit-equal on these 14.3M points. (With sin rounded from f64:
    bit-equal in 98.87%, |d| > 1e-3 in 0.69%. Eager torch f32 without the
    FMA repair: bit-equal in 11.9%.)"""
    cu, cv = _hash_coords()
    want = np.asarray(jax.jit(jk._rand)(cu, cv))
    got = tk._rand(_t(cu), _t(cv)).numpy()
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0) & (got < 1)).all()


def test_sinf32_bit_equal_to_jitted_sin():
    """policy.sinf32 against jit(jnp.sin) on the CPU, both reductions
    (below and from 120), signs, zeros and non-finite input."""
    from retrocapture_tpu_torch.policy import sinf32

    rng = np.random.default_rng(8)
    x = np.concatenate([
        rng.uniform(-4000, 4000, 1 << 17),
        rng.uniform(-4, 4, 1 << 17),
        rng.uniform(-1e-3, 1e-3, 1 << 12),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 120.0, -120.0, 119.99999, 1e30, -3e38],
    ]).astype(f32)
    want = np.asarray(jax.jit(jnp.sin)(x))
    got = sinf32(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    small = np.abs(x) < 120
    np.testing.assert_array_equal(sinf32(_t(x[small]), below_120=True).numpy(), want[small])
    # The bounded form refuses an argument outside its bound (on the CPU).
    with pytest.raises(ValueError, match="120"):
        sinf32(_t(np.array([1.0, -120.0], f32)), below_120=True)


# -- 3. the pre-convolution lowering ----------------------------------------


def _warp_grids(oh, ow, curv=0.5):
    x = (np.arange(ow, dtype=f32) + 0.5) / ow
    y = (np.arange(oh, dtype=f32) + 0.5) / oh
    u, v = np.meshgrid(x, y)
    cu = (u - 0.5) * 2.2
    cv = (v - 0.5) * 2.2
    cu = cu * (1.0 + (np.abs(cv) / 5.0) ** 2)
    cv = cv * (1.0 + (np.abs(cu) / 4.0) ** 2)
    cu = (cu / 2.0 + 0.5) * 0.92 + 0.04
    cv = (cv / 2.0 + 0.5) * 0.92 + 0.04
    return (u + (cu - u) * curv).astype(f32), (v + (cv - v) * curv).astype(f32)


def _naive(tex, u, v, groups):
    """Evaluator float order: col = floor(((u + bx) + xo) * W), f64 sum."""
    h, w = tex.shape[:2]
    out = {}
    for g in groups:
        acc = np.zeros(u.shape, np.float64)
        wts = np.asarray(g.weights, np.float64) * g.scale
        ug = (u + f32(g.bx)).astype(f32)
        vg = (v + f32(g.by)).astype(f32)
        for j, yo in enumerate(g.yo):
            rows = np.clip(np.floor((vg + f32(yo)) * f32(h)).astype(np.int64), 0, h - 1)
            for i, xo in enumerate(g.xo):
                with np.errstate(invalid="ignore"):  # NaN -> INT64_MIN -> 0
                    cols = np.clip(np.floor((ug + f32(xo)) * f32(w)).astype(np.int64), 0, w - 1)
                acc += wts[j, i] * tex[rows, cols, g.channel]
        out[g.channel] = out.get(g.channel, 0.0) + acc
    return out


def test_preconv_plan_tables_partition_the_weights():
    for g in tk.mattias_groups(128, 96):
        gp = pc.plan_group(g, 32, 24)
        want = float(np.sum(np.asarray(g.weights, np.float64) * g.scale))
        np.testing.assert_allclose(gp.table.sum(axis=-1), want, rtol=1e-5)


def test_preconv_matches_naive_taps_and_jax():
    rng = np.random.default_rng(7)
    h, w, oh, ow = 24, 32, 96, 128
    tex = rng.random((h, w, 3), f32)
    u, v = _warp_grids(oh, ow)
    groups = tk.mattias_groups(ow, oh)
    want = _naive(tex, u, v, groups)
    got = pc.blur_preconv(_t(tex), _t(u), _t(v), groups)
    jgroups = [jbg.BlurGroup(g.channel, g.bx, g.by, g.xo, g.yo, g.weights, g.scale) for g in groups]
    ref = jpc.blur_preconv(tex, u, v, jgroups)  # the JAX package's XLA gather path
    for ch in want:
        a = got[ch].numpy().astype(np.float64)
        diff = np.abs(a - want[ch])
        # knife-edge f32 rounding-order flips allowed on a tiny fraction
        assert (diff > 1e-4).mean() < 0.005, (ch, (diff > 1e-4).mean(), diff.max())
        assert np.median(diff) < 1e-6, (ch, np.median(diff))
        # Same Qfine up to the einsum's summation order, same indices.
        assert np.abs(a - np.asarray(ref[ch], np.float64)).max() <= 1e-6


def test_preconv_out_of_range_coords_exact():
    """Coords far outside [0,1] (curvature corners), and non-finite:
    every tap clamps to the edge texel — the padded first/last subcell."""
    rng = np.random.default_rng(3)
    h, w = 16, 20
    tex = rng.random((h, w, 3), f32)
    groups = tk.mattias_groups(80, 64)
    u = np.asarray([[-3.0, -0.01, 0.5, 1.01, 4.0, np.nan]], f32)
    v = np.full_like(u, 0.5)
    want = _naive(tex, u, v, groups)
    got = pc.blur_preconv(_t(tex), _t(u), _t(v), groups)
    for ch in want:
        np.testing.assert_allclose(got[ch].numpy()[:, :5], want[ch][:, :5], atol=1e-5)
        # NaN floors to INT32_MIN and clamps to the first texel, as -3.0 does.
        assert got[ch][0, 5] == got[ch][0, 0]


def test_subcell_coords_roundtrip():
    """floor(u2 * qw) must recover the clamped subcell index exactly."""
    rng = np.random.default_rng(5)
    h, w = 24, 32
    gp = pc.plan_group(tk.mattias_groups(128, 96)[0], w, h)
    qh, qw = gp.q_shape(h, w)
    u = rng.uniform(-2, 3, (64, 64)).astype(f32)
    v = rng.uniform(-2, 3, (64, 64)).astype(f32)
    u2, _ = pc.subcell_coords(_t(u), _t(v), gp, w, h)
    u2 = u2.numpy()
    ix = np.floor(u2.astype(np.float64) * qw)
    assert (ix == np.floor(u2 * f32(qw))).all()
    assert (ix >= 0).all() and (ix < qw).all()


def test_preconv_fits_matches_reference():
    for (h, w), (oh, ow) in (((240, 320), (1080, 1920)), ((24, 32), (96, 128)), ((1080, 1920), (1080, 1920))):
        groups = tk.mattias_groups(ow, oh)
        jgroups = [jbg.BlurGroup(g.channel, g.bx, g.by, g.xo, g.yo, g.weights, g.scale) for g in groups]
        assert pc.blur_preconv_fits((h, w), groups) == jpc.blur_preconv_fits((h, w), jgroups)


# -- 4. the slice through both engines --------------------------------------

SRC_HW = (48, 64)
VIEWPORT = (256, 144)
BATCH = 2
N_APPLY = 2


class _TPUJax:
    """jax with a TPU backend reported: the reference's blur_groups_fits
    runs its geometric checks and then engages the Pallas kernels, which
    RCTPU_KERNELS=interpret runs in interpret mode on the CPU."""

    def __getattr__(self, name):
        return getattr(jax, name)

    def devices(self):
        return [types.SimpleNamespace(platform="tpu")]


def _recording(registry, name):
    """Wrap registry[name] so that every call that returned a frame (the
    kernel engaged) is counted."""
    fn = registry[name]
    calls = []

    def wrapped(ctx, sh):
        out = fn(ctx, sh)
        calls.append(out is not None)
        return out

    return wrapped, calls


def _frames():
    rng = np.random.default_rng(5)
    return rng.integers(0, 256, (N_APPLY * BATCH,) + SRC_HW + (3,), dtype=np.uint8)


@pytest.fixture(scope="module")
def standin():
    with tempfile.TemporaryDirectory() as td:
        yield write_standin(td)


@pytest.fixture(scope="module")
def jax_slice(standin):
    """The JAX engine's u8 output for every apply (built once: the
    interpret-mode Pallas compile takes ~35 s)."""
    frames = _frames()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RCTPU_KERNELS", "interpret")
        mp.setattr(jbg, "jax", _TPUJax())
        wrapped, calls = _recording(jk._REGISTRY, "crt-mattias.glsl")
        mp.setitem(jk._REGISTRY, "crt-mattias.glsl", wrapped)
        e = jax_pkg.Engine(viewport=VIEWPORT)
        assert e.load_preset(standin), e.last_error
        outs = [np.asarray(e.apply(frames[i * BATCH:(i + 1) * BATCH], output="u8")) for i in range(N_APPLY)]
        assert e.shader_active is True and e.last_error is None
    assert calls and all(calls), "the reference's crt-mattias kernel did not engage"
    return np.concatenate(outs)


def _port_run(path, monkeypatch, frames, viewport=VIEWPORT):
    wrapped, calls = _recording(tk._REGISTRY, "crt-mattias.glsl")
    monkeypatch.setitem(tk._REGISTRY, "crt-mattias.glsl", wrapped)
    e = torch_pkg.Engine(viewport=viewport, device="cpu")
    assert e.load_preset(path), e.last_error
    outs = [e.apply(torch.from_numpy(frames[i * BATCH:(i + 1) * BATCH]), output="u8") for i in range(len(frames) // BATCH)]
    assert e.shader_active is True and e.last_error is None
    return torch.cat(outs).numpy(), calls


def test_slice_matches_jax_engine(standin, jax_slice, monkeypatch):
    got, calls = _port_run(standin, monkeypatch, _frames())
    assert len(calls) == N_APPLY * BATCH and all(calls), "the port's crt-mattias kernel did not engage"
    assert got.shape == jax_slice.shape == (N_APPLY * BATCH, VIEWPORT[1], VIEWPORT[0], 3)
    assert got.dtype == np.uint8
    for i in range(len(got)):
        d = np.abs(got[i].astype(np.int32) - jax_slice[i].astype(np.int32))
        assert d.max() <= 1, (i, d.max())
        assert (d != 0).mean() <= 2e-5, (i, (d != 0).mean())
    # A real frame: curved black corners, lit centre.
    assert (got[:, 0, 0] == 0).all() and got[:, VIEWPORT[1] // 2].mean() > 5


def test_slice_preconv_matches_groups(standin, monkeypatch):
    """RCTPU_MATTIAS=preconv through the port's engine against the
    default blur, mirroring test_engine_mattias_preconv_matches_groups."""
    frames = _frames()[:BATCH]
    outs = {}
    for which in ("groups", "preconv"):
        monkeypatch.setenv("RCTPU_MATTIAS", which)
        outs[which], calls = _port_run(standin, monkeypatch, frames)
        assert all(calls)
    d = np.abs(outs["preconv"].astype(np.int32) - outs["groups"].astype(np.int32))
    assert np.median(d) == 0
    assert (d > 5).mean() < 0.005, (d.max(), (d > 5).mean())


def test_slice_v1_close_to_v2(standin, monkeypatch):
    """RCTPU_BLUR=v1 (rank-2 weights, residual ~1e-4) renders within a
    few steps of the exact-weight default."""
    frames = _frames()[:BATCH]
    outs = {}
    for mode in ("v2", "v1"):
        monkeypatch.setenv("RCTPU_BLUR", mode)
        outs[mode], _ = _port_run(standin, monkeypatch, frames)
    d = np.abs(outs["v1"].astype(np.int32) - outs["v2"].astype(np.int32))
    assert d.max() <= 2 and (d != 0).mean() < 0.05, (d.max(), (d != 0).mean())


def test_kernels_off_leaves_the_pass_to_the_evaluator(standin, monkeypatch):
    """RCTPU_KERNELS=off: no hand kernel; the stand-in's passthrough body
    renders the NEAREST-upscaled input, as it would in the reference."""
    monkeypatch.setenv("RCTPU_KERNELS", "off")
    assert tk.find_kernel("crt-mattias.glsl") is None
    frames = _frames()[:BATCH]
    got, calls = _port_run(standin, monkeypatch, frames)
    assert calls == []
    ys = (np.arange(VIEWPORT[1]) * SRC_HW[0]) // VIEWPORT[1]
    xs = (np.arange(VIEWPORT[0]) * SRC_HW[1]) // VIEWPORT[0]
    np.testing.assert_array_equal(got, frames[:, ys][:, :, xs])
    monkeypatch.setenv("RCTPU_KERNELS", "on")
    assert tk.find_kernel("/some/dir/crt-mattias.glsl") is not None
    assert tk.find_kernel("crt-geom.glsl") is None


def test_out_of_gate_geometry_falls_to_the_evaluator(standin, monkeypatch):
    """A viewport the blur gate rejects (a downscale: the v2 drift and
    window limits fail) leaves the pass to the evaluator, as the
    reference's gate does."""
    frames = _frames()[:BATCH]
    got, calls = _port_run(standin, monkeypatch, frames, viewport=(32, 24))
    assert calls == [False] * BATCH
    assert got.shape == (BATCH, 24, 32, 3)
