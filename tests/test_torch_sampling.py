"""retrocapture_tpu_torch.ops.sampling against the JAX package's
sampler, on the same numpy inputs (made from a seed).

* The gather path (warped grids) and NEAREST taps are expected
  bit-equal to the JAX ``sample2d`` as ``jax.jit`` compiles it (the
  engine's path: XLA's CPU code contracts the LINEAR tap position
  ``u*W - 0.5`` and the lerps into FMAs, and the port's gather and warp
  kernel do the same), including NaN, +-inf and 1e10 coordinates (the
  ``_ifloor32`` edge semantics).
* Separable LINEAR taps that lower to resampling matmuls may differ in
  the last ulp: the reference's XLA-CPU dot and torch's matmul
  accumulate the two nonzero taps with different FMA use. Tolerance
  1e-6 on values in [0, 1] (measured: <= 1.2e-7). The axis matrix of
  tensor coordinates is compared as ``jax.jit`` builds it: its tap
  position ``coord*n - 0.5`` is contracted there, and in the port.
* The plain warp (the CPU side of the warp kernel's wrapper) against
  the Pallas kernel ``warp_sample_pallas(interpret=True)``: NEAREST
  bit-equal, LINEAR <= 2e-6 (the Pallas kernel blends x taps as weights
  before y, the gather lerps; the JAX package's own three LINEAR paths
  differ by up to 1.8e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrocapture_tpu.ops import sampling as js
from retrocapture_tpu.ops.pallas.warp_sample import warp_sample_pallas
from retrocapture_tpu_torch.ops import sampling as ts
from retrocapture_tpu_torch.ops.cuda.warp_sample import warp_sample
from retrocapture_tpu_torch.policy import ifloor32

WRAPS = list(js.WRAP_MODES)
SPECIALS = np.array([np.nan, np.inf, -np.inf, 1e10, -1e10, 3e9, -0.0, 1.0, 0.9999999], np.float32)


def _tex(seed, h=24, w=40, c=4):
    return np.random.default_rng(seed).random((h, w, c)).astype(np.float32)


def _warped_uv(seed, ho=16, wo=48, specials=True):
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(
        (np.arange(ho) + 0.5) / ho - 0.5, (np.arange(wo) + 0.5) / wo - 0.5, indexing="ij"
    )
    k = 1.0 + 0.3 * (x * x + y * y)
    u = (0.5 + x * k * 1.4 + 0.05 * rng.standard_normal((ho, wo))).astype(np.float32)
    v = (0.5 + y * k * 1.4 + 0.05 * rng.standard_normal((ho, wo))).astype(np.float32)
    if specials:
        u[0, : SPECIALS.size] = SPECIALS
        v[1, : SPECIALS.size] = SPECIALS
        u[2, : SPECIALS.size] = SPECIALS
        v[2, : SPECIALS.size] = SPECIALS[::-1]
    return u, v


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_ifloor32_matches_reference():
    x = np.concatenate([SPECIALS, np.array([2.5, -2.5, 2147483520.0, -2147483648.0, 4e9], np.float32)])
    want = np.asarray(js._ifloor32(jnp.asarray(x)))
    got = ifloor32(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want), (got, want)


@pytest.mark.parametrize("wrap", WRAPS)
@pytest.mark.parametrize("linear", [False, True], ids=["nearest", "linear"])
def test_gather_path_matches_jax_bit_for_bit(linear, wrap):
    tex = _tex(1)
    u, v = _warped_uv(2)
    jitted = jax.jit(lambda t, a, b: js.sample2d(t, a, b, filter_linear=linear, wrap_mode=wrap))
    want = np.asarray(jitted(jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v)))
    got = _np(ts.sample2d(torch.from_numpy(tex), torch.from_numpy(u), torch.from_numpy(v), filter_linear=linear, wrap_mode=wrap))
    assert got.shape == want.shape == (16, 48, 4)
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("wrap", WRAPS)
@pytest.mark.parametrize("hw", [(1, 2), (3, 4), (7, 10)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_gather_path_matches_jax_at_pyramid_top_sizes(hw, wrap):
    """The textures a warped mip tap reaches at its upper levels: one to a
    few texels, where every tap wraps or clamps (the +1 tap at 1x2 always
    does), at coordinates several texture widths outside [0, 1]. LINEAR
    and NEAREST, bit-equal to the jitted reference."""
    tex = _tex(5, h=hw[0], w=hw[1])
    u, v = _warped_uv(6)
    u, v = (u - np.float32(0.5)) * np.float32(9.0), (v - np.float32(0.5)) * np.float32(9.0)
    for linear in (False, True):
        jitted = jax.jit(lambda t, a, b: js.sample2d(t, a, b, filter_linear=linear, wrap_mode=wrap))
        want = np.asarray(jitted(jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v)))
        got = _np(ts.sample2d(torch.from_numpy(tex), torch.from_numpy(u), torch.from_numpy(v), filter_linear=linear, wrap_mode=wrap))
        assert np.array_equal(got, want, equal_nan=True), (linear, np.nanmax(np.abs(got - want)))


@pytest.mark.parametrize("wrap", WRAPS)
@pytest.mark.parametrize("linear", [False, True], ids=["nearest", "linear"])
def test_gather_path_matches_numpy_oracle(linear, wrap):
    tex = _tex(3)
    u, v = _warped_uv(4, specials=False)
    want = js.reference_sample2d_numpy(tex, u, v, filter_linear=linear, wrap_mode=wrap)
    got = _np(ts.sample2d_gather(torch.from_numpy(tex), torch.from_numpy(u), torch.from_numpy(v), filter_linear=linear, wrap_mode=wrap))
    assert np.max(np.abs(got - want)) <= (0.0 if not linear else 2e-6)


def _separable_cases():
    # (oh, ow, u scale, u offset, v scale, v offset): identity, integer
    # decimation (the slice path), integer upscale, and a warped-ratio
    # grid reaching outside [0, 1] (the matmul path).
    return [
        (24, 40, 1.0, 0.0, 1.0, 0.0),
        (12, 20, 1.0, 0.0, 1.0, 0.0),
        (48, 80, 1.0, 0.0, 1.0, 0.0),
        (30, 56, 1.3, -0.1, 1.2, -0.05),
    ]


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("wrap", WRAPS)
@pytest.mark.parametrize("linear", [False, True], ids=["nearest", "linear"])
def test_separable_concrete_grids_match_jax(linear, wrap, case):
    oh, ow, su, ou, sv, ov = _separable_cases()[case]
    tex = _tex(5)
    ur = (((np.arange(ow) + 0.5) / ow) * su + ou).astype(np.float32)
    vc = (((np.arange(oh) + 0.5) / oh) * sv + ov).astype(np.float32)
    u = np.broadcast_to(ur[None], (oh, ow)).copy()
    v = np.broadcast_to(vc[:, None], (oh, ow)).copy()
    want = np.asarray(js.sample2d(jnp.asarray(tex), u, v, filter_linear=linear, wrap_mode=wrap))
    got = _np(ts.sample2d(torch.from_numpy(tex), u, v, filter_linear=linear, wrap_mode=wrap))
    assert got.shape == want.shape
    if not linear:
        assert np.array_equal(got, want)
    else:
        assert np.max(np.abs(got - want)) <= 1e-6
    # And the f64-ish numpy oracle.
    oracle = js.reference_sample2d_numpy(tex, u, v, filter_linear=linear, wrap_mode=wrap)
    assert np.max(np.abs(got - oracle)) <= 2e-6


@pytest.mark.parametrize("wrap", WRAPS)
@pytest.mark.parametrize("linear", [False, True], ids=["nearest", "linear"])
def test_affine_and_tensor_separable_match_jax(linear, wrap):
    tex = _tex(6)
    for u_aff, v_aff, oh, ow in (
        ((1 / 80, 0.0, 0.5 / 80), (0.0, 1 / 48, 0.5 / 48), 48, 80),
        ((2 / 40, 0.0, -0.3), (0.0, 0.5 / 24, 0.1), 24, 40),
    ):
        want = np.asarray(js.sample2d_affine(jnp.asarray(tex), u_aff, v_aff, oh, ow, filter_linear=linear, wrap_mode=wrap))
        got = _np(ts.sample2d_affine(torch.from_numpy(tex), u_aff, v_aff, oh, ow, filter_linear=linear, wrap_mode=wrap))
        tol = 0.0 if not linear else 1e-6
        assert np.max(np.abs(got - want)) <= tol
    # Tensor (traced in JAX) per-axis coordinates, incl. NaN/inf.
    ur = np.concatenate([(np.arange(30) + 0.5) / 30 * 1.4 - 0.2, SPECIALS[:6]]).astype(np.float32)
    vc = np.concatenate([(np.arange(20) + 0.5) / 20 * 0.8 + 0.1, SPECIALS[3:6]]).astype(np.float32)
    jitted = jax.jit(lambda t, a, b: js.sample2d_separable(t, a, b, filter_linear=linear, wrap_mode=wrap))
    want = np.asarray(jitted(jnp.asarray(tex), jnp.asarray(ur), jnp.asarray(vc)))
    got = _np(ts.sample2d_separable(torch.from_numpy(tex), torch.from_numpy(ur), torch.from_numpy(vc), filter_linear=linear, wrap_mode=wrap))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    diff = np.abs(np.nan_to_num(got) - np.nan_to_num(want))
    assert diff.max() <= (0.0 if not linear else 1e-6)


@pytest.mark.parametrize("wrap", WRAPS)
@pytest.mark.parametrize("linear", [False, True], ids=["nearest", "linear"])
def test_plain_warp_matches_pallas_interpret(linear, wrap):
    tex = _tex(8)
    u, v = _warped_uv(9, specials=False)
    # Reach outside [0, 1] (to about -0.25 / 1.25) so every wrap mode
    # matters.
    u = (u - 0.5) * 1.3 + 0.5
    v = (v - 0.5) * 1.3 + 0.5
    want = np.asarray(
        warp_sample_pallas(jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v), filter_linear=linear, wrap_mode=wrap, interpret=True)
    )
    got = _np(warp_sample(torch.from_numpy(tex), torch.from_numpy(u), torch.from_numpy(v), filter_linear=linear, wrap_mode=wrap))
    assert got.shape == want.shape == (16, 48, 4)
    if not linear:
        assert np.array_equal(got, want)
    else:
        assert np.max(np.abs(got - want)) <= 2e-6


def test_warp_wrapper_takes_a_batch_natively():
    tex = np.stack([_tex(10), _tex(11)])
    u, v = _warped_uv(12)
    tt, tu, tv = torch.from_numpy(tex), torch.from_numpy(u), torch.from_numpy(v)
    got = warp_sample(tt, tu, tv, filter_linear=True, wrap_mode="repeat").numpy()
    for i in range(2):
        one = warp_sample(tt[i], tu, tv, filter_linear=True, wrap_mode="repeat").numpy()
        assert np.array_equal(got[i], one, equal_nan=True)
