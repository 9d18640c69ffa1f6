"""The warped multi-group blur of the port (ops/cuda/blur_groups.py)
against the JAX package's ``blur5x5_groups`` and an f64 tap sum.

On the CPU the port's ``blur5x5_groups`` takes its plain version: the
kernel's loop in torch (groups in order, j then i, f32 without
contraction). The JAX side runs the Pallas kernels in interpret mode, as
tests/test_blur_groups.py does.

Tolerances. Against JAX: |d| <= 1e-5 except in < 5e-4 of pixels, the
bound of tests/test_blur_groups.py:87-88 (a tap coordinate within an ulp
of a texel boundary can floor apart between the backends; the Pallas
kernels also sum in another order). Measured (CPU): max 9.6e-7 elsewhere,
and 2 of 32768 pixels of channel 2 one tap apart (up to 0.087), for v1
and v2 alike. Against the f64 tap sum with the same f32 weight table and
the same f32 tap indices: |d| <= 2e-6 (f32 rounding of a 225-term sum of
values in [0, 1]; measured max 8.5e-7).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrocapture_tpu.graph.kernels import _mattias_curve as jax_curve
from retrocapture_tpu.ops.pallas import blur_groups as jbg
from retrocapture_tpu_torch.graph.kernels import mattias_groups
from retrocapture_tpu_torch.ops.cuda import blur_groups as bg

H, W = 60, 80
OH, OW = 128, 256  # small but still multi-tile for the Pallas kernels


def _jax_groups(ow, oh):
    return [
        jbg.BlurGroup(g.channel, g.bx, g.by, g.xo, g.yo, g.weights, g.scale)
        for g in mattias_groups(ow, oh)
    ]


def _warp(oh, ow, curv=0.5):
    xg, yg = np.meshgrid((np.arange(ow) + 0.5) / ow, (np.arange(oh) + 0.5) / oh)
    cu, cv = jax_curve(xg.astype(np.float32), yg.astype(np.float32))
    u = (xg + (np.asarray(cu) - xg) * curv).astype(np.float32)
    v = (yg + (np.asarray(cv) - yg) * curv).astype(np.float32)
    return u, v


def _naive_f64(tex, u, v, groups, tables):
    """f64 sum of the f32-weighted taps, indices in the evaluator's f32
    order: col = floor(((u + bx) + xo) * W)."""
    h, w = tex.shape[:2]
    out = {}
    for g, wt in zip(groups, tables):
        acc = out.setdefault(g.channel, np.zeros(u.shape, np.float64))
        ug = (u + np.float32(g.bx)).astype(np.float32)
        vg = (v + np.float32(g.by)).astype(np.float32)
        for j, yo in enumerate(g.yo):
            iy = np.clip(np.floor((vg + np.float32(yo)) * np.float32(h)), 0, h - 1).astype(np.int64)
            for i, xo in enumerate(g.xo):
                ix = np.clip(np.floor((ug + np.float32(xo)) * np.float32(w)), 0, w - 1).astype(np.int64)
                acc += np.float64(wt[j, i]) * tex[iy, ix, g.channel]
    return out


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    tex = rng.random((H, W, 3)).astype(np.float32)
    u, v = _warp(OH, OW)
    return tex, u, v


@pytest.mark.parametrize("formulation", ["v1", "v2"])
def test_plain_blur_matches_jax_interpret(formulation, monkeypatch):
    monkeypatch.setenv("RCTPU_BLUR", formulation)
    tex, u, v = _inputs()
    want = jbg.blur5x5_groups(
        jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v), _jax_groups(OW, OH), interpret=True
    )
    got = bg.blur5x5_groups(torch.from_numpy(tex), torch.from_numpy(u), torch.from_numpy(v), mattias_groups(OW, OH))
    assert sorted(got) == [0, 1, 2]
    for ch in (0, 1, 2):
        assert got[ch].shape == (OH, OW) and got[ch].dtype == torch.float32
        d = np.abs(got[ch].numpy().astype(np.float64) - np.asarray(want[ch], np.float64))
        bad = (d > 1e-5).mean()
        assert bad < 5e-4, f"{formulation} channel {ch}: {bad:.2%} of pixels beyond 1e-5"


@pytest.mark.parametrize("formulation", ["v1", "v2"])
def test_plain_blur_matches_f64_tap_sum(formulation, monkeypatch):
    monkeypatch.setenv("RCTPU_BLUR", formulation)
    tex, u, v = _inputs(3)
    groups = mattias_groups(OW, OH)
    tables = bg.weight_tables(groups, formulation)
    want = _naive_f64(tex, u, v, groups, tables)
    got = bg.blur5x5_groups(torch.from_numpy(tex), torch.from_numpy(u), torch.from_numpy(v), groups)
    for ch in (0, 1, 2):
        d = np.abs(got[ch].numpy() - want[ch])
        assert d.max() <= 2e-6, f"{formulation} channel {ch}: max |d| {d.max():.3e}"


def test_weight_tables_v1_is_the_rank2_reconstruction():
    groups = mattias_groups(1920, 1080)
    for g, w1, w2 in zip(groups, bg.weight_tables(groups, "v1"), bg.weight_tables(groups, "v2")):
        assert w1.dtype == w2.dtype == np.float32 and w1.shape == w2.shape == (5, 5)
        np.testing.assert_array_equal(w2, (g.weights * g.scale).astype(np.float32))
        facs, resid = bg._rank2(g.weights * g.scale)
        (ax0, ay0), (ax1, ay1) = facs
        for j in range(5):
            for i in range(5):
                assert w1[j, i] == np.float32(ay0[j] * ax0[i]) + np.float32(ay1[j] * ax1[i])
        assert np.abs(w1 - g.weights * g.scale).max() <= resid + 1e-7


def test_batch_equals_frames_and_nonfinite_coords():
    """A batch in one call equals its frames one by one; NaN and +-inf
    coordinates floor to INT32_MIN and clamp to texel 0 (the port's
    ifloor32), huge finite ones saturate and clamp to the last texel."""
    tex, u, v = _inputs(5)
    u = u.copy()
    u[0, :5] = [np.nan, np.inf, -np.inf, 1e10, -1e10]
    groups = mattias_groups(OW, OH)
    batch = torch.from_numpy(np.stack([tex, tex[::-1].copy()]))
    ut, vt = torch.from_numpy(u), torch.from_numpy(v)
    both = bg.blur5x5_groups(batch, ut, vt, groups)
    for k in range(2):
        one = bg.blur5x5_groups(batch[k], ut, vt, groups)
        for ch in one:
            assert torch.equal(both[ch][k], one[ch])
    want = _naive_f64(tex, np.nan_to_num(u, nan=-1.0, posinf=-1.0, neginf=-1.0), v, groups, bg.weight_tables(groups, "v2"))
    for ch in (0, 1, 2):
        assert np.abs(both[ch][0].numpy()[0, :5] - want[ch][0, :5]).max() <= 2e-6
        assert torch.isfinite(both[ch]).all()


class _TPUJax:
    """jax with a TPU backend reported: lets the reference's
    blur_groups_fits run its geometric checks to the end on the CPU."""

    def __getattr__(self, name):
        return getattr(jax, name)

    def devices(self):
        return [types.SimpleNamespace(platform="tpu")]


GATE_CASES = [
    ((240, 320, 3), (1080, 1920)),
    ((48, 64, 3), (144, 256)),
    ((60, 80, 3), (128, 256)),
    ((240, 320, 3), (240, 320)),
    ((480, 640, 3), (480, 640)),
    ((2000, 2000, 3), (1080, 1920)),
    ((240, 320, 3), (64, 80)),
]


@pytest.mark.parametrize("formulation", ["v1", "v2"])
def test_fits_gate_engages_where_the_reference_does(formulation, monkeypatch):
    from retrocapture_tpu.graph.kernels import _MATTIAS_MAX_DUDV as jax_dudv

    from retrocapture_tpu_torch.graph.kernels import _MATTIAS_MAX_DUDV

    monkeypatch.setenv("RCTPU_BLUR", formulation)
    monkeypatch.setattr(jbg, "jax", _TPUJax())
    seen = set()
    for tex_shape, out_shape in GATE_CASES:
        oh, ow = out_shape
        want = jbg.blur_groups_fits(tex_shape, out_shape, _jax_groups(ow, oh), max_dudv=jax_dudv)
        for dev in ("cpu", "cuda"):
            got = bg.blur_groups_fits(tex_shape, out_shape, mattias_groups(ow, oh), max_dudv=_MATTIAS_MAX_DUDV, device=dev)
            assert got == want, (formulation, tex_shape, out_shape, dev)
        assert not bg.blur_groups_fits(tex_shape, out_shape, mattias_groups(ow, oh), max_dudv=_MATTIAS_MAX_DUDV, device="meta")
        seen.add(want)
    assert seen == {True, False}
    # The slice's own geometry engages.
    assert bg.blur_groups_fits((240, 320, 3), (1080, 1920), mattias_groups(1920, 1080), max_dudv=_MATTIAS_MAX_DUDV, device="cuda")


def test_v3_is_not_ported_and_says_so(monkeypatch):
    monkeypatch.setenv("RCTPU_BLUR", "v3")
    tex, u, v = _inputs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bg.blur5x5_groups(torch.from_numpy(tex), torch.from_numpy(u), torch.from_numpy(v), mattias_groups(OW, OH))


def test_wrapper_checks_its_arguments():
    tex, u, v = _inputs()
    groups = mattias_groups(OW, OH)
    with pytest.raises(TypeError):
        bg.blur5x5_groups(torch.from_numpy(tex).double(), torch.from_numpy(u), torch.from_numpy(v), groups)
    with pytest.raises(ValueError):
        bg.blur5x5_groups(torch.from_numpy(tex), torch.from_numpy(u), torch.from_numpy(v[:-1]), groups)
    with pytest.raises(ValueError):
        bg.blur5x5_groups(torch.from_numpy(tex[..., :2]), torch.from_numpy(u), torch.from_numpy(v), groups)
    with pytest.raises(RuntimeError):
        bg.blur5x5_groups(torch.empty((H, W, 3), device="meta"), torch.from_numpy(u), torch.from_numpy(v), groups)
