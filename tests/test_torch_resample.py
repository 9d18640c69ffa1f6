"""The viewport blit of the port (ops/cuda/resample.py) against the JAX
package's.

The dense ``resample_u8`` Pallas body has no interpret flag; the JAX
package's own tests hold it through its plain reference
``_einsum_fallback``, and so does this file. On the CPU the port's
``resample_u8`` wrapper takes ``resample_u8_plain`` (the same two f32
einsums, y then x, then the quantize), so the expectation is the JAX
tests' own: every pixel within 1 u8 step of an f64 ground truth and
bit-equal to it wherever the f64 value is not on a knife edge (within
1e-4 steps of a .5 rounding boundary), and the same against
``_einsum_fallback``. The CUDA kernel takes each axis matrix row's two
nonzero (index, weight) pairs; the table test pins those to the matrix.
The kernel itself is held to the same truth on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3).

The phase-form blit (``resample_u8_xphase``, ``RCTPU_XPHASE=on``) runs
the 2-tap sums of the dense kernel regrouped by source column, so its
plain version is held bit for bit to the dense blit as that kernel
computes it (2-tap y then 2-tap x from ``axis_taps``, f32, no
contraction), and within 1 step (off knife edges: exactly) to the f64
truth, to the JAX package's ``_resample_u8_xphase`` in interpret mode and
to ``resample_u8``'s einsum plain version.
"""

import numpy as np
import pytest
import torch

from retrocapture_tpu.ops.pallas.resample import _einsum_fallback, _resample_u8_xphase
from retrocapture_tpu.ops.pallas.resample import blit_u8 as jax_blit_u8
from retrocapture_tpu.ops.sampling import _axis_matrix as jax_axis_matrix
from retrocapture_tpu.ops.sampling import _axis_matrix_device
from retrocapture_tpu_torch.ops.cuda import resample as rs
from retrocapture_tpu_torch.ops.sampling import _axis_matrix

# (src_w, dst_w, src_h or None for an identity y axis, dst_h): the
# GEOMETRIES of tests/test_kernels_resample.py, plus a y-only arm
# (identity x) and the slice's small test size.
GEOMETRIES = [
    pytest.param(320, 1920, 240, 1080, id="r6-with-y"),
    pytest.param(640, 1920, 240, 1080, id="r3-with-y"),
    pytest.param(320, 1920, None, 240, id="r6-y-identity"),
    pytest.param(640, 1920, None, 333, id="r3-y-identity-odd"),
    pytest.param(320, 1920, 240, 1077, id="r6-odd-oh"),
    pytest.param(128, 256, 96, 192, id="r2-small"),
    pytest.param(320, 320, 240, 1080, id="y-only"),
    pytest.param(64, 160, 48, 120, id="slice-small"),
]


def _coord(dst):
    return ((np.arange(dst, dtype=np.float64) + 0.5) / np.float64(dst)).astype(np.float32)


def _blit_axes(src, dst):
    return _axis_matrix(_coord(dst), src, True, "clamp_to_edge")


def _mk_tex(rng, h, w, c=3):
    t = rng.random((h, w, c)).astype(np.float32)
    grid = (rng.integers(0, 256, size=(h, w, c)) / 255.0).astype(np.float32)
    pick = rng.random((h, w, c)) < 0.5
    return np.where(pick, grid, t).astype(np.float32)


def _truth(tex, ay, ax):
    t64 = tex.astype(np.float64)
    if ay is not None:
        h, w, c = t64.shape
        t64 = (ay.astype(np.float64) @ t64.reshape(h, w * c)).reshape(-1, w, c)
    if ax is not None:
        t64 = np.matmul(ax.astype(np.float64)[None], t64)
    scaled = np.clip(t64, 0.0, 1.0) * 255.0
    return np.round(scaled).astype(np.int32), np.abs(scaled - np.floor(scaled) - 0.5) < 1e-4


@pytest.mark.parametrize("w,ow,h,oh", GEOMETRIES)
def test_plain_blit_matches_einsum_fallback_and_f64_truth(w, ow, h, oh):
    rng = np.random.default_rng(w * 7 + ow + oh)
    ax = None if ow == w else _blit_axes(w, ow)
    ay = None if h is None else _blit_axes(h, oh)
    tex = _mk_tex(rng, oh if h is None else h, w)
    got = rs.resample_u8(torch.from_numpy(tex), ay, ax).numpy()
    want = np.asarray(_einsum_fallback(tex, ay, ax))
    assert got.shape == want.shape == (oh, ow, 3) and got.dtype == np.uint8
    q64, edge = _truth(tex, ay, ax)
    for label, out in (("port", got), ("jax", want)):
        diff = np.abs(out.astype(np.int32) - q64)
        assert diff.max() <= 1, f"{label}: {diff.max()} steps from f64 truth"
        assert (diff[~edge] == 0).all(), f"{label}: non-knife-edge pixels off the f64 truth"
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d[~edge] == 0).all()


@pytest.mark.parametrize("h,w,vh,vw", [(240, 320, 1080, 1920), (48, 64, 120, 160), (48, 64, 48, 64)])
def test_blit_u8_matches_jax_blit_u8(h, w, vh, vw):
    rng = np.random.default_rng(h + w)
    tex = _mk_tex(rng, h, w)
    got = rs.blit_u8(torch.from_numpy(tex), vw, vh).numpy()
    want = np.asarray(jax_blit_u8(tex, vw, vh))
    assert got.shape == want.shape == (vh, vw, 3)
    ay, ax = rs.blit_matrices(h, w, vw, vh)
    q64, edge = _truth(tex, ay, ax)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d[~edge] == 0).all()
    # A batch goes through in one call and equals the frames one by one.
    batch = torch.from_numpy(np.stack([tex, tex[::-1].copy()]))
    out_b = rs.blit_u8(batch, vw, vh).numpy()
    assert np.array_equal(out_b[0], got)
    assert np.array_equal(out_b[1], rs.blit_u8(batch[1], vw, vh).numpy())


@pytest.mark.parametrize("src,dst", [(240, 1080), (320, 1920), (48, 120), (64, 160), (640, 1920), (96, 192)])
def test_axis_tables_are_the_matrix_nonzeros(src, dst):
    coord = _coord(dst)
    a = _axis_matrix(coord, src, True, "clamp_to_edge")
    # The port's copy of _axis_matrix is the reference's, and its device
    # build equals it bit for bit.
    assert np.array_equal(a, jax_axis_matrix(coord, src, True, "clamp_to_edge"))
    assert np.array_equal(a, np.asarray(_axis_matrix_device(coord, src, True, "clamp_to_edge")))
    i0, w0, i1, w1 = rs.axis_taps(a)
    rebuilt = np.zeros_like(a)
    rows = np.arange(dst)
    np.add.at(rebuilt, (rows, i0), w0)
    np.add.at(rebuilt, (rows, i1), w1)
    assert np.array_equal(rebuilt, a)
    for r in (0, 1, dst // 2, dst - 2, dst - 1):
        nz = np.nonzero(a[r])[0]
        assert set(nz.tolist()) <= {int(i0[r]), int(i1[r])}
        assert w0[r] == a[r, i0[r]]
        assert w1[r] == (a[r, i1[r]] if i1[r] != i0[r] else 0.0)


def test_quantize_stores_nan_as_zero():
    tex = np.full((4, 4, 3), np.nan, np.float32)
    tex[0, 0] = [0.5, 1.5, -1.0]
    got = rs.resample_u8(torch.from_numpy(tex), None, _blit_axes(4, 8)).numpy()
    want = np.asarray(_einsum_fallback(tex, None, _blit_axes(4, 8)))
    assert np.array_equal(got, want)
    assert got[1:].max() == 0


# The integer-ratio geometries of tests/test_kernels_resample.py, and the
# slice's small size (r = 4).
XPHASE_GEOMETRIES = [
    pytest.param(320, 1920, 240, 1080, id="r6-with-y"),
    pytest.param(640, 1920, 240, 1080, id="r3-with-y"),
    pytest.param(320, 1920, None, 240, id="r6-y-identity"),
    pytest.param(640, 1920, None, 333, id="r3-y-identity-odd"),
    pytest.param(320, 1920, 240, 1077, id="r6-odd-oh"),
    pytest.param(128, 256, 96, 192, id="r2-small"),
    pytest.param(64, 256, 48, 144, id="r4-slice-small"),
]


def _dense_two_tap(tex, ay, ax):
    """The dense blit as the resample_u8 kernel computes it: y then x,
    each output value w0*t0 + w1*t1 over the row's two nonzeros, f32."""
    t = torch.from_numpy(tex)
    for axis, a in ((0, ay), (1, ax)):
        if a is None:
            continue
        i0, w0, i1, w1 = (torch.from_numpy(x) for x in rs.axis_taps(a))
        shape = (-1, 1, 1) if axis == 0 else (-1, 1)
        t0 = t.index_select(axis, i0.long())
        t1 = t.index_select(axis, i1.long())
        t = w0.reshape(shape) * t0 + w1.reshape(shape) * t1
    return rs._quantize_u8(t).numpy()


@pytest.mark.parametrize("w,ow,h,oh", XPHASE_GEOMETRIES)
def test_xphase_plain_matches_dense_blit_and_jax(w, ow, h, oh):
    rng = np.random.default_rng(w * 7 + ow)
    ax = _blit_axes(w, ow)
    ay = None if h is None else _blit_axes(h, oh)
    tex = _mk_tex(rng, oh if h is None else h, w)
    plan = rs._xphase_plan(ax, w, ow)
    assert plan is not None and plan[0] == ow // w
    got = rs.resample_u8_xphase(torch.from_numpy(tex), ay, plan).numpy()
    assert got.shape == (oh, ow, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _dense_two_tap(tex, ay, ax))
    q64, edge = _truth(tex, ay, ax)
    want = np.asarray(_resample_u8_xphase(tex, ay, plan, interpret=True))
    dense = rs.resample_u8(torch.from_numpy(tex), ay, ax).numpy()
    for label, out in (("port xphase", got), ("jax xphase", want), ("port einsum", dense)):
        diff = np.abs(out.astype(np.int32) - q64)
        assert diff.max() <= 1, f"{label}: {diff.max()} steps from f64 truth"
        assert (diff[~edge] == 0).all(), f"{label}: non-knife-edge pixels off the f64 truth"
    for other in (want, dense):
        d = np.abs(got.astype(np.int32) - other.astype(np.int32))
        assert d.max() <= 1 and (d[~edge] == 0).all()


def test_xphase_batch_equals_frames():
    rng = np.random.default_rng(9)
    ay, ax = rs.blit_matrices(48, 64, 256, 144)
    plan = rs._xphase_plan(ax, 64, 256)
    batch = torch.from_numpy(np.stack([_mk_tex(rng, 48, 64), _mk_tex(rng, 48, 64)]))
    both = rs.resample_u8_xphase(batch, ay, plan)
    for k in range(2):
        assert torch.equal(both[k], rs.resample_u8_xphase(batch[k], ay, plan))
    with pytest.raises(ValueError):
        rs.resample_u8_xphase(batch[..., :32, :], ay, plan)
    with pytest.raises(RuntimeError):
        rs.resample_u8_xphase(torch.empty((48, 64, 3), device="meta"), ay, plan)


@pytest.mark.parametrize("vw,takes", [(256, True), (160, False), (64, False)])
def test_blit_u8_takes_xphase_under_rctpu_xphase(monkeypatch, vw, takes):
    """RCTPU_XPHASE=on routes an integer x-upscale through the phase form
    (resample.py:421-425 of the reference); other ratios and the default
    keep the dense blit."""
    rng = np.random.default_rng(4)
    tex = torch.from_numpy(_mk_tex(rng, 48, 64))
    calls = []
    real = rs.resample_u8_xphase

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(rs, "resample_u8_xphase", spy)
    default = rs.blit_u8(tex, vw, 144)
    assert calls == []
    monkeypatch.setenv("RCTPU_XPHASE", "on")
    got = rs.blit_u8(tex, vw, 144)
    assert len(calls) == int(takes)
    d = np.abs(got.numpy().astype(np.int32) - default.numpy().astype(np.int32))
    assert got.shape == (144, vw, 3) and d.max() <= 1


def test_engine_blit_takes_xphase_when_the_last_pass_is_source_sized(monkeypatch, tmp_path):
    """feedback-ghost with its pass at the source size (absolute scale):
    the viewport blit is an integer x-upscale (64 -> 256, r = 4), which
    RCTPU_XPHASE=on sends through the phase form. The shipped preset's
    pass renders at the viewport (a source-scale-1 last pass does), so
    its blit has r = 1 and never takes it."""
    import os

    import retrocapture_tpu_torch as torch_pkg

    shader = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "presets", "feedback-ghost.glsl")
    path = tmp_path / "fg.glslp"
    path.write_text(f"shaders = 1\nshader0 = {shader}\nfilter_linear0 = false\nscale_type0 = absolute\nscale_x0 = 64\nscale_y0 = 48\n")
    frames = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, 72, 64), dtype=np.uint8))
    calls = []
    real = rs.resample_u8_xphase

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(rs, "resample_u8_xphase", spy)
    outs = []
    for mode in ("off", "on"):
        monkeypatch.setenv("RCTPU_XPHASE", mode)
        e = torch_pkg.Engine(viewport=(256, 144), device="cpu")
        assert e.load_preset(str(path)), e.last_error
        e.set_input_format("nv12")
        outs.append(e.apply(frames, output="u8").numpy())
        assert e.shader_active and e.last_error is None
    assert calls == [1]
    d = np.abs(outs[0].astype(np.int32) - outs[1].astype(np.int32))
    # The chain's RGBA8 store puts every blit input on the u8 grid, where
    # the einsum and the 2-tap sums round ties apart (measured 0.32% of
    # values; tests/test_kernels_resample.py:120-123 allows 1e-2).
    assert outs[1].shape == (2, 144, 256, 3) and d.max() <= 1 and (d != 0).mean() <= 1e-2
    # The shipped preset's blit is 1080p -> 1080p-like (r = 1): no phase plan.
    ay, ax = rs.blit_matrices(144, 256, 256, 144)
    assert ax is None or rs._xphase_plan(ax, 256, 256) is None


# -- the blit cache and the kernel's host-side plan ---------------------------

# (h, w, vw, vh): more geometries than the cache holds, one of them
# revisited (first, in the middle, and after it has been pushed out).
_SEQ_FIRST = (12, 16, 96, 54)
BLIT_SEQUENCE = (
    [_SEQ_FIRST, (12, 16, 64, 54), (16, 12, 96, 54), _SEQ_FIRST, (12, 16, 12 * 4, 16)]
    + [(10 + k, 14, 40 + k, 33) for k in range(rs._BLIT_CACHE_MAX)]
    + [_SEQ_FIRST, (12, 16, 16, 12)]
)


def test_blit_cache_sequence_equals_uncached_and_jax():
    """blit_u8 through its cache over a sequence of geometries: each
    result is bit-equal to blit_u8 with the cache cleared first, and holds
    the JAX blit_u8 to this file's criterion (within 1 step, exact off the
    f64 knife edges); the cache stays bounded and the revisited geometry
    is found again."""
    rng = np.random.default_rng(41)
    rs.clear_blit_cache()
    through = []
    texes = []
    for h, w, vw, vh in BLIT_SEQUENCE:
        tex = _mk_tex(rng, h, w)
        texes.append(tex)
        through.append(rs.blit_u8(torch.from_numpy(tex), vw, vh).numpy())
        assert len(rs._BLIT_CACHE) <= rs._BLIT_CACHE_MAX
    assert len(rs._BLIT_CACHE) == rs._BLIT_CACHE_MAX
    assert (*_SEQ_FIRST, "cpu") in rs._BLIT_CACHE
    for (h, w, vw, vh), tex, got in zip(BLIT_SEQUENCE, texes, through):
        rs.clear_blit_cache()
        np.testing.assert_array_equal(got, rs.blit_u8(torch.from_numpy(tex), vw, vh).numpy())
        assert len(rs._BLIT_CACHE) == 1
        want = np.asarray(jax_blit_u8(tex, vw, vh))
        assert got.shape == want.shape == (vh, vw, 3)
        q64, edge = _truth(tex, *rs.blit_matrices(h, w, vw, vh))
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d[~edge] == 0).all()


def test_blit_cache_keys_and_lru_order():
    rs.clear_blit_cache()
    a = rs._blit_plan(12, 16, 96, 54, torch.device("cpu"))
    assert rs._blit_plan(12, 16, 96, 54, "cpu") is a  # a device and its name: one key
    assert rs._blit_plan(12, 16, 96, 55, "cpu") is not a
    assert rs._blit_plan(16, 12, 96, 54, "cpu") is not a
    assert rs._blit_plan(12, 16, 96, 54, "meta") is not a
    assert len(rs._BLIT_CACHE) == 4
    for k in range(rs._BLIT_CACHE_MAX - 1):
        rs._blit_plan(12, 16, 200 + k, 54, "cpu")
        rs._blit_plan(12, 16, 96, 54, "cpu")  # used again: stays
    assert rs._blit_plan(12, 16, 96, 54, "cpu") is a
    assert (12, 16, 96, 55, "cpu") not in rs._BLIT_CACHE
    # The plan's parts are the uncached functions' results.
    ay, ax = rs.blit_matrices(12, 16, 96, 54)
    np.testing.assert_array_equal(a.ay, ay)
    np.testing.assert_array_equal(a.ax, ax)
    for got, want in zip(a.ytaps, rs.axis_taps(ay)):
        np.testing.assert_array_equal(got.numpy(), want)
    plan, tables = a.xphase
    assert tables is None and plan[0] == 6
    for got, want in zip(plan[2:], rs._xphase_plan(ax, 16, 96)[2:]):
        np.testing.assert_array_equal(got, want)
    identity = rs._blit_plan(12, 16, 16, 12, "cpu")
    assert identity.ay is None and identity.ax is None and identity.xphase is None
    rs.clear_blit_cache()
    assert len(rs._BLIT_CACHE) == 0


# (src_w, dst_w, channels, has_y): upscales, the identity x axis, a
# downscale and a wide downscale whose segments must narrow.
SEG_PLANS = [
    pytest.param(320, 1920, 3, True, id="r6"),
    pytest.param(256, 1920, 3, True, id="r7.5"),
    pytest.param(1920, 1920, 3, True, id="near-identity"),
    pytest.param(37, 333, 1, True, id="ragged"),
    pytest.param(1920, 640, 4, True, id="down-3"),
    pytest.param(3840, 100, 4, False, id="down-38"),
    pytest.param(64, None, 2, True, id="x-identity"),
]


@pytest.mark.parametrize("w,ow,c,has_y", SEG_PLANS)
def test_seg_plan_covers_every_tap_within_the_budget(w, ow, c, has_y):
    xt = None if ow is None else rs.axis_taps(_blit_axes(w, ow))
    ow = w if ow is None else ow
    seg_px, lo, n, cap = rs._seg_plan(xt, ow, c, has_y)
    assert seg_px in rs._SEG_WIDTHS and len(lo) == len(n) == -(-ow // seg_px)
    assert (n > 0).all(), "a blit geometry must not need the general path"
    assert cap % 4 == 0 and cap >= int(n.max()) * rs._PADDED[c]
    per_warp = (3 if has_y else 2) * 4 * cap + rs._SEG_MAX * c + 16
    assert per_warp * rs._WARPS <= rs._SHARED_BUDGET
    for s in range(len(lo)):
        cols = np.arange(s * seg_px, min(ow, (s + 1) * seg_px))
        taps = cols if xt is None else np.concatenate([xt[0][cols], xt[2][cols]])
        assert lo[s] <= taps.min() and taps.max() < lo[s] + n[s]
        assert lo[s] >= 0 and lo[s] + n[s] <= w


def test_seg_plan_sends_scattered_taps_to_the_general_path():
    """A caller's own matrix whose two taps lie thousands of columns apart:
    no segment width fits, so (nearly) every segment is marked for global
    memory."""
    idx = np.arange(300)
    ax = np.zeros((300, 4000), np.float32)
    ax[idx, (idx * 13) % 4000] = 0.25
    ax[idx, 3999 - (idx * 7) % 2000] += 0.75
    seg_px, lo, n, cap = rs._seg_plan(rs.axis_taps(ax), 300, 3, True)
    assert seg_px == rs._SEG_WIDTHS[-1] and (n == 0).mean() > 0.8
    assert cap == int(n.max()) * rs._PADDED[3]  # of the few segments that still fit
    # and the plain version still computes it on the CPU
    tex = torch.from_numpy(_mk_tex(np.random.default_rng(2), 5, 4000))
    assert rs.resample_u8(tex, None, ax).shape == (5, 300, 3)
    with pytest.raises(ValueError):
        rs.axis_taps(np.ones((2, 3), np.float32))


def test_general_blocks_counter_resets():
    before = rs.general_blocks()
    assert rs.general_blocks(reset=True) == before
    assert rs.general_blocks() == 0


def test_dense_tables_send_even_spaced_y_taps_to_the_general_path():
    """The kernel keeps source row r in slot r & 1, so a y matrix with a
    row whose taps lie 2 rows apart cannot use the shared-memory scheme:
    every segment is marked for global memory. Blit matrices never are."""
    ay = np.zeros((6, 8), np.float32)
    ay[np.arange(6), np.arange(6)] = 0.5
    ay[np.arange(6), np.arange(6) + 2] = 0.5
    d = rs._dense_tables(ay, _blit_axes(16, 96), 8, 16, 3, "cpu")
    assert d.general_segs == d.seg_n.shape[0] and d.cap == 0 and int(d.seg_n.max()) == 0
    for h, oh in ((240, 1080), (1080, 360), (224, 1080), (48, 47)):
        d = rs._dense_tables(_blit_axes(h, oh), _blit_axes(16, 96), h, 16, 3, "cpu")
        assert d.general_segs == 0 and d.cap > 0
