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
"""

import numpy as np
import pytest
import torch

from retrocapture_tpu.ops.pallas.resample import _einsum_fallback
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
