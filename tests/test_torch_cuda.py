"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. The file
imports neither jax nor the JAX package, so it runs on a machine that
has only the port:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py configures jax.)
"""

import numpy as np
import pytest
import torch

from retrocapture_tpu_torch.ops.cuda import resample as rs
from retrocapture_tpu_torch.ops.cuda import warp_sample as ws
from retrocapture_tpu_torch.ops.sampling import WRAP_MODES, _axis_matrix

pytestmark = pytest.mark.cuda

# (src_w, dst_w, src_h or None for an identity y axis, dst_h)
GEOMETRIES = [
    (320, 1920, 240, 1080),
    (640, 1920, None, 333),
    (320, 1920, 240, 1077),
    (320, 320, 240, 1080),
    (64, 160, 48, 120),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    return torch.device("cuda")


def _blit_axes(src, dst):
    coord = ((np.arange(dst, dtype=np.float64) + 0.5) / np.float64(dst)).astype(np.float32)
    return _axis_matrix(coord, src, True, "clamp_to_edge")


@pytest.mark.parametrize("w,ow,h,oh", GEOMETRIES)
def test_resample_kernel_matches_f64_truth(cuda_device, w, ow, h, oh):
    rng = np.random.default_rng(w + ow + oh)
    ax = None if ow == w else _blit_axes(w, ow)
    ay = None if h is None else _blit_axes(h, oh)
    th = oh if h is None else h
    grid = (rng.integers(0, 256, size=(th, w, 3)) / 255.0).astype(np.float32)
    tex = np.where(rng.random((th, w, 3)) < 0.5, grid, rng.random((th, w, 3))).astype(np.float32)
    before = rs.LAUNCHES
    got = rs.resample_u8(torch.from_numpy(tex).to(cuda_device), ay, ax).cpu().numpy()
    assert rs.LAUNCHES == before + 1
    t64 = tex.astype(np.float64)
    if ay is not None:
        t64 = (ay.astype(np.float64) @ t64.reshape(th, -1)).reshape(oh, w, 3)
    if ax is not None:
        t64 = np.matmul(ax.astype(np.float64)[None], t64)
    scaled = np.clip(t64, 0.0, 1.0) * 255.0
    edge = np.abs(scaled - np.floor(scaled) - 0.5) < 1e-4
    diff = np.abs(got.astype(np.int32) - np.round(scaled).astype(np.int32))
    assert diff.max() <= 1 and (diff[~edge] == 0).all()


@pytest.mark.parametrize("wrap", WRAP_MODES)
@pytest.mark.parametrize("linear", [False, True], ids=["nearest", "linear"])
def test_warp_kernel_equals_plain_gather(cuda_device, linear, wrap):
    rng = np.random.default_rng(13)
    tex = torch.from_numpy(rng.random((24, 40, 4)).astype(np.float32)).to(cuda_device)
    u = (rng.random((16, 48)) * 1.6 - 0.3).astype(np.float32)
    v = (rng.random((16, 48)) * 1.6 - 0.3).astype(np.float32)
    u[0, :6] = [np.nan, np.inf, -np.inf, 1e10, -1e10, 3e9]
    v[1, :6] = [np.nan, np.inf, -np.inf, 1e10, -1e10, 3e9]
    u, v = torch.from_numpy(u).to(cuda_device), torch.from_numpy(v).to(cuda_device)
    before = ws.LAUNCHES
    got = ws.warp_sample(tex, u, v, filter_linear=linear, wrap_mode=wrap).cpu().numpy()
    assert ws.LAUNCHES == before + 1
    want = ws.warp_sample_plain(tex, u, v, filter_linear=linear, wrap_mode=wrap).cpu().numpy()
    assert np.array_equal(got, want, equal_nan=True)
    # A batch of textures in one launch equals the frames one by one.
    batch = torch.stack([tex, tex.flip(0).contiguous()])
    got_b = ws.warp_sample(batch, u, v, filter_linear=linear, wrap_mode=wrap).cpu().numpy()
    assert np.array_equal(got_b[0], got, equal_nan=True)
