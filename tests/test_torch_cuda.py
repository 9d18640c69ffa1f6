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

import retrocapture_tpu_torch as torch_pkg
from _mattias_standin import write_standin
from _nnedi3_standin import write_chain as write_nnedi3_chain
from _ntsc_standin import write_chain as write_ntsc_chain
from _xbr_standin import write_standin as write_xbr_standin
from retrocapture_tpu_torch import policy
from retrocapture_tpu_torch.graph import kernels as tk
from retrocapture_tpu_torch.graph.kernels import mattias_groups, mattias_uv
from retrocapture_tpu_torch.ops.cuda import blur_groups as bg
from retrocapture_tpu_torch.ops.cuda import fma as fm
from retrocapture_tpu_torch.ops.cuda import mirrors as mr
from retrocapture_tpu_torch.ops.cuda import resample as rs
from retrocapture_tpu_torch.ops.cuda import warp_sample as ws
from retrocapture_tpu_torch.ops.cuda import xbr_epilogue as xe
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


@pytest.mark.parametrize("wrap", WRAP_MODES)
@pytest.mark.parametrize("hw", [(1, 2), (3, 4), (7, 10)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_warp_kernel_equals_plain_at_pyramid_top_sizes(cuda_device, hw, wrap):
    """The upper levels of a warped mip tap: a texture of one to a few
    texels sampled several widths outside [0, 1], so every tap wraps or
    clamps. Bit-equal to the plain gather, LINEAR and NEAREST."""
    rng = np.random.default_rng(17)
    tex = torch.from_numpy(rng.random((hw[0], hw[1], 4)).astype(np.float32)).to(cuda_device)
    u = torch.from_numpy((rng.random((64, 96)) * 10.0 - 4.5).astype(np.float32)).to(cuda_device)
    v = torch.from_numpy((rng.random((64, 96)) * 10.0 - 4.5).astype(np.float32)).to(cuda_device)
    for linear in (False, True):
        got = ws.warp_sample(tex, u, v, filter_linear=linear, wrap_mode=wrap)
        want = ws.warp_sample_plain(tex, u, v, filter_linear=linear, wrap_mode=wrap)
        assert torch.equal(got, want), (linear, float((got - want).abs().max()))


@pytest.mark.parametrize("formulation", ["v1", "v2"])
def test_blur_kernel_equals_plain(cuda_device, formulation, monkeypatch):
    monkeypatch.setenv("RCTPU_BLUR", formulation)
    rng = np.random.default_rng(17)
    tex = torch.from_numpy(rng.random((2, 60, 80, 3)).astype(np.float32)).to(cuda_device)
    u, v = mattias_uv(256, 128, 0.5, cuda_device)
    u = u.clone()
    u[0, :6] = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e10, -1e10, 3e9])
    groups = mattias_groups(256, 128)
    before = bg.LAUNCHES
    got = bg.blur5x5_groups(tex, u, v, groups)
    assert bg.LAUNCHES == before + 1
    want = bg.blur5x5_groups_plain(tex, u, v, groups, bg.weight_tables(groups, formulation))
    for ch in (0, 1, 2):
        assert got[ch].shape == (2, 128, 256)
        assert torch.equal(got[ch], want[ch])
    one = bg.blur5x5_groups(tex[1], u, v, groups)
    assert torch.equal(one[2], got[2][1])


@pytest.mark.parametrize("w,ow,h,oh", [(320, 1920, 240, 1080), (640, 1920, None, 333), (64, 256, 48, 144)])
def test_xphase_kernel_equals_dense_kernel(cuda_device, w, ow, h, oh):
    rng = np.random.default_rng(w + oh)
    th = oh if h is None else h
    grid = (rng.integers(0, 256, size=(2, th, w, 3)) / 255.0).astype(np.float32)
    tex = np.where(rng.random((2, th, w, 3)) < 0.5, grid, rng.random((2, th, w, 3))).astype(np.float32)
    t = torch.from_numpy(tex).to(cuda_device)
    ax = _blit_axes(w, ow)
    ay = None if h is None else _blit_axes(h, oh)
    plan = rs._xphase_plan(ax, w, ow)
    before = rs.XPHASE_LAUNCHES
    got = rs.resample_u8_xphase(t, ay, plan)
    assert rs.XPHASE_LAUNCHES == before + 1
    assert torch.equal(got, rs.resample_u8(t, ay, ax))
    ytaps = None if ay is None else tuple(torch.from_numpy(x).to(cuda_device) for x in rs.axis_taps(ay))
    assert torch.equal(got, rs.resample_u8_xphase_plain(t, ytaps, plan))


def _xbr_inputs(b, w, ow, oh, seed):
    rng = np.random.default_rng(seed)
    S = np.concatenate(
        [rng.integers(0, 256, (b, 15, oh, w)), rng.integers(0, 32, (b, 4, oh, w))], axis=1
    ).astype(np.float32)
    bx = np.clip(((np.arange(ow) + 0.5) * w / ow).astype(np.int32), 0, w - 1)
    fpx = ((np.arange(ow) + 0.5) / ow * w % 1.0).astype(np.float32)
    fpy = rng.random(oh).astype(np.float32)
    return torch.from_numpy(S), bx, fpx, fpy


@pytest.mark.parametrize("w,ow,oh", [(320, 1920, 1080), (64, 128, 48), (40, 120, 30), (64, 250, 144), (80, 480, 270)])
def test_xbr_epilogue_kernel_equals_plain(cuda_device, w, ow, oh):
    S, bx, fpx, fpy = _xbr_inputs(2, w, ow, oh, w + ow)
    before = xe.LAUNCHES
    got = xe.xbr_epilogue(S.to(cuda_device), bx, fpx, fpy)
    assert xe.LAUNCHES == before + 1
    want = xe.xbr_epilogue_plain(
        S.to(cuda_device), *(torch.from_numpy(a).to(cuda_device) for a in (bx, fpx, fpy))
    )
    assert got.shape == (2, oh, ow, 4) and torch.equal(got, want)
    assert torch.equal(got.cpu(), xe.xbr_epilogue(S, bx, fpx, fpy))


def test_xbr_epilogue_wrapper_raises(cuda_device):
    S, bx, fpx, fpy = _xbr_inputs(1, 16, 32, 8, 0)
    S = S.to(cuda_device)
    before = xe.LAUNCHES
    with pytest.raises(TypeError):
        xe.xbr_epilogue(S.double(), bx, fpx, fpy)
    with pytest.raises(ValueError):
        xe.xbr_epilogue(S[:, :18], bx, fpx, fpy)
    with pytest.raises(ValueError):
        xe.xbr_epilogue(S, bx, fpx, fpy[:4])
    with pytest.raises(ValueError):
        xe.xbr_epilogue(S, bx + 16, fpx, fpy)
    with pytest.raises(RuntimeError):
        xe.xbr_epilogue(S.to("meta"), bx, fpx, fpy)
    assert xe.LAUNCHES == before


def test_xbr_slice_cuda_matches_cpu(cuda_device, tmp_path):
    path = write_xbr_standin(str(tmp_path))
    frames = np.random.default_rng(4).integers(0, 256, (2, 60, 80, 3), dtype=np.uint8)
    outs = []
    for dev in (cuda_device, "cpu"):
        e = torch_pkg.Engine(viewport=(480, 270), device=dev)
        assert e.load_preset(path), e.last_error
        before = xe.LAUNCHES
        outs.append(e.apply(torch.from_numpy(frames).to(dev), output="u8").cpu())
        assert e.shader_active is True and e.last_error is None
        assert xe.LAUNCHES == before + (2 if dev != "cpu" else 0)  # the batch walked, then captured
    assert torch.equal(outs[0], outs[1])


def test_mattias_slice_cuda_matches_cpu(cuda_device, tmp_path):
    path = write_standin(str(tmp_path))
    frames = np.random.default_rng(3).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    outs = []
    for dev in (cuda_device, "cpu"):
        e = torch_pkg.Engine(viewport=(256, 144), device=dev)
        assert e.load_preset(path), e.last_error
        before = bg.LAUNCHES
        outs.append(e.apply(torch.from_numpy(frames).to(dev), output="u8").cpu())
        assert e.shader_active is True and e.last_error is None
        if dev != "cpu":
            assert bg.LAUNCHES == before + 2  # the batch walked, then captured
    d = (outs[0].int() - outs[1].int()).abs()
    assert int(d.max()) <= 1 and float((d != 0).float().mean()) <= 1e-3


def _wild_uv(rng, ho, wo, device):
    """A warp that no tile's footprint fits: random coordinates over the
    whole texture and beyond, with NaN, +-inf and 1e10 in the first row."""
    u = (rng.random((ho, wo)) * 1.4 - 0.2).astype(np.float32)
    v = (rng.random((ho, wo)) * 1.4 - 0.2).astype(np.float32)
    u[0, :6] = [np.nan, np.inf, -np.inf, 1e10, -1e10, 3e9]
    v[0, 6:12] = [np.nan, np.inf, -np.inf, 1e10, -1e10, 3e9]
    return torch.from_numpy(u).to(device), torch.from_numpy(v).to(device)


# (batch, texture h, w, output h, w, warp): ragged tiles (neither output
# side a multiple of the 64 x 16 tile) on the crt-mattias warp, and the
# wild warp that sends every tile to the wide path.
BLUR_EDGES = [(3, 60, 80, 137, 203, "mattias"), (1, 48, 64, 97, 130, "mattias"), (2, 60, 80, 40, 100, "wild")]


@pytest.mark.parametrize("formulation", ["v1", "v2"])
@pytest.mark.parametrize("b,h,w,ho,wo,warp", BLUR_EDGES)
def test_blur_kernel_equals_plain_at_edges(cuda_device, monkeypatch, formulation, b, h, w, ho, wo, warp):
    monkeypatch.setenv("RCTPU_BLUR", formulation)
    rng = np.random.default_rng(ho + wo)
    tex = torch.from_numpy(rng.random((b, h, w, 3)).astype(np.float32)).to(cuda_device)
    if warp == "wild":
        u, v = _wild_uv(rng, ho, wo, cuda_device)
    else:
        u, v = mattias_uv(wo, ho, 0.5, cuda_device)
    groups = mattias_groups(wo, ho)
    bg.wide_tiles(reset=True)
    got = bg.blur5x5_groups(tex, u, v, groups)
    wide = bg.wide_tiles(reset=True)
    want = bg.blur5x5_groups_plain(tex, u, v, groups, bg.weight_tables(groups, formulation))
    for ch in (0, 1, 2):
        assert got[ch].shape == (b, ho, wo)
        assert torch.equal(got[ch], want[ch])
    if warp == "wild":
        assert wide == b * -(-ho // 16) * -(-wo // 64)  # every tile, every frame


def test_blur_kernel_mattias_1080p_takes_no_wide_tile(cuda_device):
    """At crt-mattias's own shape (one 240x320 frame to 1080p, the
    curvature at its CURVATURE=1 ceiling) every tile's footprint fits the
    shared budget."""
    rng = np.random.default_rng(7)
    tex = torch.from_numpy(rng.random((1, 240, 320, 3)).astype(np.float32)).to(cuda_device)
    groups = mattias_groups(1920, 1080)
    for curvature in (0.0, 0.5, 1.0):
        u, v = mattias_uv(1920, 1080, curvature, cuda_device)
        bg.wide_tiles(reset=True)
        got = bg.blur5x5_groups(tex, u, v, groups)
        assert bg.wide_tiles(reset=True) == 0
        want = bg.blur5x5_groups_plain(tex, u, v, groups, bg.weight_tables(groups, "v2"))
        assert all(torch.equal(got[ch], want[ch]) for ch in (0, 1, 2))


@pytest.mark.parametrize("y_identity", [False, True], ids=["y", "y-identity"])
@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("w,r", [(50, 2), (40, 3), (50, 4), (40, 5), (50, 6), (48, 3)])
def test_xphase_kernel_equals_dense_and_plain_at_edges(cuda_device, w, r, c, y_identity):
    """r = 2..6 at C = 3 and 4. At C = 3 rows of r*w*c bytes are no
    multiple of 16 (40 -> 120 is 360 bytes, 40 -> 200 is 600) but for
    48 -> 144 (432), so rows start off the 16-byte grid and the kernel's
    ragged heads and tails are written byte by byte. (An odd ratio of a
    50-texel row has no phase plan: f32 coordinates break its pattern.)"""
    rng = np.random.default_rng(100 * w + 10 * r + c)
    h, oh = (37, 37) if y_identity else (30, 67)
    grid = (rng.integers(0, 256, size=(2, h, w, c)) / 255.0).astype(np.float32)
    tex = np.where(rng.random((2, h, w, c)) < 0.5, grid, rng.random((2, h, w, c)) * 1.2 - 0.1).astype(np.float32)
    t = torch.from_numpy(tex).to(cuda_device)
    ax = _blit_axes(w, r * w)
    ay = None if y_identity else _blit_axes(h, oh)
    plan = rs._xphase_plan(ax, w, r * w)
    assert plan is not None and plan[0] == r
    before = rs.XPHASE_LAUNCHES
    got = rs.resample_u8_xphase(t, ay, plan)
    assert rs.XPHASE_LAUNCHES == before + 1
    assert got.shape == (2, oh, r * w, c)
    assert torch.equal(got, rs.resample_u8(t, ay, ax))
    ytaps = None if ay is None else tuple(torch.from_numpy(x).to(cuda_device) for x in rs.axis_taps(ay))
    assert torch.equal(got, rs.resample_u8_xphase_plain(t, ytaps, plan))


# -- the redesigned blit kernel -------------------------------------------------


def _knife_tex(rng, shape):
    """Half of the texels on the u8 grid n/255, a share of those one ulp to
    either side; the rest uniform in [-0.1, 1.1]."""
    grid = (rng.integers(0, 256, size=shape) / 255.0).astype(np.float32)
    nudge = rng.integers(-1, 2, size=shape)
    grid = np.where(nudge < 0, np.nextafter(grid, np.float32(-1)), np.where(nudge > 0, np.nextafter(grid, np.float32(2)), grid))
    return np.where(rng.random(shape) < 0.5, grid, rng.random(shape) * 1.2 - 0.1).astype(np.float32)


def _two_tap(t, ay, ax):
    """The blit as the kernel sums it, in torch on t's device: per axis
    ``w0*t0 + w1*t1`` over the row's two nonzeros, each product and the sum
    rounded apart (eager torch does not contract), y first; then the pack."""
    for axis, a in ((1, ay), (2, ax)):
        if a is None:
            continue
        i0, w0, i1, w1 = (torch.from_numpy(x).to(t.device) for x in rs.axis_taps(a))
        shape = (1, -1, 1, 1) if axis == 1 else (1, 1, -1, 1)
        t = w0.reshape(shape) * t.index_select(axis, i0.long()) + w1.reshape(shape) * t.index_select(axis, i1.long())
    return rs._quantize_u8(t)


def _truth_gate(tex, got, ay, ax):
    """Within 1 step of the f64 blit and exact off its knife edges."""
    t64 = torch.from_numpy(tex).double()
    if ay is not None:
        t64 = torch.einsum("os,bshc->bohc", torch.from_numpy(ay).double(), t64)
    if ax is not None:
        t64 = torch.einsum("pt,botc->bopc", torch.from_numpy(ax).double(), t64)
    scaled = (t64.clamp(0.0, 1.0) * 255.0).numpy()
    edge = np.abs(scaled - np.floor(scaled) - 0.5) < 1e-4
    diff = np.abs(got.astype(np.int32) - np.round(scaled).astype(np.int32))
    assert diff.max() <= 1 and (diff[~edge] == 0).all()


# (batch, src_h, src_w, dst_h, dst_w, channels)
BLIT_EDGES = [
    pytest.param(2, 60, 80, 135, 480, 1, id="c1"),
    pytest.param(2, 60, 80, 135, 480, 2, id="c2"),
    pytest.param(2, 60, 80, 135, 480, 3, id="c3"),
    pytest.param(2, 60, 80, 135, 480, 4, id="c4"),
    pytest.param(3, 7, 9, 11, 20, 3, id="below-a-tile"),
    pytest.param(3, 50, 37, 71, 333, 3, id="ow-333"),
    pytest.param(1, 120, 320, 90, 1077, 3, id="ow-1077"),
    pytest.param(1, 50, 37, 71, 333, 1, id="ow-333-c1"),
    pytest.param(1, 1080, 1920, 360, 640, 3, id="downscale-3"),
    pytest.param(3, 540, 960, 100, 100, 4, id="downscale-9.6-c4"),
    pytest.param(1, 224, 256, 1080, 1920, 3, id="snes-r7.5"),
    pytest.param(3, 60, 80, 270, 80, 3, id="y-only"),
    pytest.param(3, 60, 80, 60, 480, 3, id="x-only"),
    pytest.param(1, 60, 80, 60, 333, 2, id="x-only-ragged"),
    pytest.param(1, 240, 320, 1080, 1920, 3, id="b1-r6"),
    pytest.param(3, 48, 64, 144, 256, 3, id="b3-r4"),
    pytest.param(2, 270, 480, 270, 480, 3, id="near-identity"),
    pytest.param(2, 1080, 640, 1080, 1920, 3, id="ntsc-x-only-r3"),
    pytest.param(2, 480, 640, 1080, 1920, 3, id="nnedi3-r3-r2.25"),
]


@pytest.mark.parametrize("b,h,w,oh,ow,c", BLIT_EDGES)
def test_resample_kernel_at_edges(cuda_device, b, h, w, oh, ow, c):
    rng = np.random.default_rng(h + w + oh + ow + c)
    ay, ax = rs.blit_matrices(h, w, ow, oh)  # None for an identity axis
    tex = _knife_tex(rng, (b, h, w, c))
    t = torch.from_numpy(tex).to(cuda_device)
    rs.general_blocks(reset=True)
    before = rs.LAUNCHES
    got = rs.resample_u8(t, ay, ax)
    assert rs.LAUNCHES == before + 1 and rs.general_blocks(reset=True) == 0
    assert got.shape == (b, oh, ow, c) and got.dtype == torch.uint8
    assert torch.equal(got, _two_tap(t, ay, ax))
    _truth_gate(tex, got.cpu().numpy(), ay, ax)
    plain = rs.resample_u8_plain(t, *(None if a is None else torch.from_numpy(a).to(cuda_device) for a in (ay, ax)))
    _truth_gate(tex, plain.cpu().numpy(), ay, ax)
    assert torch.equal(rs.resample_u8(t[0], ay, ax), got[0])  # [H, W, C] in, [OH, OW, C] out
    plan = None if ax is None else rs._xphase_plan(ax, w, ow)
    if plan is not None:
        assert torch.equal(got, rs.resample_u8_xphase(t, ay, plan))


def test_resample_kernel_special_values(cuda_device):
    """NaN, +-inf and out-of-range texels: what the 2-tap sums give (NaN
    stores 0, also 0 * inf), byte for byte."""
    rng = np.random.default_rng(77)
    tex = _knife_tex(rng, (2, 48, 64, 3))
    tex[0, 3, 5] = np.nan
    tex[0, 7, 9] = np.inf
    tex[1, 2, 2] = -np.inf
    tex[1, 40, 60:] = [[5.0, -3.0, 1.0]]
    tex[0, 20, 30:32, 1] = [np.inf, -np.inf]  # inf - inf between neighbours
    t = torch.from_numpy(tex).to(cuda_device)
    for vw, vh in ((250, 144), (256, 144), (64, 144), (250, 48), (21, 16)):
        ay, ax = rs.blit_matrices(48, 64, vw, vh)
        got = rs.resample_u8(t, ay, ax)
        assert torch.equal(got, _two_tap(t, ay, ax)), (vw, vh)
    assert int(got.max()) == 255 and int(got.min()) == 0


def test_resample_kernel_general_path(cuda_device):
    """A caller's matrix whose taps lie thousands of columns apart: the
    segments read from global memory in the same kernel, counted, and give
    the same bytes."""
    rng = np.random.default_rng(78)
    idx = np.arange(300)
    ax = np.zeros((300, 4000), np.float32)
    ax[idx, (idx * 13) % 4000] = 0.25
    ax[idx, 3999 - (idx * 7) % 2000] += 0.75
    ay, _ = rs.blit_matrices(20, 4000, 300, 45)
    for c in (1, 3, 4):
        t = torch.from_numpy(_knife_tex(rng, (2, 20, 4000, c))).to(cuda_device)
        for a in (ay, None):
            rs.general_blocks(reset=True)
            got = rs.resample_u8(t, a, ax)
            assert rs.general_blocks(reset=True) > 0
            assert torch.equal(got, _two_tap(t, a, ax))
    with pytest.raises(ValueError):
        rs.resample_u8(torch.zeros((1, 4, 4, 5), device=cuda_device), None, _blit_axes(4, 8))


def test_blit_u8_cache_on_the_card(cuda_device, monkeypatch):
    rng = np.random.default_rng(79)
    t = torch.from_numpy(_knife_tex(rng, (3, 60, 80, 3))).to(cuda_device)
    rs.clear_blit_cache()
    for vw, vh in ((480, 270), (333, 270), (480, 270), (80, 60), (480, 60)):
        ay, ax = rs.blit_matrices(60, 80, vw, vh)
        before = rs.LAUNCHES
        got = rs.blit_u8(t, vw, vh)
        if ay is None and ax is None:
            assert rs.LAUNCHES == before and torch.equal(got, rs._quantize_u8(t))
            continue
        assert rs.LAUNCHES == before + 1
        assert torch.equal(got, rs.resample_u8(t, ay, ax))
        assert torch.equal(rs.blit_u8(t[..., :1].contiguous(), vw, vh), got[..., :1])  # another C, same plan
    assert len(rs._BLIT_CACHE) == 4
    monkeypatch.setenv("RCTPU_XPHASE", "on")
    before = rs.XPHASE_LAUNCHES
    assert torch.equal(rs.blit_u8(t, 480, 270), rs.resample_u8(t, *rs.blit_matrices(60, 80, 480, 270)))
    assert torch.equal(rs.blit_u8(t, 480, 270), rs.blit_u8(t.cpu(), 480, 270).to(cuda_device))
    assert rs.XPHASE_LAUNCHES == before + 2


# -- the redesigned xbr epilogue kernel -------------------------------------------


def _xbr_S(rng, b, oh, w):
    """Colours 0..255 and, spread over the planes, every code 0..31."""
    code = rng.integers(0, 32, (b, 4, oh, w))
    code.reshape(-1)[:32] = np.arange(32)
    return np.concatenate([rng.integers(0, 256, (b, 15, oh, w)), code], axis=1).astype(np.float32)


# (batch, oh, w, ow, bx kind)
XBR_EDGES = [
    pytest.param(1, 1080, 320, 1920, "nearest", id="main-r6"),
    pytest.param(2, 48, 64, 128, "nearest", id="r2"),
    pytest.param(2, 30, 40, 120, "nearest", id="r3"),
    pytest.param(3, 270, 80, 480, "nearest", id="r6-batch3"),
    pytest.param(1, 100, 256, 1920, "nearest", id="r7.5"),
    pytest.param(2, 144, 64, 250, "nearest", id="non-integer"),
    pytest.param(2, 37, 20, 45, "nearest", id="below-a-tile"),
    pytest.param(1, 33, 100, 300, "nearest", id="ow-300"),
    pytest.param(2, 50, 300, 700, "random", id="non-monotone"),
    pytest.param(1, 40, 64, 640, "reversed", id="reversed"),
    pytest.param(1, 60, 1920, 640, "nearest", id="downscale"),
]


@pytest.mark.parametrize("b,oh,w,ow,kind", XBR_EDGES)
def test_xbr_epilogue_kernel_at_edges(cuda_device, b, oh, w, ow, kind):
    rng = np.random.default_rng(oh + w + ow)
    S = torch.from_numpy(_xbr_S(rng, b, oh, w)).to(cuda_device)
    bx = (np.arange(ow) * w) // ow
    if kind == "random":
        bx = rng.integers(0, w, ow)
    elif kind == "reversed":
        bx = bx[::-1].copy()
    bx = bx.astype(np.int32)
    fpx = ((np.arange(ow) + 0.5) / ow * w % 1.0).astype(np.float32)
    fpy = rng.random(oh).astype(np.float32)
    maps = xe.prepare_maps(bx, fpx, fpy, w, cuda_device)
    xe.general_blocks(reset=True)
    before = xe.LAUNCHES
    got = xe.xbr_epilogue(S, maps)
    assert xe.LAUNCHES == before + 1
    general = xe.general_blocks(reset=True)
    assert general == (0 if kind != "nearest" or ow >= w else maps.general_tiles * -(-oh // maps.rows) * b)
    if kind == "nearest" and ow < w:
        assert general > 0
    want = xe.xbr_epilogue_plain(S, maps.bx, maps.fpx, maps.fpy)
    assert got.shape == (b, oh, ow, 4) and torch.equal(got, want)
    assert torch.equal(got, xe.xbr_epilogue(S, bx, fpx, fpy))  # the three arrays: the same launch
    with pytest.raises(ValueError):
        xe.xbr_epilogue(S.cpu(), maps)  # maps on another device


def test_xbr_epilogue_kernel_general_path(cuda_device):
    """A bx scattered over 3000 columns: no tile's range fits shared memory,
    every block reads S from global memory, counted; the same bits."""
    rng = np.random.default_rng(80)
    b, oh, w, ow = 2, 50, 3000, 700
    S = torch.from_numpy(_xbr_S(rng, b, oh, w)).to(cuda_device)
    bx = rng.integers(0, w, ow).astype(np.int32)
    fpx, fpy = rng.random(ow).astype(np.float32), rng.random(oh).astype(np.float32)
    maps = xe.prepare_maps(bx, fpx, fpy, w, cuda_device)
    assert maps.max_n == 0 and maps.general_tiles == len(maps.tile_n)
    xe.general_blocks(reset=True)
    got = xe.xbr_epilogue(S, maps)
    assert xe.general_blocks(reset=True) == maps.general_tiles * -(-oh // maps.rows) * b
    assert torch.equal(got, xe.xbr_epilogue_plain(S, maps.bx, maps.fpx, maps.fpy))


def _kept_xbr(e):
    """What the xbr entry keeps, over the engine's programs: {key: value}."""
    return {k: v for p in e._programs.values() for k, v in p.walk.tables.items() if k[0] == "xbr-lv2"}


def test_xbr_slice_keeps_its_maps_on_the_card(cuda_device, tmp_path):
    path = write_xbr_standin(str(tmp_path))
    frames = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (4, 60, 80, 3), dtype=np.uint8))
    e = torch_pkg.Engine(viewport=(480, 270), device=cuda_device)
    assert e.load_preset(path), e.last_error
    xe.general_blocks(reset=True)
    first = e.apply(frames.to(cuda_device), output="u8")
    (geo,) = _kept_xbr(e).values()
    again = e.apply(frames.to(cuda_device), output="u8")
    assert list(_kept_xbr(e).values())[0] is geo and xe.general_blocks() == 0
    cpu = torch_pkg.Engine(viewport=(480, 270), device="cpu")
    assert cpu.load_preset(path)
    want = cpu.apply(frames, output="u8")
    assert torch.equal(first.cpu(), want) and torch.equal(again.cpu(), want)
    e.set_viewport(320, 240)
    assert _kept_xbr(e) == {}
    cpu.set_viewport(320, 240)
    assert torch.equal(e.apply(frames.to(cuda_device), output="u8").cpu(), cpu.apply(frames, output="u8"))


@pytest.mark.parametrize("seed", range(4))
def test_resample_kernel_random_geometries(cuda_device, seed):
    """Random sizes, ratios (up and down), channel counts and batches, 25 a
    seed: the kernel's bytes are the 2-tap sums' at every one."""
    rng = np.random.default_rng(1000 + seed)
    for _ in range(25):
        b, c = int(rng.integers(1, 4)), int(rng.integers(1, 5))
        h, w, oh, ow = (int(v) for v in rng.integers(1, 420, 4))
        if rng.random() < 0.2:
            oh = h
        if rng.random() < 0.2:
            ow = w
        ay = None if oh == h else _blit_axes(h, oh)
        ax = None if ow == w else _blit_axes(w, ow)
        t = torch.from_numpy(_knife_tex(rng, (b, h, w, c))).to(cuda_device)
        rs.general_blocks(reset=True)
        got = rs.resample_u8(t, ay, ax)
        assert rs.general_blocks() == 0, (b, h, w, oh, ow, c)
        assert got.shape == (b, oh, ow, c)
        assert torch.equal(got, _two_tap(t, ay, ax)), (b, h, w, oh, ow, c)


@pytest.mark.parametrize("seed", range(2))
def test_xbr_epilogue_kernel_random_geometries(cuda_device, seed):
    rng = np.random.default_rng(2000 + seed)
    for _ in range(15):
        b = int(rng.integers(1, 4))
        oh, w, ow = (int(v) for v in rng.integers(1, 500, 3))
        S = torch.from_numpy(_xbr_S(rng, b, oh, w)).to(cuda_device)
        bx = ((np.arange(ow) * w) // ow if rng.random() < 0.7 else rng.integers(0, w, ow)).astype(np.int32)
        fpx, fpy = rng.random(ow).astype(np.float32), rng.random(oh).astype(np.float32)
        maps = xe.prepare_maps(bx, fpx, fpy, w, cuda_device)
        got = xe.xbr_epilogue(S, maps)
        assert torch.equal(got, xe.xbr_epilogue_plain(S, maps.bx, maps.fpx, maps.fpy)), (b, oh, w, ow)


# -- the frame queue, apply_streams and warped mip taps on the card ---------


def test_feeder_and_readback_order_and_latency(cuda_device):
    """8 batches of distinct contents through DeviceFeeder and
    DeviceReadback: submission n hands out batch n - 1, the flush the
    last, every batch intact (a pinned buffer is not reused before its
    copy has been taken)."""
    from retrocapture_tpu_torch.io.queue import DeviceFeeder, DeviceReadback

    feeder, readback = DeviceFeeder(cuda_device), DeviceReadback()
    rng = np.random.default_rng(21)
    batches = [rng.integers(0, 256, (4, 270, 480, 3), dtype=np.uint8) for _ in range(8)]
    outs = []
    for n, batch in enumerate(batches):
        dev = feeder.put(batch)
        assert dev.is_cuda and dev.dtype == torch.uint8 and tuple(dev.shape) == batch.shape
        batch_before = batch.copy()
        out = readback.submit(dev.to(torch.float32) * 2.0 + float(n))
        batch[:] = 0  # the caller's buffer is free again once put returns
        batches[n] = batch_before
        assert (out is None) == (n == 0)
        if out is not None:
            outs.append(out)
    outs.append(readback.flush())
    assert readback.flush() is None and len(outs) == 8
    for n, (batch, out) in enumerate(zip(batches, outs)):
        assert isinstance(out, np.ndarray) and out.dtype == np.float32
        np.testing.assert_array_equal(out, batch.astype(np.float32) * 2.0 + float(n))
    # Earlier outputs are the caller's own: later submissions did not touch them.
    np.testing.assert_array_equal(outs[0], batches[0].astype(np.float32) * 2.0)


def test_stream_on_the_card_is_in_order(cuda_device):
    from retrocapture_tpu_torch.io.queue import stream

    frames = [np.full((8, 8, 3), i, np.uint8) for i in range(21)]
    outs = list(stream(iter(frames), lambda b: b.to(torch.float32) + 0.5, batch=4))
    assert [float(o[0, 0, 0]) for o in outs] == [i + 0.5 for i in range(21)]


def test_apply_streams_on_the_card_matches_the_cpu_port(cuda_device):
    """Within chip_smoke's gate (<= 1 u8 step in <= 0.1% of values), and
    stream s equal to an engine of its own, bit for bit."""
    import os

    preset = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "presets", "feedback-ghost.glslp")
    frames = np.random.default_rng(22).integers(0, 256, (3, 4, 48, 64, 3), dtype=np.uint8)
    outs = {}
    for dev in ("cuda", "cpu"):
        e = torch_pkg.Engine(viewport=(160, 120), device=dev)
        assert e.load_preset(preset)
        outs[dev] = e.apply_streams(frames)
        assert outs[dev].device.type == dev and tuple(outs[dev].shape) == (3, 4, 120, 160, 3)
    q = {k: torch.round(v.cpu().clamp(0, 1) * 255.0).to(torch.int32) for k, v in outs.items()}
    d = (q["cuda"] - q["cpu"]).abs()
    assert int(d.max()) <= 1 and float((d != 0).float().mean()) <= 1e-3
    for s in range(3):
        own = torch_pkg.Engine(viewport=(160, 120), device="cuda")
        assert own.load_preset(preset)
        assert torch.equal(own.apply(frames[s]), outs["cuda"][s])


def test_warped_mip_launches_once_per_level(cuda_device, tmp_path):
    from chip_smoke import write_mip_presets

    _, warp = write_mip_presets(tmp_path)
    frames = np.random.default_rng(23).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    e = torch_pkg.Engine(viewport=(160, 120), device="cuda")
    assert e.load_preset(warp)
    before = ws.LAUNCHES
    out = e.apply(frames, output="u8")
    # The batch walked, then captured: a launch a level each time (levels
    # of 48x64: 48, 24, 12, 6, 3, 1 rows).
    assert ws.LAUNCHES - before == 2 * 6
    ec = torch_pkg.Engine(viewport=(160, 120), device="cpu")
    assert ec.load_preset(warp)
    d = (out.cpu().to(torch.int32) - ec.apply(frames, output="u8").to(torch.int32)).abs()
    assert int(d.max()) <= 1 and float((d != 0).float().mean()) <= 1e-3


# The library-call sections of the ntsc and nnedi3 entries: f32 matmuls
# with TF32 off (policy). Against an f64 truth, f32 accumulation of these
# sums stays within a few 1e-6 (65 band taps of at most 0.18 on [0, 1]
# data; 32 terms of N(0, 0.25) weights); TF32's 10-bit mantissa would be
# off by ~1e-4 to 1e-3, so the budget of 2e-5 tells the two apart.


def test_ntsc_band_product_on_the_card_is_f32(cuda_device):
    rng = np.random.default_rng(21)
    h, w, ow = 240, 1280, 640
    x = rng.random((h, w), np.float32)
    for wts in (tk._NTSC2_LUMA, tk._NTSC2_CHROMA):
        m = tk._ntsc_band_matrix(wts, w, ow)
        got = (torch.from_numpy(x).to(cuda_device) @ torch.from_numpy(m).to(cuda_device)).cpu().numpy()
        truth = x.astype(np.float64) @ m.astype(np.float64)
        assert np.abs(got - truth).max() <= 2e-5
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_nnedi3_contraction_on_the_card_is_f32(cuda_device):
    rng = np.random.default_rng(22)
    wt = (rng.standard_normal((128, 32)) * 0.25).astype(np.float32)
    taps = rng.random((32, 480 * 320 * 3), np.float32)
    got = (torch.from_numpy(wt).to(cuda_device) @ torch.from_numpy(taps).to(cuda_device)).cpu().numpy()
    truth = wt.astype(np.float64) @ taps.astype(np.float64)
    assert np.abs(got - truth).max() <= 2e-5
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _chain_cuda_vs_cpu(path, frames, viewport):
    outs = []
    for dev in ("cuda", "cpu"):
        e = torch_pkg.Engine(viewport=viewport, device=dev)
        assert e.load_preset(path), e.last_error
        outs.append(e.apply(torch.from_numpy(frames).to(dev), output="u8").cpu())
        assert e.shader_active is True and e.last_error is None
    d = (outs[0].int() - outs[1].int()).abs()
    assert int(d.max()) <= 1 and float((d != 0).float().mean()) <= 1e-3


@pytest.mark.parametrize("viewport", [(128, 48), (384, 144)])
@pytest.mark.parametrize("pass1,pass2", [("composite", "gamma"), ("svideo", "plain"), ("composite", "linear")])
def test_ntsc_chain_cuda_matches_cpu(cuda_device, tmp_path, pass1, pass2, viewport):
    path = write_ntsc_chain(str(tmp_path), 256, pass1, pass2)
    frames = np.random.default_rng(23).integers(0, 256, (3, 48, 64, 3), dtype=np.uint8)
    _chain_cuda_vs_cpu(path, frames, viewport)


@pytest.mark.parametrize("nns,kind", [(16, "luma"), (64, "rgb")])
def test_nnedi3_chain_cuda_matches_cpu(cuda_device, tmp_path, nns, kind):
    path = write_nnedi3_chain(str(tmp_path), nns, kind, height=48)
    frames = np.random.default_rng(24).integers(0, 256, (2, 24, 32, 3), dtype=np.uint8)
    _chain_cuda_vs_cpu(path, frames, (192, 108))


# -- replay by CUDA graph (runtime/replay.py) -----------------------------------

REPLAY_SRC_HW = (48, 64)


def _replay_presets(tmp_path):
    """(name, preset, input format, viewport, traced parameter change or
    None) of the slice's paths at a small size."""
    import os

    from _ntsc_standin import write_chain

    fg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "presets",
                      "feedback-ghost.glslp")
    d = str(tmp_path)
    return [
        ("feedback-ghost-nv12", fg, "nv12", (160, 120), None),
        ("feedback-ghost-nv12 traced", fg, "nv12", (160, 120), ("GHOST", 0.8)),
        ("xbr-lv2", write_xbr_standin(d), "rgb", (192, 144), None),
        ("ntsc-320px", write_chain(d, 4 * REPLAY_SRC_HW[1]), "rgb", (256, 144), None),
        ("crt-mattias traced", write_standin(d), "rgb", (256, 144), ("CURVATURE", 0.8)),
    ]


def _replay_frames(fmt, b, seed):
    h, w = REPLAY_SRC_HW
    shape = (b, h * 3 // 2, w) if fmt == "nv12" else (b, h, w, 3)
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)).cuda()


@pytest.mark.parametrize("output", ["u8", "f32"])
def test_replay_equals_the_uncaptured_walk(cuda_device, tmp_path, monkeypatch, output):
    """Each slice path replayed by graph against RCTPU_REPLAY=0 on the card,
    bit for bit, across set_parameter (traced), set_viewport, reset_state
    and load_state; no apply of the replaying engine walks uncaptured."""
    for name, path, fmt, viewport, param in _replay_presets(tmp_path):
        engines = {}
        for mode in ("1", "0"):
            e = torch_pkg.Engine(viewport=viewport)
            assert e.load_preset(path), e.last_error
            e.set_input_format(fmt)
            if param is not None:
                e.set_param_mode("traced")
            engines[mode] = e

        def both(step, seed):
            f = _replay_frames(fmt, 3, seed)
            outs = {}
            for mode, e in engines.items():
                monkeypatch.setenv("RCTPU_REPLAY", mode)
                outs[mode] = e.apply(f, output=output)
            torch.cuda.synchronize()
            assert torch.equal(outs["1"], outs["0"]), f"{name} {output}: {step}"

        both("first apply", 1)
        both("replay", 2)
        if param is not None:
            for e in engines.values():
                assert e.set_parameter(*param)
            both("set_parameter", 3)
        for mode, e in engines.items():
            e.save_state(str(tmp_path / f"{mode}.npz"))
        both("after save", 4)
        for e in engines.values():
            e.reset_state()
        both("reset_state", 5)
        for mode, e in engines.items():
            e.load_state(str(tmp_path / f"{mode}.npz"))
        both("load_state", 6)
        for e in engines.values():
            e.set_viewport(viewport[0] // 2 * 2 + 32, viewport[1])
        both("set_viewport", 7)
        stats = engines["1"].replay_stats()
        assert stats["uncaptured_applies"] == 0 and stats["graphs_captured"] >= 2 and stats["replays"] > 0, (name, stats)
        assert engines["1"]._effective_param_mode() == ("traced" if param else "const"), name


def test_capture_meets_an_unrecorded_upload_and_raises(cuda_device, tmp_path, monkeypatch):
    """A walk that asks for a host value its program did not record, inside
    the capture, raises ReplayError naming the upload; RCTPU_REPLAY=0 then
    runs the same chain."""
    from retrocapture_tpu_torch import policy
    from retrocapture_tpu_torch.runtime import engine as engine_module
    from retrocapture_tpu_torch.runtime.replay import ReplayError

    name, path, fmt, viewport, _ = _replay_presets(tmp_path)[0]
    e = torch_pkg.Engine(viewport=viewport)
    assert e.load_preset(path)
    e.set_input_format(fmt)
    real = engine_module._run_chain_impl
    walks = []

    def extra_upload(*a, **k):
        walks.append(1)
        if len(walks) > 1:  # the capture's walk meets a value the first walk did not upload
            policy.upload(np.zeros(4, np.float32), cuda_device)
        return real(*a, **k)

    monkeypatch.setattr(engine_module, "_run_chain_impl", extra_upload)
    with pytest.raises(ReplayError, match="program replay: upload 0"):
        e.apply(_replay_frames(fmt, 2, 9))
    monkeypatch.setattr(engine_module, "_run_chain_impl", real)
    monkeypatch.setenv("RCTPU_REPLAY", "0")
    e2 = torch_pkg.Engine(viewport=viewport)
    assert e2.load_preset(path)
    e2.set_input_format(fmt)
    assert e2.apply(_replay_frames(fmt, 2, 9)).shape == (2, viewport[1], viewport[0], 3)


def test_replay_counts_the_graphs_launches(cuda_device, tmp_path):
    """The wrappers count their launch calls, a walk's and a capture's, and
    a graph's replay adds none; the device runs the epilogue kernel once an
    apply of the stateless chain, for the whole batch, captured or not (its
    executions in torch.profiler's CUDA activity), and the batch's graph
    replays once an apply."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    name, path, fmt, viewport, _ = _replay_presets(tmp_path)[2]
    e = torch_pkg.Engine(viewport=viewport)
    assert e.load_preset(path)
    before = xe.LAUNCHES
    e.apply(_replay_frames(fmt, 4, 3))
    torch.cuda.synchronize()
    assert xe.LAUNCHES - before == 2  # the batch walked, then captured
    before = xe.LAUNCHES
    frames = _replay_frames(fmt, 4, 4)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        e.apply(frames)
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)  # a last record stands in for any the stop loses
        torch.cuda.synchronize()
    ran = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA and "xbr_epilogue_kernel" in ev.name]
    assert xe.LAUNCHES == before and len(ran) == 1
    assert e.replay_stats()["replays"] == 1


def test_batched_launches_equal_single_launches(cuda_device):
    """Each kernel's batching rule on the card: under torch.func.vmap a
    batch of textures with shared coordinates is one launch, and each
    frame gets the bits of that frame's own launch."""
    rng = np.random.default_rng(95)
    tex = torch.from_numpy(rng.random((4, 60, 80, 3), np.float32)).to(cuda_device)
    u = torch.from_numpy(rng.random((90, 120), np.float32) * 1.2 - 0.1).to(cuda_device)
    v = torch.from_numpy(rng.random((90, 120), np.float32) * 1.2 - 0.1).to(cuda_device)
    groups = mattias_groups(120, 90)
    bu, bv = mattias_uv(120, 90, 0.5, cuda_device, cross=True)
    S, bx, fpx, fpy = _xbr_inputs(4, 80, 240, 90, 96)
    maps = xe.prepare_maps(bx, fpx, fpy, 80, cuda_device)
    tex4 = torch.from_numpy(rng.random((4, 60, 80, 4), np.float32)).to(cuda_device)
    cases = [
        (ws, lambda t: ws.warp_sample(t, u, v, filter_linear=True), tex),
        (ws, lambda t: ws.warp_sample(t, u, v, filter_linear=True), tex4),
        (bg, lambda t: torch.stack([p for _, p in sorted(bg.blur5x5_groups(t, bu, bv, groups).items())]), tex),
        (xe, lambda s: xe.xbr_epilogue(s[None], maps)[0], S.to(cuda_device)),
        (mr, lambda t: mr.powf32(t, 0.45), tex4),
        (mr, lambda t: mr.sinf32(t * 300.0 - 150.0), tex4),
    ]
    for module, fn, batch in cases:
        before = module.LAUNCHES
        got = torch.func.vmap(fn)(batch)
        assert module.LAUNCHES == before + 1, module.__name__
        want = torch.stack([fn(x) for x in batch])
        torch.cuda.synchronize()
        assert torch.equal(got, want), module.__name__


# -- the numerics mirrors (csrc/mirrors.cu) and the redesigned warp kernel ----

SWEEP_CHUNK = 1 << 27


def _same_bits(got, want):
    """Bit-equal where the plain version is not NaN, NaN where it is."""
    wn = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), wn)) and not bool(
        ((got.view(torch.int32) != want.view(torch.int32)) & ~wn).any())


@pytest.mark.parametrize("op", ["sin", "log", "log2", "exp"])
def test_mirror_kernel_exhaustive(cuda_device, op):
    """Every one of the 2^32 f32 bit patterns, in chunks, against the plain
    version on the card."""
    before = mr.LAUNCHES
    for s in range(0, 1 << 32, SWEEP_CHUNK):
        x = torch.arange(s - 2**31, s - 2**31 + SWEEP_CHUNK, dtype=torch.int32, device=cuda_device)
        x = x.view(torch.float32)
        got = mr._mirror(x, op)
        assert _same_bits(got, mr.mirror_plain(x, op)), (op, hex(s))
    assert mr.LAUNCHES == before + (1 << 32) // SWEEP_CHUNK


@pytest.mark.parametrize("p", [0.3, 2.2, 0.9, 0.45, 2.5, 2.0, 2.4])
def test_mirror_pow_kernel(cuda_device, p):
    """The pow at each exponent the port uses (crt-mattias's four, the ntsc
    gammas), over 2^26 random bit patterns and 2^24 values in [0, 2), and
    through graph/kernels._glsl_pow."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(int(p * 100))
    c = float(np.float32(np.float32(np.float32(p) * np.float32(1.0 / np.log(2.0))) * np.float32(np.log(2.0))))
    bits = torch.randint(-2**31, 2**31 - 1, (1 << 26,), generator=g, device=cuda_device, dtype=torch.int32)
    for x in (bits.view(torch.float32), torch.rand((1 << 24,), generator=g, device=cuda_device) * 2.0):
        got = mr.powf32(x, c)
        assert _same_bits(got, mr.mirror_plain(x, "pow", c)), p
        assert torch.equal(tk._glsl_pow(x, p).view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("b", [1, 8, 32])
def test_warp_kernel_over_a_batch_equals_plain(cuda_device, b, c):
    """The redesigned warp kernel (the taps once a pixel, every frame at
    them) on a batch of textures at an odd output size, both filters, every
    wrap, special coordinates among them: bit-equal to the plain gather;
    RGBA takes the float4 path, RGB the general one."""
    rng = np.random.default_rng(100 + b + c)
    tex = torch.from_numpy(rng.random((b, 37, 53, c)).astype(np.float32)).to(cuda_device)
    u = (rng.random((101, 203)) * 1.6 - 0.3).astype(np.float32)
    v = (rng.random((101, 203)) * 1.6 - 0.3).astype(np.float32)
    u[0, :6] = [np.nan, np.inf, -np.inf, 1e10, -1e10, 3e9]
    v[1, :6] = [np.nan, np.inf, -np.inf, 1e10, -1e10, 3e9]
    u, v = torch.from_numpy(u).to(cuda_device), torch.from_numpy(v).to(cuda_device)
    for linear in (False, True):
        for wrap in WRAP_MODES:
            ws.general_launches(reset=True)
            got = ws.warp_sample(tex, u, v, filter_linear=linear, wrap_mode=wrap)
            assert ws.general_launches(reset=True) == (c != 4)
            want = ws.warp_sample_plain(tex, u, v, filter_linear=linear, wrap_mode=wrap)
            assert got.shape == (b, 101, 203, c) and _same_bits(got, want), (linear, wrap)


def test_warp_kernel_unaligned_texture_takes_the_general_path(cuda_device):
    """An RGBA texture view 4 bytes off a 16-byte boundary takes the general
    path, one 16 bytes off takes the float4 path; both bit-equal to plain."""
    rng = np.random.default_rng(7)
    n = 3 * 24 * 40 * 4
    flat = torch.from_numpy(rng.random(n + 4).astype(np.float32)).to(cuda_device)
    u = torch.from_numpy((rng.random((33, 65)) * 1.2 - 0.1).astype(np.float32)).to(cuda_device)
    v = torch.from_numpy((rng.random((33, 65)) * 1.2 - 0.1).astype(np.float32)).to(cuda_device)
    for offset, general in ((1, 1), (4, 0)):
        tex = flat[offset:offset + n].view(3, 24, 40, 4)
        for linear in (False, True):
            ws.general_launches(reset=True)
            got = ws.warp_sample(tex, u, v, filter_linear=linear, wrap_mode="mirrored_repeat")
            assert ws.general_launches(reset=True) == general
            assert torch.equal(got, ws.warp_sample_plain(tex, u, v, filter_linear=linear, wrap_mode="mirrored_repeat"))


def test_new_kernels_bit_equal_under_graph_replay(cuda_device):
    """The warp and mirror kernels captured into a CUDA graph over fixed
    buffers and replayed on new inputs give the bits of a direct launch."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(11)
    tex = torch.rand((8, 60, 80, 4), generator=g, device=cuda_device)
    u, v = mattias_uv(150, 90, 0.5, cuda_device)
    x = torch.rand((3, 4097), generator=g, device=cuda_device)

    def run():
        return (ws.warp_sample(tex, u, v, filter_linear=True, wrap_mode="clamp_to_border"),
                mr.powf32(x, 0.45), mr.sinf32(x * 2000.0 - 1000.0), mr.log2f32(x), mr.expf32(x * 200.0 - 100.0))

    run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = run()
    for seed in range(3):
        tex.copy_(torch.rand(tex.shape, generator=g, device=cuda_device))
        x.copy_(torch.rand(x.shape, generator=g, device=cuda_device))
        before = (ws.LAUNCHES, mr.LAUNCHES)
        graph.replay()
        assert (ws.LAUNCHES, mr.LAUNCHES) == before  # a replay makes no launch call
        want = run()
        torch.cuda.synchronize()
        for got, w in zip(outs, want):
            assert _same_bits(got, w), seed


@pytest.mark.parametrize("case", ["mattias const", "mattias traced", "nnedi3"])
def test_mirror_call_sites_bit_equal_to_the_plain_path(cuda_device, tmp_path, monkeypatch, case):
    """crt-mattias (const and traced, CURVATURE changed between applies) and
    nnedi3 on the card through the mirrors' kernel and through their plain
    versions on the card (the operator's CUDA implementation swapped for
    them), replayed by graph and walked: bit-equal."""
    if case == "nnedi3":
        path, viewport, hw = write_nnedi3_chain(str(tmp_path), 16, "rgb", height=48), (192, 108), (24, 32)
    else:
        path, viewport, hw = write_standin(str(tmp_path)), (256, 144), (48, 64)
    frames = [torch.from_numpy(np.random.default_rng(k).integers(0, 256, (3,) + hw + (3,), dtype=np.uint8)).cuda()
              for k in range(2)]
    kernel = mr._launch
    runs = {}
    for route in ("kernel", "plain"):
        monkeypatch.setattr(mr, "_launch", kernel if route == "kernel" else mr.mirror_plain)
        for replay in ("1", "0"):
            monkeypatch.setenv("RCTPU_REPLAY", replay)
            e = torch_pkg.Engine(viewport=viewport)
            assert e.load_preset(path), e.last_error
            if case == "mattias traced":
                e.set_param_mode("traced")
            before = mr.LAUNCHES
            outs = []
            for k, f in enumerate(frames):
                if k and case != "nnedi3":
                    assert e.set_parameter("CURVATURE", 0.8)
                outs.append(e.apply(f, output="f32"))
            torch.cuda.synchronize()
            assert e.shader_active is True and e.last_error is None
            assert (mr.LAUNCHES > before) == (route == "kernel")
            runs[route, replay] = outs
    for key, outs in runs.items():
        for got, want in zip(outs, runs["plain", "0"]):
            assert _same_bits(got, want), key


# -- the contracted multiply-add operator (csrc/fma.cu) ----------------------

FMA_MODES = {"fma32": (fm.fma32, policy.fma32), "fmaf32": (fm.fmaf32, policy.fmaf32)}


def _fma_edges(dev):
    """Every triple of NaN, +-inf, +-0, subnormals, FLT_MAX and a few
    normals, and the tie triple with c = +-2^-80."""
    vals = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1.0, -1.0, 3.4028235e38,
                         -3.4028235e38, 1.1754944e-38, 1e-45, -1e-45, 2.5e-39, 0.5, 3.0], device=dev)
    a, b, c = (t.reshape(-1) for t in torch.meshgrid(vals, vals, vals, indexing="ij"))
    tie = torch.full((2,), 1 + 2.0**-12, device=dev)
    return (torch.cat([a, tie]), torch.cat([b, tie]), torch.cat([c, torch.tensor([2.0**-80, -2.0**-80], device=dev)]))


@pytest.mark.parametrize("mode", list(FMA_MODES))
def test_fma_kernel_equals_plain(cuda_device, mode):
    """2^24 random bit-pattern triples and the edges: bit-equal to the plain
    version on the card off the NaNs, NaN where it is; the tie triple's
    modes differ for c = +2^-80 alone."""
    op, plain = FMA_MODES[mode]
    g = torch.Generator(device=cuda_device)
    g.manual_seed(31)
    a, b, c = (torch.randint(-2**31, 2**31 - 1, (1 << 24,), generator=g, device=cuda_device, dtype=torch.int32)
               .view(torch.float32) for _ in range(3))
    before = fm.LAUNCHES
    for x, y, z in ((a, b, c), _fma_edges(cuda_device)):
        assert _same_bits(op(x, y, z), plain(x, y, z)), mode
    assert fm.LAUNCHES == before + 2
    x, y, z = (t[-2:] for t in _fma_edges(cuda_device))
    assert (fm.fma32(x, y, z) != fm.fmaf32(x, y, z)).tolist() == [True, False]


@pytest.mark.parametrize("mode", list(FMA_MODES))
def test_fma_kernel_broadcast_forms(cuda_device, mode):
    """Every operand form of the call sites on the card: a scalar in each
    position, 0-d tensors (one at a storage offset), [H, W, 1] against
    [H, W, 3], an expanded view, a strided channel, a transposed view, an
    operand 4 bytes off a 16-byte boundary (the dense path without 16-byte
    accesses), odd sizes: bit-equal to plain, the output contiguous."""
    op, plain = FMA_MODES[mode]
    g = torch.Generator(device=cuda_device)
    g.manual_seed(32)

    def r(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    hw3, hw1 = r(61, 77, 3), r(61, 77, 1)
    flat = r(61 * 77 * 3 + 1)
    forms = [
        (0.92, hw3, r(61, 77, 3)), (hw3, 0.4, r(61, 77, 3)), (hw3, r(61, 77, 3), -0.25), (hw3, 12.9898, 1.0),
        (r(2)[1], hw3, 1.0), (r(61, 77), 1620.0, torch.tensor(0.123, device=cuda_device)),
        (hw1, r(61, 77, 3), hw3), (r(1, 77, 3).expand(61, 77, 3), hw1.expand(61, 77, 3), hw3),
        (r(61, 77, 3)[..., 2], 0.299, r(61, 77, 3)[..., 0]), (r(4, 61, 77), 0.5, r(4, 1, 1)),
        (r(5, 1, 3), r(4, 1), r(3)), (r(77, 61).t(), r(61, 77), r(61, 1)),
        (flat[1:].view(61, 77, 3), hw3, flat[:-1].view(61, 77, 3)), (r(1000003), r(1000003), 0.5),
    ]
    for k, (a, b, c) in enumerate(forms):
        got = op(a, b, c)
        want = plain(a, b, c)
        assert got.shape == want.shape and got.is_contiguous(), k
        assert _same_bits(got, want), (mode, k)


@pytest.mark.parametrize("mode", list(FMA_MODES))
def test_fma_kernel_under_vmap(cuda_device, mode):
    """The batch on a, b or c alone and on all three, at differing in_dims and
    logical ranks: one launch a call, the bits of a loop over the batch."""
    op, plain = FMA_MODES[mode]
    g = torch.Generator(device=cuda_device)
    g.manual_seed(33)

    def r(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    B = 6
    cases = [((r(B, 3), r(40, 50, 3), r(40, 50, 3)), (0, None, None)),
             ((r(40, 50, 3), r(3, B), 0.5), (None, 1, None)),
             ((r(40, 50), 1620.0, r(B)), (None, None, 0)),
             ((r(40, B, 50, 3), r(50, 1, B), r(B)), (1, 2, 0))]
    for operands, dims in cases:
        before = fm.LAUNCHES
        got = torch.func.vmap(op, in_dims=dims)(*operands)
        assert fm.LAUNCHES == before + 1
        want = torch.stack([plain(*(x if d is None else x.select(d, i) for x, d in zip(operands, dims)))
                            for i in range(B)])
        assert _same_bits(got, want), dims


def test_fma_kernel_graph_replay_reads_a_rewritten_scalar(cuda_device):
    """fma32 and fmaf32 with 0-d operands captured into a CUDA graph: each
    replay reads the 0-d buffers' values of its time (as a traced parameter
    or FrameCount is rewritten between applies), with no launch call."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(34)
    x = torch.rand((3, 257, 65), generator=g, device=cuda_device)
    s = torch.tensor(0.8, device=cuda_device)
    t = torch.tensor(1.5, device=cuda_device)

    def run():
        return fm.fma32(x, s, t), fm.fmaf32(t, x[..., :1], x), fm.fma32(x[0], 1620.0, s)

    run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = run()
    for k in range(3):
        s.fill_(0.1 * k - 0.3)
        t.fill_(2.0 ** -k)
        x.copy_(torch.rand(x.shape, generator=g, device=cuda_device))
        before = fm.LAUNCHES
        graph.replay()
        assert fm.LAUNCHES == before
        torch.cuda.synchronize()
        for got, plain_args, fn in zip(outs, ((x, s, t), (t, x[..., :1], x), (x[0], 1620.0, s)),
                                       (policy.fma32, policy.fmaf32, policy.fma32)):
            assert _same_bits(got, fn(*plain_args)), k


def test_fma_kernel_refuses_a_cpu_operand(cuda_device):
    """A CPU tensor beside CUDA operands (even a 0-d one, which torch would
    take) and another dtype raise; nothing is launched."""
    x = torch.zeros(8, device=cuda_device)
    before = fm.LAUNCHES
    with pytest.raises(TypeError):
        fm.fma32(x, torch.tensor(2.0), 1.0)
    with pytest.raises(TypeError):
        fm.fmaf32(x, x.double(), 1.0)
    assert fm.LAUNCHES == before


def test_fma_kernel_refuses_2_to_the_31_elements(cuda_device):
    """The kernel indexes in 32 bits: a result of 2^31 elements (expanded
    views, nothing allocated) raises before anything is launched."""
    x = torch.zeros(1, device=cuda_device).expand(1 << 16, 1 << 15)
    before = fm.LAUNCHES
    with pytest.raises(ValueError, match="elements"):
        fm.fma32(x, 2.0, 1.0)
    assert fm.LAUNCHES == before


@pytest.mark.parametrize("op", ["sin", "log", "log2", "exp", "pow"])
def test_mirror_kernel_exponent_bytes(cuda_device, op):
    """The mirror kernel over every pattern of each exponent byte where its
    arithmetic changes course (subnormals, around 1.0, sin's 120, exp's
    clamps, inf and NaN): 2^24 patterns a byte, bit-equal to the plain
    version; the pow at 0.45."""
    c = float(np.float32(np.float32(np.float32(0.45) * np.float32(1.0 / np.log(2.0))) * np.float32(np.log(2.0))))
    for byte in (0x00, 0x01, 0x66, 0x7D, 0x7E, 0x7F, 0x80, 0x85, 0x86, 0xFE, 0xFF):
        m = torch.arange(1 << 23, dtype=torch.int32, device=cuda_device) | (byte << 23)
        x = torch.cat([m, m | torch.iinfo(torch.int32).min]).view(torch.float32)
        assert _same_bits(mr._mirror(x, op, c), mr.mirror_plain(x, op, c)), (op, hex(byte))
