"""The port on the card: its CUDA kernels against their plain versions,
and each path of the program and its front door at the benchmark's
shapes against the port's own CPU run.

Marked ``cuda``: without a CUDA device every test here skips. The file
imports neither jax nor the JAX package, so it runs on a machine that
has only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py configures jax.)
"""

import contextlib
import gc
import json
import warnings
import zlib
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import pytest
import torch

import _card
import _xbr_front_cases as front_cases
import retrocapture_tpu_torch as torch_pkg
from _mattias_standin import write_standin
from _nnedi3_standin import NAMES as NNEDI3_NAMES
from _nnedi3_standin import write_chain as write_nnedi3_chain
from _ntsc_standin import PASS1, PASS2
from _ntsc_standin import write_chain as write_ntsc_chain
from _presets import write_mip_presets, write_warp_preset, write_xphase_preset
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
from retrocapture_tpu_torch.ops.cuda import xbr_front as xf
from retrocapture_tpu_torch.ops.sampling import WRAP_MODES, _axis_matrix, _max_lod

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
    yield torch.device("cuda")
    gc.collect()  # what the test's engines kept (programs, graphs) goes back to the card
    torch.cuda.empty_cache()


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
    # The blit's other geometries at full size: the 1080p -> 1080p blit of a
    # pass at the viewport (f32 coordinates keep it from the identity), the
    # 320x240 upscale at batch 8, x ratio 3 with y ratio 4.5, x-only r 6, r 2.
    pytest.param(2, 1080, 1920, 1080, 1920, 3, id="1080p-to-1080p"),
    pytest.param(8, 240, 320, 1080, 1920, 3, id="b8-r6"),
    pytest.param(2, 240, 640, 1080, 1920, 3, id="r3-y4.5"),
    pytest.param(2, 240, 320, 240, 1920, 3, id="x-only-r6"),
    pytest.param(2, 96, 128, 192, 256, 3, id="r2"),
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


# -- the xbr front section kernel (csrc/xbr_front.cu) --------------------------

XBR_FRONT_PARAMS = (np.float32(15.0), np.float32(2.0))  # XBR_EQ_THRESHOLD, XBR_LV2_COEFFICIENT


def _xbr_front(tex, g, small, quantized, plain=False):
    if plain:
        cols, rows = g
        return xf.xbr_front_plain(tex, cols, [rows[k] for k in (-2, -1, 0, 1, 2)], *XBR_FRONT_PARAMS, small,
                                  np.float32(48.0), quantized)
    return xf.xbr_front(tex, g, *XBR_FRONT_PARAMS, small, np.float32(48.0), quantized)


# (batch, h, w, oh, row maps, channels): the cell's shape; W not a multiple
# of the tile; OH below a block's rows; 3x and non-integer row ratios;
# a downscale; scattered rows; a 3-channel texture.
XBR_FRONT_SHAPES = [
    pytest.param(64, 240, 320, 1080, "nearest", 4, id="cell-64x240x320-1080"),
    pytest.param(2, 30, 100, 90, "nearest", 4, id="w100-r3"),
    pytest.param(3, 40, 50, 10, "nearest", 4, id="oh10-downscale"),
    pytest.param(2, 48, 72, 131, "nearest", 3, id="non-integer-c3"),
    pytest.param(1, 60, 80, 270, "nearest", 4, id="r4.5"),
    pytest.param(2, 20, 33, 64, "random", 4, id="random-rows"),
]


@pytest.mark.parametrize("small", [0.0, 1.0])
@pytest.mark.parametrize("quantized", [True, False], ids=["u8-grid", "f32"])
@pytest.mark.parametrize("b,h,w,oh,kind,c", XBR_FRONT_SHAPES)
def test_xbr_front_kernel_equals_plain(cuda_device, b, h, w, oh, kind, c, quantized, small):
    """One launch a batch; S bit-equal to ``_xbr_planes`` on the card and
    on the CPU (NaN where it is NaN), with NaN and +-inf texels; then the
    same inputs without them under ``torch.equal``."""
    rng = np.random.default_rng(b + h + w + oh)
    for specials in (True, False):
        tex = torch.from_numpy(front_cases.texture(rng, b, h, w, c, quantized, specials))
        g = front_cases.gathers(h, w, oh, cuda_device, kind, rng)
        gc = (g[0].cpu(), {k: v.cpu() for k, v in g[1].items()})
        before = xf.LAUNCHES
        got = _xbr_front(tex.to(cuda_device), g, small, quantized)
        assert xf.LAUNCHES == before + 1 and got.shape == (b, 19, oh, w)
        want = _xbr_front(tex.to(cuda_device), g, small, quantized, plain=True)
        cpu = 4 if b > 4 else b  # the CPU's plain version on the first frames
        want_cpu = _xbr_front(tex[:cpu], gc, small, quantized)
        torch.cuda.synchronize()
        if specials:
            assert _same_bits(got, want) and _same_bits(got[:cpu].cpu(), want_cpu)
        else:
            assert torch.equal(got, want) and torch.equal(got[:cpu].cpu(), want_cpu)
        codes = got[:, 15:]
        assert torch.equal(codes, codes.round()) and 0 <= float(codes.min()) and float(codes.max()) <= 31


def test_xbr_front_kernel_reads_strided_textures(cuda_device):
    """A texture that is a view (channels 1-4 of six, frames and rows
    swapped) is read through its strides: the contiguous copy's S."""
    rng = np.random.default_rng(16)
    wide = torch.from_numpy(front_cases.texture(rng, 30, 3, 40, c=6)).to(cuda_device)
    tex = wide.permute(1, 0, 2, 3)[..., 1:5]
    g = front_cases.gathers(30, 40, 70, cuda_device)
    got = _xbr_front(tex, g, 0.0, True)
    assert not tex.is_contiguous() and _same_bits(got, _xbr_front(tex.contiguous(), g, 0.0, True))
    assert _same_bits(got, _xbr_front(tex, g, 0.0, True, plain=True))


def test_xbr_front_batching_rule_launches(cuda_device):
    """Under torch.func.vmap, frames that share the gathers are one launch
    and frames with gathers of their own one launch each; each frame gets
    the bits of its own launch."""
    rng = np.random.default_rng(17)
    b, h, w, oh = 4, 30, 50, 96
    tex = torch.from_numpy(front_cases.texture(rng, b, h, w)).to(cuda_device)
    g = front_cases.gathers(h, w, oh, cuda_device)
    before = xf.LAUNCHES
    got = torch.func.vmap(lambda t: _xbr_front(t[None], g, 0.0, True)[0])(tex)
    assert xf.LAUNCHES == before + 1
    want = torch.cat([_xbr_front(t[None], g, 0.0, True) for t in tex])
    assert _same_bits(got, want)
    per = [front_cases.gathers(h, w, oh, cuda_device, "random", rng) for _ in range(b)]
    cols = torch.stack([p[0] for p in per])
    rows = [torch.stack([p[1][k] for p in per]) for k in (-2, -1, 0, 1, 2)]

    def one(t, c, *r):
        return _xbr_front(t[None], (c, dict(zip((-2, -1, 0, 1, 2), r))), 1.0, True)[0]

    before = xf.LAUNCHES
    got = torch.func.vmap(one)(tex, cols, *rows)
    assert xf.LAUNCHES == before + b
    want = torch.cat([_xbr_front(tex[i:i + 1], per[i], 1.0, True) for i in range(b)])
    assert _same_bits(got, want)


def test_xbr_front_wrapper_raises(cuda_device):
    rng = np.random.default_rng(18)
    tex = torch.from_numpy(front_cases.texture(rng, 1, 12, 16)).to(cuda_device)
    g = front_cases.gathers(12, 16, 24, cuda_device)
    cols, rows = g
    before = xf.LAUNCHES
    with pytest.raises(TypeError):
        _xbr_front(tex.double(), g, 0.0, True)
    with pytest.raises(ValueError):
        _xbr_front(tex[0], g, 0.0, True)
    with pytest.raises(ValueError):
        _xbr_front(tex, (cols[:-2], rows), 0.0, True)
    with pytest.raises(ValueError):
        _xbr_front(tex, (cols.cpu(), rows), 0.0, True)  # gathers on another device
    with pytest.raises(RuntimeError):
        _xbr_front(tex.to("meta"), (cols.to("meta"), {k: v.to("meta") for k, v in rows.items()}), 0.0, True)
    assert xf.LAUNCHES == before


def test_xbr_slice_launches_the_front_kernel(cuda_device, tmp_path):
    """The xbr-lv2 slice on the card runs its front section as the kernel,
    once a batch (walked, then captured), and equals the CPU port."""
    path = write_xbr_standin(str(tmp_path))
    frames = torch.from_numpy(np.random.default_rng(19).integers(0, 256, (3, 60, 80, 3), dtype=np.uint8))
    e = torch_pkg.Engine(viewport=(480, 270), device=cuda_device)
    assert e.load_preset(path), e.last_error
    before = xf.LAUNCHES
    got = e.apply(frames.to(cuda_device), output="u8")
    assert xf.LAUNCHES == before + 2 and e.last_error is None
    cpu = torch_pkg.Engine(viewport=(480, 270), device="cpu")
    assert cpu.load_preset(path)
    assert torch.equal(got.cpu(), cpu.apply(frames, output="u8"))


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


def test_stream_lends_buffers_the_caller_may_keep(cuda_device, monkeypatch):
    """A 10-batch stream whose caller keeps every frame: every batch
    intact (no download wrote into a buffer that a kept frame views), at
    most HELD pinned readback buffers, and from the fourth batch on no
    new pinned allocation (where torch counts them)."""
    from retrocapture_tpu_torch.io import queue

    made = []

    class Recorded(queue.DeviceReadback):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(queue, "DeviceReadback", Recorded)
    stats = getattr(torch.cuda, "host_memory_stats", None)
    frames = list(np.random.default_rng(23).integers(0, 256, (40, 64, 96, 3), dtype=np.uint8))
    outs, allocs = [], []
    for n, frame in enumerate(queue.stream(iter(frames), lambda b: b.to(torch.float32) * 2.0 + 1.0, batch=4)):
        outs.append(frame)
        if stats is not None and n % 4 == 0:
            allocs.append(stats().get("num_host_alloc"))
    np.testing.assert_array_equal(np.stack(outs), np.stack(frames).astype(np.float32) * 2.0 + 1.0)
    slots = made[0]._lender._slots
    assert len(slots) == queue.HELD and all(s.buf.is_pinned() for s in slots)
    if allocs and allocs[0] is not None:
        assert allocs[3:] == [allocs[3]] * (len(allocs) - 3), allocs


def test_apply_streams_on_the_card_matches_the_cpu_port(cuda_device):
    """Within the card's gate against the CPU port (<= 1 u8 step in <= 0.1%
    of values), and
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
    """2^26 random bit-pattern triples and the edges: bit-equal to the plain
    version on the card off the NaNs, NaN where it is; the tie triple's
    modes differ for c = +2^-80 alone."""
    op, plain = FMA_MODES[mode]
    g = torch.Generator(device=cuda_device)
    g.manual_seed(31)
    a, b, c = (torch.randint(-2**31, 2**31 - 1, (1 << 26,), generator=g, device=cuda_device, dtype=torch.int32)
               .view(torch.float32) for _ in range(3))
    before = fm.LAUNCHES
    for x, y, z in ((a, b, c), _fma_edges(cuda_device)):
        assert _same_bits(op(x, y, z), plain(x, y, z)), mode
    assert fm.LAUNCHES == before + 2
    x, y, z = (t[-2:] for t in _fma_edges(cuda_device))
    assert fm.fma32(x, y, z).tolist() == [1 + 2.0**-11] * 2
    assert fm.fmaf32(x, y, z).tolist() == [1 + 2.0**-11 + 2.0**-23, 1 + 2.0**-11]


@pytest.mark.parametrize("mode", list(FMA_MODES))
def test_fma_kernel_broadcast_forms(cuda_device, mode):
    """Every operand form of the call sites on the card: a scalar in each
    position, 0-d tensors (one at a storage offset), [H, W, 1] against
    [H, W, 3], an expanded view, a strided channel, a transposed view, an
    operand 4 bytes off a 16-byte boundary (the dense path without 16-byte
    accesses), odd sizes, the main paths' tile-path forms and a 4-D form
    (the general path), on both routes (the wrapper's direct launch, which
    makes no call of the operator, and the operator): bit-equal to plain,
    the output contiguous."""
    op, plain = FMA_MODES[mode]
    g = torch.Generator(device=cuda_device)
    g.manual_seed(32)

    def r(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    hw3, hw1, hw4 = r(61, 77, 3), r(61, 77, 1), r(61, 77, 4)
    flat, flat4 = r(61 * 77 * 3 + 1), r(61 * 77 * 4 + 1)
    forms = [
        (0.92, hw3, r(61, 77, 3)), (hw3, 0.4, r(61, 77, 3)), (hw3, r(61, 77, 3), -0.25), (hw3, 12.9898, 1.0),
        (r(2)[1], hw3, 1.0), (r(61, 77), 1620.0, torch.tensor(0.123, device=cuda_device)),
        (hw1, r(61, 77, 3), hw3), (r(1, 77, 3).expand(61, 77, 3), hw1.expand(61, 77, 3), hw3),
        (r(61, 77, 3)[..., 2], 0.299, r(61, 77, 3)[..., 0]), (r(4, 61, 77), 0.5, r(4, 1, 1)),
        (r(5, 1, 3), r(4, 1), r(3)), (r(77, 61).t(), r(61, 77), r(61, 1)),
        (flat[1:].view(61, 77, 3), hw3, flat[:-1].view(61, 77, 3)), (r(1000003), r(1000003), 0.5),
        # The main paths' forms: a weight a row and a column, a channel
        # vector against a transposed operand (and off a 16-byte boundary),
        # a is b, a transposed three-channel operand, a folded strided
        # channel; and a 4-D form, the general path's.
        (hw4, r(61, 1, 1), r(61, 77, 4)), (hw4, r(1, 77, 1), r(61, 77, 4)), (hw4, r(4), r(77, 61, 4).transpose(0, 1)),
        (flat4[1:].view(61, 77, 4), r(4), r(77, 61, 4).transpose(0, 1)), (hw4, hw4, 0.5),
        (r(77, 61, 3).transpose(0, 1), 1.1, -0.5), (r(1000003 * 3)[::3], 0.5, r(1000003)),
        (r(3, 5, 7, 9), r(3, 1, 7, 1), r(5, 1, 9)),
    ]
    general = fm.general_launches()
    for k, (a, b, c) in enumerate(forms):
        want = plain(a, b, c)
        (ta, sa), (tb, sb), (tc, sc) = (fm._operand(x, n) for x, n in zip((a, b, c), "abc"))
        with _card.launched(fm, "_fma_op") as routed:
            direct = op(a, b, c)
        assert not routed, f"form {k} went through the operator on a plain call"
        for got in (direct, fm._fma_op(ta, tb, tc, sa, sb, sc, 0 if mode == "fma32" else 1)):
            assert got.shape == want.shape and got.is_contiguous(), k
            assert _same_bits(got, want), (mode, k)
    assert fm.general_launches() - general == 2  # the 4-D form, on both routes


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


def test_fma_kernel_random_forms(cuda_device):
    """2000 random operand forms of 1 to 5 dimensions (scalars, 0-d tensors,
    broadcast, transposed, strided and offset views, one view in two
    places), each through the kernel's raw entry with its launch plan, into
    a result with guard words on both sides (16-byte aligned or not):
    bit-equal to plain, nothing written outside the result or into an
    operand, every path taken."""
    import random

    from retrocapture_tpu_torch.ops.cuda import _build

    fn = _build.load("fma")
    rnd = random.Random(5)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(36)

    def r(shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    def operand(shape):
        kind = rnd.choice(["value", "zero_d", "full", "bcast", "bcast", "short", "transposed", "sliced", "offset"])
        s = list(shape)
        if kind == "value":
            return rnd.choice([0.5, -1.25, 3.0])
        if kind == "zero_d":
            return r(())
        if kind == "bcast":
            s = [1 if rnd.random() < 0.5 else n for n in s]
        if kind == "short":
            s = s[rnd.randint(0, len(s)):]
        if kind == "transposed" and len(s) >= 2:
            i, j = rnd.sample(range(len(s)), 2)
            t = s[:]
            t[i], t[j] = t[j], t[i]
            return r(t).transpose(i, j)
        if kind == "sliced" and s:
            return r(s[:-1] + [2 * s[-1] + 1])[..., 1::2][..., :s[-1]]
        if kind == "offset":
            return r(int(np.prod(s)) + 1)[1:].view(s)
        return r(s)

    paths = {fm.DENSE: 0, fm.TILE: 0, fm.GENERAL: 0}
    for trial in range(2000):
        nd = rnd.randint(1, 5)
        shape = [rnd.choice([1, 2, 3, 4, 5, 7, 8, 16, 31, 33, 64, 100, 257]) for _ in range(nd)]
        if nd == 4 and rnd.random() < 0.6:
            shape[3] = rnd.randint(1, 4)
        while int(np.prod(shape)) > 1 << 20:
            shape[rnd.randrange(nd)] = rnd.choice([1, 2, 3, 4, 5, 7])
        ops = [operand(shape) for _ in range(3)]
        if rnd.random() < 0.1:
            ops[2] = ops[0]
        if not any(isinstance(x, torch.Tensor) for x in ops):
            ops[0] = r(shape)
        tensors = [x if isinstance(x, torch.Tensor) else None for x in ops]
        values = [0.0 if t is not None else float(np.float32(x)) for x, t in zip(ops, tensors)]
        mode = rnd.randint(0, 1)
        plan = fm._plan(tensors)
        paths[plan.path] += 1
        guard = rnd.choice([64, 65])
        buf = torch.full((plan.numel + 2 * guard,), 7.0, device=cuda_device)
        out = buf[guard:guard + plan.numel]
        before = [t.clone() for t in tensors if t is not None]
        rc = fn(*(None if t is None else t.data_ptr() for t in tensors), *values, out.data_ptr(), plan.path,
                plan.geometry, mode, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert rc == 0, (trial, shape)
        assert bool((buf[:guard] == 7.0).all()) and bool((buf[guard + plan.numel:] == 7.0).all()), (trial, shape)
        assert all(torch.equal(a, t) for a, t in zip(before, [t for t in tensors if t is not None])), (trial, shape)
        assert _same_bits(out, fm.fma_plain(*ops, mode).reshape(-1)), (trial, shape, list(plan.geometry))
    assert all(paths.values()), paths


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


# -- the main paths at full size ------------------------------------------------
#
# Each path of the program at its operating point (a 320x240 source to a
# 1920x1080 viewport, u8 out) through two engines on the card: one that
# replays its chain by CUDA graph and one that walks it (RCTPU_REPLAY=0).
# The walked apply after the first is the one counted and recorded.

VIEWPORT = (1920, 1080)  # (W, H)
SRC_HW = (240, 320)
F32_FRAMES = 8  # the f32 apply of each engine: a batch size of its own where the path's is larger
FEEDBACK = Path(__file__).resolve().parents[1] / "assets" / "presets" / "feedback-ghost.glslp"


class MainPath(NamedTuple):
    write: Callable  # tmp_path -> the preset's path
    batch: int
    launches: dict  # {kernel: launch calls of a walked apply after the first}
    fmt: str = "rgb"
    traced: Optional[tuple] = None  # (parameter, value set between the first and the second apply)
    params: dict = {}  # const parameters set before the first apply
    env: dict = {}
    some: tuple = ()  # kernels that launch at least once a walked apply
    entries: Optional[tuple] = None  # (kernel-library entry names, engaged calls a walked apply)
    blit_from: Optional[tuple] = None  # (h, w) of the blit's input
    looks: Callable = lambda run: True  # the output is the shader's, not a passthrough


def _looks_curved(run):
    """crt-mattias: a black corner outside the curved screen, a lit centre."""
    return int(run.out[:, 0, 0].max()) == 0 and float(run.out[:, VIEWPORT[1] // 2].float().mean()) > 5


def _looks_xbr(run):
    """xbr-lv2 blends the NEAREST upscale at edges, and its entry keeps the
    axis maps of its one geometry."""
    (h, w), (vw, vh) = SRC_HW, VIEWPORT
    ys = (torch.arange(vh, device=run.out.device) * h) // vh
    xs = (torch.arange(vw, device=run.out.device) * w) // vw
    moved = float((run.out[:2] != run.frames[:2][:, ys][:, :, xs]).float().mean())
    return moved > 0.05 and len(_kept_xbr(run.engine)) == 1


def _looks_mixed(run):
    """feedback-ghost's ``mix`` goes through ``rctpu::fma``: its form with the
    channel weights as a [4] vector."""
    return any(t is not None and tuple(t.shape) == (4,) for _, a in run.rec["fma"].values() for t in a[:3])


def _warp_taps(run, linear, wrap):
    return all(a[3] is linear and a[4] == wrap and tuple(a[1].shape) == (VIEWPORT[1], VIEWPORT[0])
               for a in run.rec["warp_sample"])


def _looks_warped(run):
    """warp-curve: a black corner outside the warped screen, its tap LINEAR
    clamp_to_border."""
    return int(run.out[:, 0, 0].max()) == 0 and _warp_taps(run, True, "clamp_to_border")


def _looks_mip_warped(run):
    """mip-warp samples every level of the pyramid, LINEAR repeat."""
    (h, w) = SRC_HW
    levels = sorted({tuple(a[0].shape[1:3]) for a in run.rec["warp_sample"]}, reverse=True)
    want = [(max(h >> k, 1), max(w >> k, 1)) for k in range(MIP_LEVELS)]
    return levels == want and _warp_taps(run, True, "repeat")


def _looks_lit(run):
    return float(run.out.float().std()) > 5.0


def _looks_blurred(run):
    """mip-glow samples the pyramid: the output loses the input's fine detail."""
    return float(run.out.float().std()) < 0.6 * float(run.frames.float().std())


def _ntsc(pass1="composite", pass2="gamma"):
    return lambda tmp: write_ntsc_chain(str(tmp), 4 * SRC_HW[1], pass1, pass2)


def _nnedi3(nns, kind):
    return lambda tmp: write_nnedi3_chain(str(tmp), nns, kind, height=2 * SRC_HW[0])


NTSC_ENTRIES = tuple(PASS1.values()) + tuple(PASS2.values())
MIP_LEVELS = _max_lod(*SRC_HW) + 1

MAIN_PATHS = {
    "feedback-ghost-nv12": MainPath(lambda tmp: str(FEEDBACK), 128, {"resample_u8": 1}, fmt="nv12", some=("fma",),
                                    looks=_looks_mixed),
    "feedback-ghost-nv12 traced": MainPath(lambda tmp: str(FEEDBACK), 128, {"resample_u8": 1}, fmt="nv12",
                                           traced=("GHOST", 0.8), some=("fma",), looks=_looks_mixed),
    "warp-curve traced": MainPath(write_warp_preset, 8, {"warp_sample": 1, "resample_u8": 1}, traced=("CURV", 0.5),
                                  looks=_looks_warped),
    # Five mirrors a walk (the pows 2.2, 0.9, 0.45, the scanline and hash
    # sines; the vignette's 0.3 pow is kept by the first walk).
    "crt-mattias": MainPath(write_standin, 32, {"blur_groups": 1, "mirrors": 5, "resample_u8": 1}, some=("fma",),
                            looks=_looks_curved),
    "crt-mattias traced": MainPath(write_standin, 32, {"blur_groups": 1, "resample_u8": 1}, traced=("CURVATURE", 0.8),
                                   some=("fma", "mirrors"), looks=_looks_curved),
    "crt-mattias RCTPU_BLUR=v1": MainPath(write_standin, 32, {"blur_groups": 1, "resample_u8": 1},
                                          env={"RCTPU_BLUR": "v1"}, looks=_looks_curved),
    # A warp launch a group for the batch, on single-channel textures.
    "crt-mattias RCTPU_MATTIAS=preconv": MainPath(write_standin, 32,
                                                  {"warp_sample": 9, "blur_groups": 0, "resample_u8": 1},
                                                  env={"RCTPU_MATTIAS": "preconv"}, looks=_looks_curved),
    "xbr-lv2": MainPath(write_xbr_standin, 64, {"xbr_front": 1, "xbr_epilogue": 1, "resample_u8": 1},
                        looks=_looks_xbr),
    "xbr-lv2 small_details=1": MainPath(write_xbr_standin, 64, {"xbr_front": 1, "xbr_epilogue": 1, "resample_u8": 1},
                                        params={"small_details": 1.0}, looks=_looks_xbr),
    # Two walks an apply (the fc-period groups), two passes each.
    "ntsc-320px": MainPath(_ntsc(), 128, {"resample_u8": 1}, entries=(NTSC_ENTRIES, 4), some=("mirrors",),
                           blit_from=(VIEWPORT[1], 2 * SRC_HW[1]), looks=_looks_lit),
    "ntsc-320px svideo + gamma": MainPath(_ntsc("svideo"), 8, {"resample_u8": 1}, entries=(NTSC_ENTRIES, 4),
                                          looks=_looks_lit),
    "ntsc-320px composite + plain": MainPath(_ntsc("composite", "plain"), 8, {"resample_u8": 1},
                                             entries=(NTSC_ENTRIES, 4), looks=_looks_lit),
    "ntsc-320px composite + linear": MainPath(_ntsc("composite", "linear"), 8, {"resample_u8": 1},
                                              entries=(NTSC_ENTRIES, 4), looks=_looks_lit),
    "nnedi3 nns64 -rgb": MainPath(_nnedi3(64, "rgb"), 32, {"resample_u8": 1}, entries=(NNEDI3_NAMES, 2),
                                  some=("mirrors",), blit_from=(2 * SRC_HW[0], 2 * SRC_HW[1]), looks=_looks_lit),
    "nnedi3 nns16 -luma": MainPath(_nnedi3(16, "luma"), 8, {"resample_u8": 1}, entries=(NNEDI3_NAMES, 2),
                                   looks=_looks_lit),
    "mip-glow": MainPath(lambda tmp: write_mip_presets(tmp)[0], 4, {"resample_u8": 1},
                         blit_from=(int(SRC_HW[0] * 0.3), int(SRC_HW[1] * 0.3)), looks=_looks_blurred),
    # One warped sample a pyramid level for the batch; its level of detail
    # takes the log2 mirror.
    "mip-warp": MainPath(lambda tmp: write_mip_presets(tmp)[1], 4, {"warp_sample": MIP_LEVELS, "resample_u8": 1},
                         some=("mirrors",), looks=_looks_mip_warped),
}

class _Run(NamedTuple):
    engine: object
    out: torch.Tensor  # the walked apply's
    frames: torch.Tensor
    rec: dict  # what the walked apply recorded (_recorded_walk)


def _path_engine(case, path, device):
    e = torch_pkg.Engine(viewport=VIEWPORT, device=device)
    assert e.load_preset(path), e.last_error
    e.set_input_format(case.fmt)
    if case.traced:
        e.set_param_mode("traced")
    for name, value in case.params.items():
        assert e.set_parameter(name, value)
    return e


def _engine_ok(e):
    assert e.shader_active is True and e.last_error is None, e.last_error


def _applied(e, case, out):
    """Two applies of ``case.batch`` frames gave u8 1080p frames on the
    card, the frame count carried."""
    torch.cuda.synchronize()
    _engine_ok(e)
    assert out.shape == (case.batch, VIEWPORT[1], VIEWPORT[0], 3) and out.dtype == torch.uint8
    assert out.device == e.device
    assert int(e._states[SRC_HW + VIEWPORT].frame_count) == 2 * case.batch


def _near_u8(got, want):
    """Within 1 u8 step, in at most 0.1% of values."""
    assert got.shape == want.shape
    d = (got.cpu().to(torch.int32) - want.cpu().to(torch.int32)).abs()
    share = float((d != 0).float().mean())
    assert int(d.max()) <= 1 and share <= 1e-3, (int(d.max()), share)


def _as_u8(x):
    """f32 frames in [0, 1] as u8 codes (round half to even)."""
    x = torch.as_tensor(x)
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


@contextlib.contextmanager
def _vmap_fallbacks():
    """The ops that took vmap's per-example fallback (a loop over the
    frames, for want of a batching rule) in a block."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.filterwarnings("always", message=".*batching rule.*")
            ops = []
            yield ops
            ops.extend(str(w.message).split(".")[0] for w in caught if "batching rule" in str(w.message))
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


@contextlib.contextmanager
def _general_paths():
    """The work that left the kernels' fast paths in a block: the blit's and
    the xbr epilogue's general-path units, the warp and fma kernels'
    general-path launches, the blur kernel's wide tiles."""
    counters = {"resample_u8": rs.general_blocks, "xbr_epilogue": xe.general_blocks, "warp_sample": ws.general_launches,
                "fma": fm.general_launches, "blur_groups": bg.wide_tiles}
    for f in counters.values():
        f(reset=True)
    taken = {}
    yield taken
    taken.update({k: f(reset=True) for k, f in counters.items()})


@contextlib.contextmanager
def _entries(names):
    """Calls of the kernel library's entries ``names`` in a block that
    engaged (returned a frame) and that declined."""
    calls = {"engaged": 0, "declined": 0}
    originals = {n: tk._REGISTRY[n] for n in names}

    def wrap(fn):
        def entry(ctx, sh):
            out = fn(ctx, sh)
            calls["engaged" if out is not None else "declined"] += 1
            return out

        return entry

    tk._REGISTRY.update({n: wrap(fn) for n, fn in originals.items()})
    try:
        yield calls
    finally:
        tk._REGISTRY.update(originals)


@contextlib.contextmanager
def _kept_builds():
    """The tables a walk builds for its program to keep (only a program's
    first walk builds them; crt-mattias's comb mask is an fma launch), and
    the launch calls their builds make. A build that is not kept (no
    program, or ``keep`` false) is part of every walk and not counted."""
    made = {"keys": [], "launches": dict.fromkeys(_card.COUNTERS, 0)}
    real = tk._kept

    def kept(key, build, keep=True):
        if not keep or tk.walk_program() is None:
            return real(key, build, keep)

        def counted():
            made["keys"].append(key)
            before = _card.counts()
            try:
                return build()
            finally:
                for k, n in _card.since(before).items():
                    made["launches"][k] += n

        return real(key, counted, keep)

    tk._kept = kept
    try:
        yield made
    finally:
        tk._kept = real


@contextlib.contextmanager
def _recorded_walk(entry_names):
    """What one walked apply does: the recorded operator launches, the fma
    forms, the blit's inputs and the entries' calls."""
    from retrocapture_tpu_torch.runtime import engine as engine_module

    rec = {"blits": []}
    real_blit = engine_module.blit_u8

    def blit(tex, vw, vh):
        rec["blits"].append(tex)
        return real_blit(tex, vw, vh)

    engine_module.blit_u8 = blit
    try:
        with contextlib.ExitStack() as stack:
            for k, (module, op, _) in _card.RECORDED.items():
                rec[k] = stack.enter_context(_card.launched(module, op))
            rec["fma"] = stack.enter_context(_card.fma_forms())
            rec["entries"] = stack.enter_context(_entries(entry_names))
            yield rec
    finally:
        engine_module.blit_u8 = real_blit


@pytest.mark.parametrize("name", list(MAIN_PATHS))
def test_main_path_at_full_size(cuda_device, tmp_path, monkeypatch, name):
    """One path at the benchmark's shapes. The replayed and the walked
    engine give the same bits on every apply (u8, and f32 on F32_FRAMES
    frames); the walked apply launches each kernel as ``launches``
    says, one launch for the batch, with no kernel's work on a general
    path, no plain mirror or multiply-add on a CUDA tensor and no op on
    vmap's per-example fallback; the replayed apply makes no launch call
    but the blit's and runs every kernel as often as the walk launches it;
    each recorded launch equals its plain version on its own arguments;
    the replayed batch stays within 1 u8 step of the port's CPU run."""
    case = MAIN_PATHS[name]
    for k, v in case.env.items():
        monkeypatch.setenv(k, v)
    path = case.write(tmp_path)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(zlib.crc32(name.encode()))
    h, w = SRC_HW
    shape = (case.batch, h * 3 // 2, w) if case.fmt == "nv12" else (case.batch, h, w, 3)
    frames = [torch.randint(0, 256, shape, generator=g, device=cuda_device, dtype=torch.uint8) for _ in range(2)]
    start = _card.counts()
    with _card.plain_mirror_calls() as mirrors, _card.plain_fma_calls() as fmas, _vmap_fallbacks() as fallbacks, \
            _general_paths() as general:
        # The walk (RCTPU_REPLAY=0): the apply after the first counted and
        # recorded; the first's launches the same but for what it built for
        # the program to keep.
        monkeypatch.setenv("RCTPU_REPLAY", "0")
        e = _path_engine(case, path, cuda_device)
        before = _card.counts()
        with _kept_builds() as first_kept:
            walk = [e.apply(frames[0], output="u8")]
        first = _card.since(before)
        if case.traced:
            assert e.set_parameter(*case.traced)
        before = _card.counts()
        with _kept_builds() as later_kept, _recorded_walk(case.entries[0] if case.entries else ()) as rec:
            walk.append(e.apply(frames[1], output="u8"))
        walked = _card.since(before)
        _applied(e, case, walk[-1])
        walk.append(e.apply(frames[0][:F32_FRAMES], output="f32"))
        temporal = e._program.uses_history() or e._program.uses_feedback()
        assert {k: walked[k] for k in case.launches} == case.launches, walked
        assert all(walked[k] > 0 for k in case.some), walked
        assert later_kept["keys"] == [], f"a walk after the first built kept tables {later_kept['keys']}"
        assert {k: n - first_kept["launches"][k] for k, n in first.items()} == walked, (first, first_kept, walked)
        if case.entries:
            assert rec["entries"] == {"engaged": case.entries[1], "declined": 0}
        if case.blit_from:
            assert [tuple(t.shape) for t in rec["blits"]] == [(case.batch,) + case.blit_from + (3,)]
        for k in ("warp_sample", "blur_groups", "xbr_front", "xbr_epilogue"):
            assert len(rec[k]) == walked[k] and all(a[0].shape[0] == case.batch for a in rec[k]), k
        assert bool(torch.isfinite(walk[2]).all())
        assert case.looks(_Run(e, walk[1], frames[1], rec))
        del e
        gc.collect()
        torch.cuda.empty_cache()

        # The replay: one graph, no uncaptured apply, only the blit launched,
        # each kernel run on the device as often as the walk launches it.
        monkeypatch.setenv("RCTPU_REPLAY", "1")
        rp = _path_engine(case, path, cuda_device)
        replay = [rp.apply(frames[0], output="u8")]
        if case.traced:
            assert rp.set_parameter(*case.traced)
        before, replays = _card.counts(), rp.replay_stats()["replays"]
        replay.append(rp.apply(frames[1], output="u8"))
        calls, replays = _card.since(before), rp.replay_stats()["replays"] - replays
        _applied(rp, case, replay[-1])
        replay.append(rp.apply(frames[0][:F32_FRAMES], output="f32"))
        assert {k: n for k, n in calls.items() if n} == {"resample_u8": 1}, calls
        assert replays == (case.batch if temporal else 1)
        # A temporal chain's frame step is one graph; a stateless chain's
        # batch is one a batch size.
        stats = rp.replay_stats()
        graphs = 1 if temporal or case.batch <= F32_FRAMES else 2
        assert stats["uncaptured_applies"] == 0 and stats["graphs_captured"] == graphs, stats
        for k, (a, b) in enumerate(zip(replay, walk)):
            assert torch.equal(a, b), f"apply {k}: the replay differs from the walk"
        del walk, replay
        assert _card.kernel_runs(lambda: rp.apply(frames[1], output="u8"), walked) == walked

        # The replayed batch from a fresh state, for the CPU run below.
        rp.reset_state()
        replays = rp.replay_stats()["replays"]
        replayed = rp.apply(frames[0], output="u8")
        torch.cuda.synchronize()
        assert rp.replay_stats()["replays"] == replays + (case.batch if temporal else 1)
        del rp
        gc.collect()
        torch.cuda.empty_cache()

    # The preconv option's warp launches are single-channel: the kernel's
    # channel-at-a-time path.
    preconv = case.env.get("RCTPU_MATTIAS") == "preconv"
    total = _card.since(start)
    assert general == {k: total[k] if (k, preconv) == ("warp_sample", True) else 0 for k in general}, general
    assert not mirrors, f"a plain mirror ran on the card: {sorted(set(mirrors))}"
    assert not fmas, f"a plain fma ran on the card: {sorted(set(fmas))}"
    assert not fallbacks, f"vmap took its per-example fallback for {sorted(set(fallbacks))}"

    # Each recorded launch against its plain version on its own arguments.
    for k, (module, op, plain) in _card.RECORDED.items():
        while rec[k]:
            args = rec[k].pop()
            assert _same_bits(getattr(module, op)(*args), plain(*args)), f"{k} {tuple(args[0].shape)}"
    for _, args in rec.pop("fma").values():
        operands = [s if t is None else t for t, s in zip(args[:3], args[3:6])]
        assert _same_bits(fm._fma_call(*args), fm.fma_plain(*operands, args[6])), fm._plan(args[:3])
    for tex in rec.pop("blits"):
        assert torch.equal(rs.blit_u8(tex, *VIEWPORT), _two_tap(tex, *rs.blit_matrices(*tex.shape[1:3], *VIEWPORT)))
    del rec

    cpu = _path_engine(case, path, "cpu")
    if case.traced:
        assert cpu.set_parameter(*case.traced)
    _near_u8(replayed[:2], cpu.apply(frames[0][:2].cpu(), output="u8"))
    _engine_ok(cpu)


def test_fc_grouping_equals_ungrouped_at_full_size(cuda_device, tmp_path, monkeypatch):
    """ntsc-320px at batch 128, two applies: the fc-period grouped branch
    (2 walks of 64 frames, each with a host FrameCount) against
    ``RCTPU_FC_GROUP=0``, bit for bit."""
    path = write_ntsc_chain(str(tmp_path), 4 * SRC_HW[1])
    g = torch.Generator(device=cuda_device)
    g.manual_seed(25)
    frames = [torch.randint(0, 256, (128,) + SRC_HW + (3,), generator=g, device=cuda_device, dtype=torch.uint8)
              for _ in range(2)]
    got = {}
    for group in ("1", "0"):
        monkeypatch.setenv("RCTPU_FC_GROUP", group)
        e = torch_pkg.Engine(viewport=VIEWPORT, device=cuda_device)
        assert e.load_preset(path), e.last_error
        got[group] = [e.apply(f, output="u8") for f in frames]
        _engine_ok(e)
        assert {k[-1] for k in e._programs} == ({(2, 0)} if group == "1" else {None})
    for a, b in zip(got["1"], got["0"]):
        assert torch.equal(a, b)


def test_xphase_blit_on_the_slice_equals_the_dense_blit(cuda_device, tmp_path, monkeypatch):
    """feedback-ghost with its pass at 320x240, 128 NV12 frames to 1080p:
    under ``RCTPU_XPHASE=on`` the blit is one launch of the phase-form
    kernel, and it writes the bytes of the dense kernel's one launch."""
    (h, w), (vw, vh) = SRC_HW, VIEWPORT
    path = write_xphase_preset(tmp_path, FEEDBACK.with_suffix(".glsl"), w, h)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(11)
    frames = torch.randint(0, 256, (128, h * 3 // 2, w), generator=g, device=cuda_device, dtype=torch.uint8)
    outs = []
    for mode in ("off", "on"):
        monkeypatch.setenv("RCTPU_XPHASE", mode)
        e = torch_pkg.Engine(viewport=VIEWPORT, device=cuda_device)
        assert e.load_preset(path), e.last_error
        e.set_input_format("nv12")
        before = _card.counts()
        outs.append(e.apply(frames, output="u8"))
        _engine_ok(e)
        calls = _card.since(before)
        assert (calls["resample_u8"], calls["resample_xphase"]) == ((1, 0) if mode == "off" else (0, 1)), calls
    assert outs[0].shape == (128, vh, vw, 3) and torch.equal(outs[0], outs[1])


def test_mattias_variants_stay_near_the_default_blur(cuda_device, tmp_path, monkeypatch):
    """crt-mattias at 1080p on the card: the rank-2 blur weights
    (``RCTPU_BLUR=v1``) within 2 u8 steps of the exact ones, the
    pre-convolved blur (``RCTPU_MATTIAS=preconv``) more than 5 steps off
    in under 0.5% of values."""
    path = write_standin(str(tmp_path))
    g = torch.Generator(device=cuda_device)
    g.manual_seed(10)
    frames = torch.randint(0, 256, (2,) + SRC_HW + (3,), generator=g, device=cuda_device, dtype=torch.uint8)
    outs = {}
    for variant, env in (("default", {}), ("v1", {"RCTPU_BLUR": "v1"}), ("preconv", {"RCTPU_MATTIAS": "preconv"})):
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            e = torch_pkg.Engine(viewport=VIEWPORT, device=cuda_device)
            assert e.load_preset(path), e.last_error
            outs[variant] = e.apply(frames, output="u8").to(torch.int32)
            _engine_ok(e)
    assert int((outs["v1"] - outs["default"]).abs().max()) <= 2
    assert float(((outs["preconv"] - outs["default"]).abs() > 5).float().mean()) < 5e-3


# -- the front door at full size ------------------------------------------------
#
# Each case returns (card, CPU) pairs of u8 frames: the card's run and the
# port's own CPU run of the same frames.


def _feedback_engine(device, clamp=None):
    e = torch_pkg.Engine(viewport=VIEWPORT, device=device)
    assert e.load_preset(str(FEEDBACK)), e.last_error
    if clamp:
        e.set_max_shader_resolution(*clamp)
    return e


def _pipeline(device):
    from retrocapture_tpu_torch.runtime.pipeline import FramePipeline, ImageSettings

    e = torch_pkg.Engine(device=device)
    assert e.load_preset(str(FEEDBACK)), e.last_error
    return FramePipeline(e, logical_resolution=(160, 120), overscan_percent=(2.0, 2.0), window=VIEWPORT,
                         image=ImageSettings(brightness=1.1, contrast=0.9, flip_y=True, maintain_aspect=True))


def _front_stream(dev, tmp_path, capsys, monkeypatch):
    """The test pattern through ``io.queue.stream`` into a ``FramePipeline``
    over feedback-ghost (logical 160x120, 2% overscan, brightness 1.1,
    contrast 0.9, flip-Y, a pillarboxed 1080p window): 128 frames in
    batches of 32 come out in order and one batch late, equal to the same
    batches processed without the queue, and ``FrameStats`` counts them."""
    from retrocapture_tpu_torch.io.queue import stream
    from retrocapture_tpu_torch.io.testpattern import TestPatternSource

    src = TestPatternSource(SRC_HW[1], SRC_HW[0])
    frames = [src.capture_frame() for _ in range(128)]
    direct_p = _pipeline(dev)
    direct = [direct_p.process(np.stack(frames[i:i + 32])).cpu().numpy() for i in range(0, 128, 32)]
    _engine_ok(direct_p.engine)
    p = _pipeline(dev)
    processed = []

    def process(batch):
        assert batch.device.type == "cuda" and batch.dtype == torch.uint8
        processed.append(batch.shape[0])
        return p.process(batch)

    n = 0
    for out in stream(iter(frames), process, batch=32, device=dev):
        b = n // 32
        assert len(processed) == min(b + 2, 4), f"frame {n} came out after {len(processed)} batches"
        assert out.shape == (VIEWPORT[1], VIEWPORT[0], 3) and out.dtype == np.float32
        assert np.array_equal(out, direct[b][n % 32]), f"frame {n} is not frame {n} of the direct run"
        n += 1
    _engine_ok(p.engine)
    assert n == 128 and p.stats.frames == 128 and p.stats.batches == 4, p.stats.snapshot()
    first = direct[0][0]
    assert max(float(first[:, 0].max()), float(first[:, -1].max())) == 0.0, "no pillarbox bars"
    assert float(first[:, VIEWPORT[0] // 2].mean()) > 0.0, "no content"
    return [(_as_u8(direct[0][:2]), _as_u8(_pipeline("cpu").process(np.stack(frames[:2]))))]


def _front_apply_u8(dev, tmp_path, capsys, monkeypatch):
    """``apply_u8`` equals ``apply(output="u8")`` brought to the host, one
    blit launch; a 1280x960 source under ``set_max_shader_resolution(640,
    480)`` renders at the clamp, one blit launch, and differs from the
    unclamped output."""
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    frames = torch.randint(0, 256, (8,) + SRC_HW + (3,), generator=g, device=dev, dtype=torch.uint8)
    big = torch.randint(0, 256, (2, 960, 1280, 3), generator=g, device=dev, dtype=torch.uint8)
    rs.general_blocks(reset=True)
    before = rs.LAUNCHES
    e = _feedback_engine(dev)
    got = e.apply_u8(frames)
    _engine_ok(e)
    assert rs.LAUNCHES == before + 1
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8 and got.shape == (8, VIEWPORT[1], VIEWPORT[0], 3)
    ec = _feedback_engine(dev, clamp=(640, 480))
    assert ec._clamped_source(1280, 960) == (640, 480)
    clamped = ec.apply(big, output="u8")
    _engine_ok(ec)
    assert rs.LAUNCHES == before + 2 and rs.general_blocks(reset=True) == 0
    assert clamped.shape == (2, VIEWPORT[1], VIEWPORT[0], 3) and clamped.dtype == torch.uint8
    assert np.array_equal(got, _feedback_engine(dev).apply(frames, output="u8").cpu().numpy())
    assert float((_feedback_engine(dev).apply(big, output="u8") != clamped).float().mean()) > 0.01
    return [(torch.from_numpy(got[:2]), _feedback_engine("cpu").apply(frames[:2].cpu(), output="u8")),
            (clamped, _feedback_engine("cpu", clamp=(640, 480)).apply(big.cpu(), output="u8"))]


def _front_cli(*flags):
    def case(dev, tmp_path, capsys, monkeypatch):
        """``python -m retrocapture_tpu_torch``'s ``main`` in process: 16
        test-pattern frames through feedback-ghost to 1080p in batches of
        8, the preset named relative to the checkout; the card's .npy and
        stats, no PNG for a batch of frames. The CPU run makes the first 2
        of the same frames."""
        from retrocapture_tpu_torch import cli

        monkeypatch.chdir(FEEDBACK.parents[2])
        argv = ["--source", "test", "--preset", "assets/presets/feedback-ghost.glslp", "--viewport",
                f"{VIEWPORT[0]}x{VIEWPORT[1]}", "--batch", "8", "--stats", *flags]
        outs = {}
        for side, extra in (("card", ["--frames", "16"]), ("cpu", ["--frames", "2", "--cpu"])):
            assert cli.main(argv + extra + ["--output", str(tmp_path / side)]) == 0
            stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert stats["frames"] == int(extra[1]) and stats["shader_active"] is True, stats
            outs[side] = np.load(tmp_path / f"{side}.npy")
        out = outs["card"]
        assert out.shape == (16, VIEWPORT[1], VIEWPORT[0], 3) and out.dtype == np.float32
        assert np.isfinite(out[0]).all() and float(out[-1].std()) > 0.05
        assert not (tmp_path / "card.png").exists()
        return [(_as_u8(out[:2]), _as_u8(outs["cpu"]))]

    return case


def _front_streams(dev, tmp_path, capsys, monkeypatch):
    """``apply_streams`` of feedback-ghost on [4, 32, 240, 320, 3], two calls
    (the first through ``apply``'s 5-D branch): one graph of the 4 streams'
    step, each stream's frame count carried and each stream equal to an
    engine of its own fed that stream alone, bit for bit."""
    s, t = 4, 32
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    streams = [torch.randint(0, 256, (s, t) + SRC_HW + (3,), generator=g, device=dev, dtype=torch.uint8)
               for _ in range(2)]
    e = _feedback_engine(dev)
    outs = [e.apply(streams[0]), e.apply_streams(streams[1])]
    _engine_ok(e)
    assert outs[0].shape == (s, t, VIEWPORT[1], VIEWPORT[0], 3) and outs[0].dtype == torch.float32
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    assert e._states[SRC_HW + VIEWPORT + (s, "const")].frame_count.tolist() == [2 * t] * s
    stats = e.replay_stats()
    assert stats["graphs_captured"] == 1 and stats["uncaptured_applies"] == 0, stats
    for i in range(s):
        own = _feedback_engine(dev)
        for k, f in enumerate(streams):
            assert torch.equal(outs[k][i], own.apply(f[i])), f"stream {i}, call {k}"
    del outs
    return [(_as_u8(_feedback_engine(dev).apply_streams(streams[0][:1, :2]).cpu()),
             _as_u8(_feedback_engine("cpu").apply_streams(streams[0][:1, :2].cpu())))]


FRONT_DOOR = {
    "stream": _front_stream,
    "apply_u8 and the clamp": _front_apply_u8,
    "cli": _front_cli(),
    "cli traced": _front_cli("--param-mode", "traced", "--param", "GHOST=0.8"),
    "apply_streams": _front_streams,
}


@pytest.mark.parametrize("case", list(FRONT_DOOR))
def test_front_door_at_full_size(cuda_device, tmp_path, capsys, monkeypatch, case):
    """The program's front door at 1080p on the card, each run held to the
    port's own CPU run: within 1 u8 step in at most 0.1% of values."""
    for card, cpu in FRONT_DOOR[case](cuda_device, tmp_path, capsys, monkeypatch):
        _near_u8(card, cpu)
