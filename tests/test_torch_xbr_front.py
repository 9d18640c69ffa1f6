"""The xbr-lv2 front section's operator ``rctpu::xbr_front``
(ops/cuda/xbr_front.py) on the CPU: its CPU kernel and its batching rule
against a loop of the plain version ``graph.kernels._xbr_planes``, bit for
bit, and the xbr-lv2 hand kernel reaching it. (``_xbr_planes`` itself is
held to the JAX engine in tests/test_torch_xbr.py; the kernel to it in
tests/test_torch_cuda.py.)"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import retrocapture_tpu_torch as torch_pkg
from _xbr_front_cases import gathers, texture
from _xbr_standin import write_standin
from retrocapture_tpu_torch import policy
from retrocapture_tpu_torch.graph import kernels as tk
from retrocapture_tpu_torch.ops.cuda import xbr_epilogue as xe
from retrocapture_tpu_torch.ops.cuda import xbr_front as xf

PARAMS = (np.float32(15.0), np.float32(2.0))  # XBR_EQ_THRESHOLD, XBR_LV2_COEFFICIENT
Y_WEIGHT = np.float32(48.0)


def _same_bits(got, want):
    """Bit-equal where the plain version is not NaN, NaN where it is."""
    wn = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), wn)) and not bool(
        ((got.view(torch.int32) != want.view(torch.int32)) & ~wn).any())


def _planes(t, g, small, quantized):
    return tk._xbr_planes(t, g, *PARAMS, small, Y_WEIGHT, quantized)


def _front(t, g, small, quantized):
    return xf.xbr_front(t, g, *PARAMS, small, Y_WEIGHT, quantized)


@pytest.fixture
def plain_calls(monkeypatch):
    """The CPU kernel's calls of the plain version: the frames of each."""
    calls = []
    orig = xf.xbr_front_plain

    def spy(tex, *args):
        calls.append(int(tex.shape[0]))
        return orig(tex, *args)

    monkeypatch.setattr(xf, "xbr_front_plain", spy)
    return calls


@pytest.mark.parametrize("small", [0.0, 1.0])
@pytest.mark.parametrize("quantized", [True, False], ids=["u8-grid", "f32"])
@pytest.mark.parametrize("b,h,w,oh", [(1, 12, 20, 54), (3, 9, 7, 27), (2, 16, 40, 36)])
def test_operator_equals_the_plain_version(plain_calls, b, h, w, oh, quantized, small):
    """A plain call of the operator on a CPU batch: one call of its CPU
    kernel, each frame's S the bits of ``_xbr_planes`` on that frame, NaN
    and +-inf texels included; codes are integers 0..31."""
    rng = np.random.default_rng(b * 100 + h + w + oh)
    tex = torch.from_numpy(texture(rng, b, h, w, quantized=quantized))
    g = gathers(h, w, oh, "cpu")
    got = _front(tex, g, small, quantized)
    assert plain_calls == [b]
    assert got.shape == (b, 19, oh, w) and got.dtype == torch.float32
    for i in range(b):
        assert _same_bits(got[i], _planes(tex[i], g, small, quantized))
    codes = got[:, 15:]
    assert torch.equal(codes, codes.round()) and 0 <= codes.min() and codes.max() <= 31 and codes.max() > 0


@pytest.mark.parametrize("small", [0.0, 1.0])
def test_vmap_over_frames_is_one_call(plain_calls, small):
    """``torch.func.vmap`` over frames that share the gathers (what
    ``replay.stateless_batch`` does): the batching rule calls the kernel
    once with the whole batch, and each frame gets its own S."""
    rng = np.random.default_rng(7)
    tex = torch.from_numpy(texture(rng, 4, 10, 24))
    g = gathers(10, 24, 45, "cpu")
    got = torch.func.vmap(lambda t: _front(t[None], g, small, True)[0])(tex)
    assert plain_calls == [4]
    want = torch.stack([_planes(t, g, small, True) for t in tex])
    assert _same_bits(got, want)


def test_vmap_with_per_frame_gathers(plain_calls):
    """Batched index tensors (a geometry per frame): one call a frame, each
    with that frame's gathers."""
    rng = np.random.default_rng(8)
    b, h, w, oh = 3, 10, 16, 30
    tex = torch.from_numpy(texture(rng, b, h, w))
    per = [gathers(h, w, oh, "cpu", kind="random", rng=rng) for _ in range(b)]
    cols = torch.stack([p[0] for p in per])
    rows = {k: torch.stack([p[1][k] for p in per]) for k in (-2, -1, 0, 1, 2)}

    def one(t, c, r2, r1, r0, q1, q2):
        return _front(t[None], (c, {-2: r2, -1: r1, 0: r0, 1: q1, 2: q2}), 0.0, True)[0]

    got = torch.func.vmap(one)(tex, cols, *(rows[k] for k in (-2, -1, 0, 1, 2)))
    assert plain_calls == [1] * b
    want = torch.stack([_planes(tex[i], per[i], 0.0, True) for i in range(b)])
    assert _same_bits(got, want)


def test_strided_texture_and_fake():
    """A texture that is a view (channels of a wider tensor, frames
    transposed) gives the contiguous copy's S; under FakeTensorMode the
    operator gives S's shape without running."""
    rng = np.random.default_rng(9)
    wide = torch.from_numpy(texture(rng, 6, 2, 11, c=6, specials=False)).permute(1, 0, 2, 3)[..., 1:5]
    g = gathers(6, 11, 20, "cpu")
    assert not wide.is_contiguous()
    assert torch.equal(_front(wide, g, 0.0, True), _front(wide.contiguous(), g, 0.0, True))
    with FakeTensorMode() as mode:
        fake = mode.from_tensor(wide)
        fg = (mode.from_tensor(g[0]), {k: mode.from_tensor(v) for k, v in g[1].items()})
        assert _front(fake, fg, 0.0, True).shape == (2, 19, 20, 11)


def test_wrapper_raises():
    rng = np.random.default_rng(10)
    tex = torch.from_numpy(texture(rng, 1, 6, 8, specials=False))
    g = gathers(6, 8, 12, "cpu")
    cols, rows = g
    with pytest.raises(TypeError):
        _front(tex.double(), g, 0.0, True)
    with pytest.raises(ValueError):
        _front(tex[0], g, 0.0, True)  # one frame without its batch dimension
    with pytest.raises(ValueError):
        _front(tex[..., :2], g, 0.0, True)  # fewer than 3 channels
    with pytest.raises(ValueError):
        _front(tex, (cols[:-1], rows), 0.0, True)  # columns of another width
    with pytest.raises(ValueError):
        _front(tex, (cols, {**rows, 1: rows[1][:-1]}), 0.0, True)  # a row map of another height
    with pytest.raises(ValueError):
        _front(tex, (cols.int(), rows), 0.0, True)
    with pytest.raises(ValueError):
        _front(tex, (cols.to("meta"), rows), 0.0, True)  # gathers on another device
    with pytest.raises(RuntimeError):
        _front(tex.to("meta"), g, 0.0, True)


@pytest.mark.parametrize("w,tile", [(320, 160), (80, 96), (20, 32), (64, 64), (1920, 192), (257, 96)])
def test_tile_plan(w, tile):
    """The kernel's tile width pads the source row least (the larger of
    equals), a multiple of 32 within the kernel's 512 threads."""
    tile_px, rows = xf.tile_plan(w)
    assert tile_px == tile and tile_px % 32 == 0 and 32 <= tile_px <= 512 and rows >= 1


@pytest.mark.parametrize("small", [0.0, 1.0])
def test_hand_kernel_reaches_the_operator(tmp_path, monkeypatch, small):
    """``_xbr_lv2_kernel`` computes S through ``rctpu::xbr_front``: in a
    batched apply on the CPU the operator is called once with the batch,
    its S is what ``_xbr_planes`` gives each frame, and the epilogue gets
    that S."""
    path = write_standin(str(tmp_path))
    ops, epi = [], []
    orig_op, orig_epi = xf._xbr_front_op, xe.xbr_epilogue

    # The batched walk calls the wrapper with one frame of the batch; the
    # batching rule calls the operator again with the whole batch: keep
    # that call.
    def op_spy(tex, *args):
        out = orig_op(tex, *args)
        if not torch._C._functorch.is_batchedtensor(tex):
            ops.append((tex, args, out))
        return out

    def epi_spy(S, *maps):
        epi.append(policy._whole_batch(S))
        return orig_epi(S, *maps)

    monkeypatch.setattr(xf, "_xbr_front_op", op_spy)
    monkeypatch.setattr(xe, "xbr_epilogue", epi_spy)
    frames = np.random.default_rng(11).integers(0, 256, (3, 20, 24, 3), dtype=np.uint8)
    e = torch_pkg.Engine(viewport=(96, 90), device="cpu")
    assert e.load_preset(path), e.last_error
    assert e.set_parameter("small_details", small)
    out = e.apply(torch.from_numpy(frames), output="u8")
    assert e.shader_active is True and e.last_error is None and out.shape == (3, 90, 96, 3)
    assert len(ops) == 1 and len(epi) == 1
    batch, args, S = ops[0]
    assert tuple(batch.shape[:3]) == (3, 20, 24)
    assert args[8] == small and args[10] is True  # small_details, the u8 input's grid
    g = (args[0], dict(zip((-2, -1, 0, 1, 2), args[1:6])))
    want = torch.stack([_planes(t, g, small, True) for t in batch])
    assert torch.equal(S.reshape(want.shape), want)
    assert torch.equal(epi[0].reshape(want.shape), want)
