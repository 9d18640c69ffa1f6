"""retrocapture_tpu_torch.ops.colorspace against the JAX package's
colorspace functions, on the same numpy inputs (made from a seed).

Every function is elementwise f32 math with the same operation order as
its jnp original, so the expectation is bit-equality, NaN included.
Inputs: uniform random values around [0, 1], and knife-edge values
n/255 and one ulp either side, where a one-ulp difference flips an
RGBA8 or sRGB8 code.
"""

import numpy as np
import pytest
import torch

from retrocapture_tpu.ops import colorspace as jcs
from retrocapture_tpu_torch.ops import colorspace as tcs


def _inputs():
    rng = np.random.default_rng(1234)
    rand = (rng.random((48, 64, 4)) * 1.3 - 0.15).astype(np.float32)
    n = (np.arange(256, dtype=np.float32) / np.float32(255.0)).astype(np.float32)
    knife = np.concatenate(
        [
            n,
            np.nextafter(n, np.float32(2.0)),
            np.nextafter(n, np.float32(-1.0)),
            np.array([np.nan, np.inf, -np.inf, -0.0, 1e-40, 2.0], np.float32),
        ]
    ).astype(np.float32)
    knife = np.resize(knife, (knife.size // 4) * 4).reshape(-1, 4)
    return {"random": rand, "knife": knife}


INPUTS = _inputs()


def _same(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=True), float(np.nanmax(np.abs(a.astype(np.float64) - b)))


@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize("fn", ["quantize_rgba8", "srgb_store_rgb"])
def test_store_quantizers_match_jax(fn, kind):
    x = INPUTS[kind]
    _same(getattr(jcs, fn)(x), getattr(tcs, fn)(torch.from_numpy(x)))


@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize(
    "fmt", [(False, False), (True, False), (False, True), (True, True)], ids=["rgba8", "float", "srgb", "float+srgb"]
)
def test_framebuffer_store_matches_jax(fmt, kind):
    x = INPUTS[kind]
    ff, sf = fmt
    _same(
        jcs.framebuffer_store(x, float_framebuffer=ff, srgb_framebuffer=sf),
        tcs.framebuffer_store(torch.from_numpy(x), float_framebuffer=ff, srgb_framebuffer=sf),
    )


def test_packed_yuv_converters_match_jax():
    rng = np.random.default_rng(7)
    b, h, w = 2, 48, 64
    nv12 = rng.integers(0, 256, (b, h * 3 // 2, w), dtype=np.uint8)
    # The BT.601 limited-range knife points (black 16, white 235, chroma
    # 128) are in every plane.
    nv12[:, 0, :3] = [16, 235, 128]
    _same(
        jcs.nv12_to_rgb(nv12[:, :h], nv12[:, h:], w, h),
        tcs.nv12_to_rgb(torch.from_numpy(nv12[:, :h]), torch.from_numpy(nv12[:, h:]), w, h),
    )
    packed = rng.integers(0, 256, (b, h, w * 2), dtype=np.uint8)
    for name in ("yuyv_to_rgb", "uyvy_to_rgb"):
        _same(getattr(jcs, name)(packed, w, h), getattr(tcs, name)(torch.from_numpy(packed), w, h))


def test_rgb_to_unit_float_matches_jax():
    frame = np.arange(256, dtype=np.uint8).reshape(16, 16)[..., None].repeat(3, axis=-1)
    _same(jcs.rgb_to_unit_float(frame), tcs.rgb_to_unit_float(torch.from_numpy(frame)))
