"""Numerics policy of the port: the one piece of process-wide state.

The JAX package runs with 64-bit types disabled and full-f32 matmuls
(``Precision.HIGH`` on its CPU reference path). PyTorch differs in two
ways this module pins down:

* float32 matmuls and convolutions on the card may use TF32 (~3 decimal
  digits). The resampling matmuls and the evaluator's dot products are
  f32 in the reference, so TF32 is switched off for both backends.
* torch keeps float64/int64 where JAX canonicalises to float32/int32. A
  float64 operand silently promotes a whole f32 expression, so every
  numpy -> tensor crossing goes through ``to_device``, which casts the
  way ``jnp.asarray`` does with x64 off.

``ifloor32`` is the float -> int32 texel-index conversion every sampler
path shares (the reference's ``ops/sampling._ifloor32``).

``fma32`` is ``a*b + c`` rounded once, as XLA's CPU code generator
contracts it inside a jitted fusion. Eager torch rounds the product and
the sum apart, on the CPU and in CUDA, so the port calls ``fma32``
exactly where a test shows that ``jax.jit`` of the reference function
contracts and the bits matter.

``sinf32`` is the f32 sine those fusions execute: XLA's CPU code calls
the C library's ``sinf`` for every lane, and glibc's ``sinf`` reduces
and evaluates in float64 with fixed polynomials, which float64 tensor
ops repeat bit for bit on the CPU and in CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["apply_policy", "to_device", "ifloor32", "fma32", "fmaf32", "sinf32", "INT32_MIN"]

INT32_MIN = -2147483648


def apply_policy() -> None:
    """Full float32 for matmuls and convolutions, on every backend."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


_CANON = {
    np.dtype(np.float64): np.float32,
    np.dtype(np.int64): np.int32,
    np.dtype(np.uint64): np.uint32,
    np.dtype(np.float16): np.float32,
}


def to_device(x, device) -> torch.Tensor:
    """numpy array / numpy or Python scalar / tensor -> tensor on
    ``device``, with JAX's x64-off canonicalisation (f64 -> f32,
    i64 -> i32). Python ``float`` becomes f32, ``int`` i32, ``bool``
    bool. Tensors only move; their dtype is left alone."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    canon = _CANON.get(a.dtype)
    if canon is not None:
        a = a.astype(canon)
    return torch.tensor(a, device=device)


def ifloor32(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int32 with the reference's edge semantics: NaN and
    +-inf map to INT32_MIN (x86 cvtps2dq "integer indefinite"), finite
    values beyond the int32 range saturate (XLA's convert). The finite
    path clamps in float64, which holds every int32 exactly, before it
    narrows: a direct float -> int32 cast of an out-of-range value is
    undefined in torch."""
    f = torch.floor(x)
    i = f.double().clamp(-2147483648.0, 2147483647.0).to(torch.int64).to(torch.int32)
    return torch.where(torch.isfinite(f), i, torch.full_like(i, INT32_MIN))


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return float(np.float32(x))


def fma32(a, b, c) -> torch.Tensor:
    """``a*b + c`` rounded once to float32, for f32 tensors or scalars
    (a scalar is first rounded to f32, as a weak-typed constant is).
    The product of two f32 values is exact in float64; the f64 sum is
    then narrowed to f32. That differs from a true fused multiply-add
    only where the double rounding of the sum lands otherwise (rare),
    and it runs the same on the CPU and in CUDA. At least one operand
    must be a tensor."""
    return (_f64(a) * _f64(b) + _f64(c)).to(torch.float32)


def fmaf32(a, b, c) -> torch.Tensor:
    """``a*b + c`` as an IEEE fused multiply-add in float32: one rounding
    of the exact value, what the CPU's FMA instruction and CUDA's
    ``__fmaf_rn`` give. ``fma32``'s float64 sum is rounded to odd before
    it is narrowed: where the sum is inexact (its error is known exactly,
    by Knuth's two-sum) and its last bit is even, it moves one float64 ulp
    towards the exact value. Narrowing a round-to-odd float64 to float32
    rounds the exact value correctly. This is the plain version of the
    warp kernel's arithmetic; it costs about five times ``fma32``."""
    p = _f64(a) * _f64(b)
    c = _f64(c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.contiguous().view(torch.int64)
    # A non-finite sum has a NaN error and stays as it is.
    nudge = torch.isfinite(err) & (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)  # +1 grows the magnitude
    return torch.where(nudge, bits + step, bits).view(torch.float64).to(torch.float32)


# glibc's sinf (sysdeps/ieee754/flt-32/s_sinf.c, sincosf.h): constants of
# its float64 evaluation. 2/pi * 2^24, pi/2, pi/2 * 2^-62, the sine and
# cosine minimax polynomials, and the bits of 2/pi in byte-stepped 32-bit
# windows for arguments of 120 and above.
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_HPI = float.fromhex("0x1.921FB54442D18p0")
_PI63 = float.fromhex("0x1.921FB54442D18p-62")
_SIN_S = tuple(float.fromhex(h) for h in ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))
_SIN_C = tuple(
    float.fromhex(h)
    for h in ("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5", "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")
)
_TWO_OVER_PI = 0xA2F9836E4E441529FC2757D1F534DDC0DB6295993C439041
_INV_PIO4 = [(_TWO_OVER_PI >> (184 - 8 * i)) & 0xFFFFFFFF for i in range(24)]
_M32 = 0xFFFFFFFF


def _reduce_large(x: torch.Tensor):
    """glibc's ``reduce_large``: |x| times 4/pi in 96-bit fixed point,
    from the float's own bits. uint64 arithmetic wraps; int64 wraps the
    same way, and the two logical right shifts are masked."""
    xi = x.abs().view(torch.int32).to(torch.int64)
    table = torch.tensor(_INV_PIO4, dtype=torch.int64, device=x.device)
    idx = (xi >> 26) & 15
    m = (((xi & 0xFFFFFF) | 0x800000) << ((xi >> 23) & 7)) & _M32
    res0 = (m * table[idx]) & _M32
    res1 = m * table[idx + 4]
    res2 = m * table[idx + 8]
    res0 = ((res2 >> 32) & _M32) | (res0 << 32)
    res0 = res0 + res1
    n = ((res0 + (1 << 61)) >> 62) & 3
    res0 = res0 - (n << 62)
    return res0.to(torch.float64) * _PI63, n


def sinf32(x: torch.Tensor, *, below_120: bool = False) -> torch.Tensor:
    """``sinf`` of an f32 tensor as glibc computes it (what a jitted XLA
    CPU fusion calls): quadrant reduction and a degree-7 sine or degree-8
    cosine polynomial, all in float64, rounded once to f32.
    ``below_120`` skips the large-argument reduction for callers whose
    argument is bounded (a ``mod`` result); non-finite input gives NaN
    (through the polynomials in the bounded form: inf - inf). The bound is
    the caller's promise: it is checked where the check costs no device
    synchronisation, on a CPU tensor, and raises ``ValueError`` there."""
    if below_120 and x.device.type == "cpu" and bool((x.abs() >= 120.0).any()):
        raise ValueError("sinf32(below_120=True): an argument of magnitude 120 or above")
    xd = x.to(torch.float64)
    # n = round(x * 2/pi) through 2^24 fixed point; xr = x - n * pi/2.
    r = xd * _HPI_INV
    if not below_120:
        large = x.abs() >= 120.0
        r = torch.where(large, 0.0, r)
    n = (r.to(torch.int32) + 0x800000) >> 24
    xr = xd - n.to(torch.float64) * _HPI
    # sin(x) = +sin(xr), +cos(xr), -sin(xr), -cos(xr) for n mod 4 = 0..3.
    sign = 1 - (n & 2)
    if not below_120:
        xl, nl = _reduce_large(torch.where(large, x, 1.0))  # of |x|: the sign is applied last
        xr = torch.where(large, xl, xr)
        nl = nl.to(torch.int32)
        n = torch.where(large, nl, n)
        sign = torch.where(large, torch.where(x < 0, -1, 1) * (1 - (nl & 2)), sign)
    s1, s2, s3 = _SIN_S
    c0, c1, c2, c3, c4 = _SIN_C
    x2 = xr * xr
    x3 = xr * x2
    sin = (xr + x3 * s1) + (x3 * x2) * (s2 + x2 * s3)
    x4 = x2 * x2
    cos = ((c0 + x2 * c1) + x4 * c2) + (x4 * x2) * (c3 + x2 * c4)
    out = torch.where((n & 1).bool(), cos, sin) * sign.to(torch.float64)
    if not below_120:
        out = torch.where(torch.isinf(xd), float("nan"), out)
    return out.to(torch.float32)
