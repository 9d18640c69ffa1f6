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

``logf32``, ``log2f32`` and ``expf32`` are ``jnp.log``, ``jnp.log2``
and ``jnp.exp`` as those fusions execute them: XLA emits its f32 ``log``
and ``exp`` inline (a range reduction and a polynomial in f32, the
multiply-adds contracted); the same f32 operations, with ``fma32`` where
the compiled code has an FMA, give its bits on the CPU and in CUDA.

``upload`` is how the evaluation of a frame brings a host value to the
device. Inside ``walking(program)`` the uploads of the first walk of a
program are recorded in walk order, and every later walk of the same
program takes them back from it instead of copying again (the reference
builds its chain once per key and replays it): a later walk checks each
value against the recorded one, bit for bit, and raises on a difference.
A walk being captured into a CUDA graph may not upload at all: a
host->device copy there would read a host buffer long freed at replay, so
``to_device`` and ``upload`` raise while the current stream captures.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import numpy as np
import torch

__all__ = ["apply_policy", "to_device", "upload", "bitcast", "WalkProgram", "walking", "walk_program", "unrecorded", "counting", "count", "ifloor32", "fma32", "fmaf32", "sinf32", "logf32", "log2f32", "expf32", "INT32_MIN"]

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
    bool. Tensors only move; their dtype is left alone. Raises while the
    current CUDA stream captures a graph, where a copy from the host is
    not allowed."""
    if isinstance(x, torch.Tensor):
        if x.device == torch.device(device):
            return x
        _no_capture(x, device)
        return x.to(device)
    _no_capture(x, device)
    a = np.asarray(x)
    canon = _CANON.get(a.dtype)
    if canon is not None:
        a = a.astype(canon)
    return torch.tensor(a, device=device)


def _no_capture(x, device) -> None:
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        shape = tuple(x.shape) if hasattr(x, "shape") else ()
        raise RuntimeError(
            f"host->device upload of a {type(x).__name__} {shape} while a CUDA graph is captured: "
            "the walk meets a value its program did not record"
        )


class WalkProgram:
    """What the walks of one program key share: the uploads of its first
    walk in walk order (``upload``), and ``tables``, the host tables and
    device constants the walk derives from the key alone (the hand kernels'
    geometry, the rasterizer planes, the separable tap rows). A later walk
    replays the uploads;
    ``uploads_replayed`` counts the values it took back."""

    def __init__(self):
        self.tensors: list = []
        self._hosts: list = []
        self.recorded = False  # the first walk has ended
        self.pos = 0
        self.uploads_replayed = 0
        self.tables: dict = {}
        self._sites: dict = {}  # name -> calls so far in this walk

    def site(self, name: str) -> int:
        """The ordinal of this call of ``name`` in the walk (0 for the
        first): the walk of a program runs in one order, so the ordinal
        names the call site of the chain and its loop trip."""
        n = self._sites.get(name, 0)
        self._sites[name] = n + 1
        return n

    def _take(self, x, device):
        host = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        if not self.recorded:
            t = to_device(x, device)
            self.tensors.append(t)
            self._hosts.append(np.array(host, copy=True))
            return t
        i = self.pos
        if i >= len(self.tensors):
            raise RuntimeError(f"program replay: upload {i} was not recorded (the first walk made {i})")
        want = self._hosts[i]
        t = self.tensors[i]
        if (
            host.shape != want.shape
            or host.dtype != want.dtype
            or t.device != torch.device(device)
            or np.ascontiguousarray(host).tobytes() != np.ascontiguousarray(want).tobytes()
        ):
            raise RuntimeError(
                f"program replay: upload {i} is {host.dtype}{host.shape}, recorded {want.dtype}{want.shape} "
                "with other values (a host value of the walk changed without a key change)"
            )
        self.pos = i + 1
        self.uploads_replayed += 1
        return t


# The program whose walk runs in this thread (or task), if any.
_WALK: contextvars.ContextVar = contextvars.ContextVar("retrocapture_walk", default=None)


def walk_program() -> Optional[WalkProgram]:
    """The program whose walk runs now, or None."""
    return _WALK.get()


@contextlib.contextmanager
def walking(program: Optional[WalkProgram]):
    """Run one walk of ``program``: its first walk records the uploads,
    every later one replays them from the start. None: a plain walk."""
    token = _WALK.set(program)
    if program is not None:
        program.pos = 0
        program._sites.clear()
    try:
        try:
            yield program
        except BaseException:
            if program is not None and not program.recorded:
                program.tensors.clear()  # a failed first walk records nothing
                program._hosts.clear()
            raise
        if program is not None and not program.recorded:
            program.recorded = True
        elif program is not None and program.pos != len(program.tensors):
            raise RuntimeError(
                f"program replay: the walk took {program.pos} of {len(program.tensors)} recorded uploads"
            )
    finally:
        _WALK.reset(token)


# Where the walks that run now tally what they did of one frame, if anywhere.
_COUNTS: contextvars.ContextVar = contextvars.ContextVar("retrocapture_counts", default=None)


@contextlib.contextmanager
def counting(counts: dict):
    """Let the walks in the block tally into ``counts`` (``count``)."""
    token = _COUNTS.set(counts)
    try:
        yield counts
    finally:
        _COUNTS.reset(token)


def count(site, values: dict) -> None:
    """What the walk did of one frame at ``site`` (a pass's hand entry):
    ``values`` maps a counter of ``Engine.replay_stats`` to its count a
    frame. A walk run again sets the same site again, so the counts are a
    frame's, whatever the number of walks."""
    counts = _COUNTS.get()
    if counts is not None:
        counts[site] = values


@contextlib.contextmanager
def unrecorded():
    """Uploads that a cache of their own keeps (a hand kernel's geometry,
    built once and looked up after): not part of the walk's sequence."""
    token = _WALK.set(None)
    try:
        yield
    finally:
        _WALK.reset(token)


def upload(x, device) -> torch.Tensor:
    """``to_device`` for a value the evaluation of a frame needs: recorded
    by the first walk of the active ``WalkProgram`` and taken back from it
    by every later walk. A tensor already on ``device`` passes through."""
    if isinstance(x, torch.Tensor) and x.device == torch.device(device):
        return x
    wp = _WALK.get()
    if wp is None:
        return to_device(x, device)
    return wp._take(x, device)


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
    bits = bitcast(s.contiguous(), torch.int64)
    # A non-finite sum has a NaN error and stays as it is.
    nudge = torch.isfinite(err) & (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)  # +1 grows the magnitude
    return bitcast(torch.where(nudge, bits + step, bits), torch.float64).to(torch.float32)


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
_SIN_TINY = 2.0**-12
_TWO_OVER_PI = 0xA2F9836E4E441529FC2757D1F534DDC0DB6295993C439041
_INV_PIO4 = [(_TWO_OVER_PI >> (184 - 8 * i)) & 0xFFFFFFFF for i in range(24)]
_M32 = 0xFFFFFFFF


def _reduce_large(x: torch.Tensor):
    """glibc's ``reduce_large``: |x| times 4/pi in 96-bit fixed point,
    from the float's own bits. uint64 arithmetic wraps; int64 wraps the
    same way, and the two logical right shifts are masked."""
    xi = bitcast(x.abs(), torch.int32).to(torch.int64)
    table = upload(torch.tensor(_INV_PIO4, dtype=torch.int64), x.device)
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


def bitcast(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x.view(dtype)`` for a dtype of the same element size: the bits
    read as another type. Under ``torch.func.vmap`` (where some torch
    versions have no batching rule for it) the whole batch's tensor is
    viewed and the batch dimension put back: the view keeps its shape and
    strides."""
    func = torch._C._functorch
    if func.is_batchedtensor(x):
        inner = bitcast(func.get_unwrapped(x), dtype)
        return func._add_batch_dim(inner, func.maybe_get_bdim(x), func.maybe_get_level(x))
    return x.view(dtype)


def _whole_batch(x: torch.Tensor) -> torch.Tensor:
    """``x``, or under ``torch.func.vmap`` the tensor of the whole batch
    that ``x`` is one frame of: a check of every frame's values, where a
    host read of one frame's is refused."""
    while torch._C._functorch.is_batchedtensor(x):
        x = torch._C._functorch.get_unwrapped(x)
    return x


def sinf32(x: torch.Tensor, *, below_120: bool = False) -> torch.Tensor:
    """``sinf`` of an f32 tensor as glibc computes it (what a jitted XLA
    CPU fusion calls): quadrant reduction and a degree-7 sine or degree-8
    cosine polynomial, all in float64, rounded once to f32.
    ``below_120`` skips the large-argument reduction for callers whose
    argument is bounded (a ``mod`` result); non-finite input gives NaN
    (through the polynomials in the bounded form: inf - inf). The bound is
    the caller's promise: it is checked where the check costs no device
    synchronisation, on a CPU tensor, and raises ``ValueError`` there."""
    if below_120 and x.device.type == "cpu" and bool((_whole_batch(x).abs() >= 120.0).any()):
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
    # glibc returns x itself for |x| < 2^-12: the polynomial gives the same
    # bits there but for -0.0, which it turns into +0.0.
    return torch.where(x.abs() < _SIN_TINY, x, out.to(torch.float32))


# XLA's inline f32 log and exp (the Cephes logf and expf forms), read from
# the LLVM IR and the object code of jitted ``jnp.log2`` and ``jnp.exp`` on
# the CPU. log: sqrt(1/2), the nine polynomial coefficients in the order
# the three chains use them, the two parts of ln 2 (exp shares them).
# exp: the input clamp, the five Horner coefficients. f32(1/ln 2) both.
_F32 = np.float32
_SQRTHF = float(_F32(0.7071067690849304))
_LOG_C = tuple(
    float(_F32(c))
    for c in (
        0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
        -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
        0.2000071406364441, -0.24999994039535522, 0.3333333134651184,
    )
)
_LN2_LO = float(_F32(-0.00021219444170128554))
_LN2_HI = 0.693359375
_LOG2E = float(_F32(1.4426950216293335))
_FLT_MIN = float(np.finfo(np.float32).tiny)
_EXP_LO, _EXP_HI = float(_F32(-87.80000305175781)), float(_F32(88.80000305175781))
_EXP_C = tuple(
    float(_F32(c))
    for c in (0.00019875691214110702, 0.001398199936375022, 0.008333452045917511,
              0.04166579619050026, 0.1666666567325592)
)


def logf32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of an f32 tensor as a jitted XLA CPU fusion computes
    it: the mantissa m in [sqrt(1/2), sqrt(2)) and exponent e, a degree-9
    polynomial in x = m - 1 as three chains joined by powers x^3, and ``e *
    ln 2`` added in two parts. Each multiply-add the compiled code fuses is
    ``fma32`` (it rounds like a true FMA but for rare double roundings,
    none among the values tests/test_torch_nnedi3.py and test_torch_mip.py
    check); the rest are f32 tensor operations. log(0) = -inf (of a
    subnormal too: the compiled code reads subnormals as zero), log(inf) =
    inf, NaN and negative input give NaN."""
    x = x.to(torch.float32)
    xc = torch.where(x > _FLT_MIN, x, _FLT_MIN)  # subnormals, 0 and NaN: the smallest normal
    bits = bitcast(xc, torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = bitcast((bits & -2139095041) | 0x3F000000, torch.float32)  # exponent of 0.5: m in [0.5, 1)
    small = m < _SQRTHF
    xm = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - torch.where(small, 1.0, 0.0)
    z = xm * xm
    x3 = z * xm
    a, b, c, d, f, g, h, i, j = _LOG_C
    y0 = fma32(fma32(xm, a, b), xm, c)
    y1 = fma32(fma32(xm, d, f), xm, g)
    y2 = fma32(fma32(xm, h, i), xm, j)
    p = fma32(fma32(fma32(y0, x3, y1), x3, y2), x3, e * _LN2_LO)
    r = fma32(e, _LN2_HI, fma32(z, -0.5, xm) + p)
    r = torch.where(x >= _FLT_MIN, r, float("nan"))
    r = torch.where(x.abs() < _FLT_MIN, float("-inf"), r)
    return torch.where(x == float("inf"), float("inf"), r)


def log2f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2`` as a jitted XLA CPU fusion computes it: ``logf32``
    times f32(1/ln 2)."""
    return logf32(x) * _LOG2E


def expf32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` of an f32 tensor as a jitted XLA CPU fusion computes
    it: x clamped to [-87.8, 88.8], n = floor(x / ln 2 + 1/2) clamped to
    [-127, 127], r = x - n ln 2 in two parts, a degree-5 Horner polynomial
    p, (r + p r^2 + 1) times 2^n built from n's bits (2^-127 reads as 0,
    and a subnormal result flushes to 0, as there). Each multiply-add the
    compiled code fuses is ``fma32``, as in ``logf32``. NaN stays NaN."""
    x = x.to(torch.float32)
    x = torch.where(x < _EXP_LO, _EXP_LO, x)
    x = torch.where(x > _EXP_HI, _EXP_HI, x)
    fx = torch.clamp(torch.floor(fma32(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma32(fx, -_LN2_LO, fma32(fx, -_LN2_HI, x))
    c0, c1, c2, c3, c4 = _EXP_C
    p = fma32(fma32(fma32(fma32(fma32(r, c0, c1), r, c2), r, c3), r, c4), r, 0.5)
    y = fma32(p, r * r, r) + 1.0
    n = torch.nan_to_num(fx).to(torch.int32)
    out = y * bitcast((n + 127) << 23, torch.float32)
    return torch.where(out < _FLT_MIN, 0.0, out)  # a subnormal result flushes to zero, as there
