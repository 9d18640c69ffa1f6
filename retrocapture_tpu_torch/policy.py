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
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["apply_policy", "to_device", "ifloor32", "fma32", "INT32_MIN"]

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
