"""numpy-named functions on torch tensors: the evaluator's device namespace.

The reference evaluator is written against two interchangeable array
namespaces: ``np`` for compile-time-concrete values and ``jnp`` for
device values (``xp = np if all concrete else jnp``). ``jnp`` accepts
numpy operands and uploads them silently; torch does not (a numpy array
mixed into a CUDA expression raises, and a float64 one promotes the
expression). Each function here takes the device from its tensor
operands and brings every numpy operand there through
``policy.to_device``, so the ported evaluator keeps the reference's
``xp``-parametric shape with ``tnp`` in place of ``jnp``.

Python scalars are left as they are: torch treats them as weakly typed,
as JAX does. Calling a function with no tensor operand is a programming
error (the concrete path is numpy's) unless ``device`` is given.
"""

from __future__ import annotations

import numpy as np
import torch

from retrocapture_tpu_torch.policy import upload

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int32,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(dt) -> torch.dtype:
    """numpy dtype / scalar type / torch dtype -> torch dtype (x64 off)."""
    if isinstance(dt, torch.dtype):
        return dt
    return _DTYPES[np.dtype(dt)]


def _device_of(args, device=None):
    if device is not None:
        return device
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (list, tuple)):
            d = _device_of(a)
            if d is not None:
                return d
    return None


def _t(args, device=None):
    """Bring every numpy operand to the tensors' device. Python scalars
    stay scalars (weak types)."""
    dev = _device_of(args, device)
    if dev is None:
        raise TypeError("tnp: no tensor operand and no device given")
    out = []
    for a in args:
        if isinstance(a, (np.ndarray, np.generic)):
            a = upload(a, dev)
        out.append(a)
    return out


def _tt(args, device=None):
    """Like _t, but Python scalars become tensors too (for functions
    that take tensors only). A scalar takes the dtype of its tensor
    partners' category, as a weak type would."""
    dev = _device_of(args, device)
    if dev is None:
        raise TypeError("tnp: no tensor operand and no device given")
    tens = [a for a in args if isinstance(a, torch.Tensor)]
    ref = tens[0].dtype if tens else torch.float32
    out = []
    for a in args:
        if isinstance(a, (np.ndarray, np.generic)):
            a = upload(a, dev)
        elif isinstance(a, bool):
            a = upload(torch.tensor(a), dev)
        elif isinstance(a, int):
            a = upload(torch.tensor(a, dtype=torch.int32 if ref == torch.bool else ref), dev)
        elif isinstance(a, float):
            a = upload(torch.tensor(a, dtype=ref if ref.is_floating_point else torch.float32), dev)
        out.append(a)
    return out


def asarray(x, dtype=None, *, device=None):
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(device)
    else:
        if device is None:
            raise TypeError("tnp.asarray of a non-tensor needs a device")
        t = upload(x, device)
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t


# -- elementwise ---------------------------------------------------------


def where(c, a, b):
    c, a, b = _tt((c, a, b))
    return torch.where(c, a, b)


def _binary(fn):
    def f(a, b):
        a, b = _tt((a, b))
        return fn(a, b)

    return f


logical_and = _binary(torch.logical_and)
logical_or = _binary(torch.logical_or)
logical_xor = _binary(torch.logical_xor)
less = _binary(torch.lt)
greater = _binary(torch.gt)
less_equal = _binary(torch.le)
greater_equal = _binary(torch.ge)
equal = _binary(torch.eq)
not_equal = _binary(torch.ne)
maximum = _binary(torch.maximum)
arctan2 = _binary(torch.atan2)
floor_divide = _binary(torch.floor_divide)


def logical_not(a):
    (a,) = _tt((a,))
    return torch.logical_not(a)


def _unary(fn):
    def f(a):
        (a,) = _t((a,))
        return fn(a)

    return f


floor = _unary(torch.floor)
ceil = _unary(torch.ceil)
trunc = _unary(torch.trunc)
round = _unary(torch.round)  # half to even, as jnp.round
abs = _unary(torch.abs)
sqrt = _unary(torch.sqrt)
exp = _unary(torch.exp)
exp2 = _unary(torch.exp2)
log = _unary(torch.log)
log2 = _unary(torch.log2)
tan = _unary(torch.tan)
sinh = _unary(torch.sinh)
cosh = _unary(torch.cosh)
tanh = _unary(torch.tanh)
arcsin = _unary(torch.asin)
arccos = _unary(torch.acos)
arctan = _unary(torch.atan)
isnan = _unary(torch.isnan)
isinf = _unary(torch.isinf)
signbit = _unary(torch.signbit)


def sign(a):
    (a,) = _t((a,))
    # jnp.sign(NaN) is NaN; torch.sign(NaN) is 0.
    s = torch.sign(a)
    return torch.where(torch.isnan(a), a, s) if a.is_floating_point() else s


def clip(a, lo, hi):
    (a,) = _t((a,))
    return torch.clamp(a, lo, hi)


# -- shape / reduction ---------------------------------------------------


def zeros_like(a):
    return torch.zeros_like(a)


def broadcast_shapes(*shapes):
    return tuple(torch.broadcast_shapes(*[tuple(s) for s in shapes]))


def broadcast_to(a, shape_):
    (a,) = _tt((a,))
    return a.expand(tuple(shape_))


def broadcast_arrays(*arrs):
    arrs = _tt(arrs)
    return list(torch.broadcast_tensors(*arrs))


def stack(arrs, axis=0):
    arrs = _tt(list(arrs))
    return torch.stack(arrs, dim=axis)


def reshape(a, shape_):
    return a.reshape(tuple(shape_))


def swapaxes(a, i, j):
    return a.transpose(i, j)


def sum(a, axis=None, keepdims=False):
    if axis is None:
        return a.sum()
    return a.sum(dim=axis, keepdim=keepdims)


def all(a, axis=None):
    if axis is None:
        return a.all()
    if isinstance(axis, tuple):
        out = a
        for ax in sorted(axis, reverse=True):
            out = out.all(dim=ax)
        return out
    return a.all(dim=axis)


def any(a, axis=None):
    if axis is None:
        return a.any()
    return a.any(dim=axis)


def einsum(spec, *ops):
    ops = _t(ops)
    return torch.einsum(spec, *ops)


class linalg:  # noqa: N801 - mirrors jnp.linalg
    @staticmethod
    def det(a):
        return torch.linalg.det(a)

    @staticmethod
    def inv(a):
        return torch.linalg.inv(a)
