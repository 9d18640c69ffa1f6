"""GLSL builtin functions over the V value model.

Component-wise math follows the GLSL 1.20/3.30 spec the corpus targets;
each function folds to NumPy when every operand is compile-time concrete
and runs torch ops otherwise (so constant subexpressions never reach the
device).

Texture builtins live in the interpreter (they need the pass binding
context); everything numeric is here.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from retrocapture_tpu_torch.frontend import tnp
from retrocapture_tpu_torch.policy import fma32
from retrocapture_tpu_torch.frontend.values import (
    BOOL,
    FLOAT,
    GType,
    GlslEvalError,
    V,
    align_pair,
    combine_affine,
    devicify_mixed,
    is_concrete,
    promote_base,
    union_all_deps,
    union_deps,
)

__all__ = ["call_builtin", "is_builtin", "apply_binary", "apply_unary", "trunc_div_int"]


def _xp(*datas):
    return np if all(is_concrete(d) for d in datas) else tnp


def _align_variadic(args: list[V]) -> tuple[list, GType]:
    """Broadcast scalars among args to the common vector shape. Vectors
    of differing widths truncate to the narrowest (driver-lenient, same
    rule as align_pair)."""
    shape = ()
    base = "bool"
    for a in args:
        base = promote_base(base, a.type.base)
        if len(a.type.shape) > len(shape):
            shape = a.type.shape
        elif (
            len(a.type.shape) == len(shape) == 1
            and a.type.shape[0] < shape[0]
        ):
            shape = a.type.shape
    out = []
    for a in args:
        a = a.astype(base)
        if a.type.shape != shape:
            if (
                a.type.is_vector
                and len(shape) == 1
                and a.type.shape[0] > shape[0]
            ):
                a = V(a.data[..., : shape[0]], GType(a.type.base, shape))
            else:
                a = a.expand_to(shape)
        out.append(a.data)
    return out, GType(base, shape)


def _cw(fn: Callable, *args: V, result_base: str | None = None) -> V:
    datas, t = _align_variadic(list(args))
    xp = _xp(*datas)
    if xp is not np:
        datas = devicify_mixed(datas)
    res = fn(xp, *datas)
    # Component-wise functions preserve axis-dependence: the result
    # component depends only on the axes its operands depend on.
    dep = union_deps(args, max(t.ncomp, 1)) if not t.is_matrix else None
    return V(res, t if result_base is None else t.with_base(result_base), deps=dep)


# ---------------------------------------------------------------------------
# Binary / unary operator semantics (used by the interpreter)


def trunc_div_int(xp, a, b):
    """C-style truncating integer division (numpy // floors)."""
    q = xp.floor_divide(a, b)
    r = a - q * b
    fix = (r != 0) & ((a < 0) != (b < 0))
    return xp.where(fix, q + 1, q)


def apply_binary(op: str, a: V, b: V) -> V:
    # Matrix algebra first.
    if op == "*" and (a.type.is_matrix or b.type.is_matrix):
        return _mat_mul(a, b)
    if op in ("==", "!="):
        # Aggregate equality on vectors yields a single bool.
        aa, bb, t = align_pair(a, b)
        xp = _xp(aa.data, bb.data)
        eq = aa.data == bb.data
        if not t.is_scalar:
            eq = xp.all(eq, axis=tuple(range(-len(t.shape), 0)))
        if op == "!=":
            eq = xp.logical_not(eq)
        d = union_all_deps((a, b))
        return V(eq, BOOL, deps=(d,) if d is not None else None)
    if op in ("<", ">", "<=", ">="):
        aa, bb, t = align_pair(a, b)
        xp = _xp(aa.data, bb.data)
        fn = {"<": xp.less, ">": xp.greater, "<=": xp.less_equal, ">=": xp.greater_equal}[op]
        return V(fn(aa.data, bb.data), t.with_base("bool"), deps=union_deps((a, b), max(t.ncomp, 1)))
    if op in ("&&", "||", "^^"):
        ab, bbt = a.astype("bool"), b.astype("bool")
        # Fold when one scalar side is concrete: keeps loop conditions like
        # `err > eps && i < N` concrete once the counter bound is hit, so
        # the unroller terminates.
        for x, y in ((ab, bbt), (bbt, ab)):
            if is_concrete(x.data) and np.shape(x.data) == ():
                xv = bool(x.data)
                if op == "&&":
                    return y if xv else V(np.bool_(False), BOOL)
                if op == "||":
                    return V(np.bool_(True), BOOL) if xv else y
        aa, bb, t = align_pair(ab, bbt)
        xp = _xp(aa.data, bb.data)
        fn = {"&&": xp.logical_and, "||": xp.logical_or, "^^": xp.logical_xor}[op]
        return V(fn(aa.data, bb.data), t, deps=union_deps((a, b), max(t.ncomp, 1)))
    aa, bb, t = align_pair(a, b)
    xp = _xp(aa.data, bb.data)
    if op in ("+", "-", "*", "/") and t.base == "float":
        # Affine coordinate metadata survives linear ops (values.py).
        aff = combine_affine(op, a, b, t.ncomp)
    else:
        aff = None
    dep = None if t.is_matrix else union_deps((a, b), max(t.ncomp, 1))
    xla_f32 = t.base == "float" and not t.is_matrix and xp is not np
    if op in ("+", "-"):
        if xla_f32:
            fused = _contract(op, aa, bb)
            if fused is not None:
                return V(fused, t, affine=aff, deps=dep)
        return V(aa.data + bb.data if op == "+" else aa.data - bb.data, t, affine=aff, deps=dep)
    if op == "*":
        if xla_f32:
            return _product(a, b, aa, bb, t, aff, dep)
        return V(aa.data * bb.data, t, affine=aff, deps=dep)
    if op == "/":
        if t.base in ("int", "uint"):
            return V(trunc_div_int(xp, aa.data, bb.data), t, deps=dep)
        return V(aa.data / bb.data, t, affine=aff, deps=dep)
    if op == "%":
        if t.base in ("int", "uint"):
            q = trunc_div_int(xp, aa.data, bb.data)
            return V(aa.data - q * bb.data, t, deps=dep)
        return V(aa.data - bb.data * xp.floor(aa.data / bb.data), t, deps=dep)
    if op == "&":
        return V(aa.data & bb.data, t, deps=dep)
    if op == "|":
        return V(aa.data | bb.data, t, deps=dep)
    if op == "^":
        return V(aa.data ^ bb.data, t, deps=dep)
    if op == "<<":
        return V(aa.data << bb.data, t, deps=dep)
    if op == ">>":
        return V(aa.data >> bb.data, t, deps=dep)
    raise GlslEvalError(f"unknown binary op {op!r}")


def _scalar_const(v: V):
    """``v`` as an ``np.float32`` when it is a batch-less concrete scalar
    (a literal or a parameter: a constant in the reference's HLO)."""
    if v.type.is_scalar and is_concrete(v.data) and v.batch_shape == () and v.type.base != "bool":
        return np.float32(v.data)
    return None


def _product(a: V, b: V, aa: V, bb: V, t: GType, aff, dep) -> V:
    """A float tensor product, marked as one (``V.prod``). A scalar
    constant times a product with a constant factor folds into that
    factor, as XLA's algebraic simplifier rewrites ``(x * c1) * c2`` into
    ``x * f32(c1 * c2)`` (the u8 scale of a re-quantised tap folds into a
    shader weight so)."""
    for x, y in ((a, b), (b, a)):
        c2 = _scalar_const(y)
        if c2 is not None and x.prod is not None and isinstance(x.prod[1], np.float32):
            f, c1, fusable = x.prod
            c = np.float32(c1 * c2)
            return V(f * float(c), t, affine=aff, deps=dep, prod=(f, c, fusable))
    ca, cb = _scalar_const(a), _scalar_const(b)
    prod = (bb.data, ca, True) if ca is not None else (aa.data, cb, True) if cb is not None else (aa.data, bb.data, True)
    return V(aa.data * bb.data, t, affine=aff, deps=dep, prod=prod)


def _contract(op: str, a: V, b: V):
    """``a + b`` / ``a - b`` with a fusable product operand rounded once,
    as XLA's CPU code generator (LLVM) contracts an f32 add or subtract
    inside a fusion: where both operands are products the left one is
    fused and the right one rounded first; where one is, that one. None
    when neither operand is a fusable product."""
    pa = a.prod if a.prod is not None and a.prod[2] else None
    pb = b.prod if b.prod is not None and b.prod[2] else None
    if pa is not None:
        return fma32(pa[0], pa[1], b.data if op == "+" else -b.data)
    if pb is not None:
        return fma32(-pb[0] if op == "-" else pb[0], pb[1], a.data)
    return None


def apply_unary(op: str, a: V) -> V:
    xp = _xp(a.data)
    if op == "-":
        aff = (
            tuple((-x[0], -x[1], -x[2]) for x in a.affine)
            if a.affine is not None and a.type.base == "float"
            else None
        )
        return V(-a.data, a.type, affine=aff, deps=a.deps)
    if op == "+":
        return a
    if op == "!":
        return V(xp.logical_not(a.astype("bool").data), a.type.with_base("bool"), deps=a.deps)
    if op == "~":
        return V(~a.data, a.type, deps=a.deps)
    raise GlslEvalError(f"unknown unary op {op!r}")


def _mat_mul(a: V, b: V) -> V:
    """GLSL matrix multiplication. Matrices are stored [..., cols, rows]."""
    xp = _xp(a.data, b.data)
    if a.type.is_matrix and b.type.is_scalar:
        ad, bd = devicify_mixed([a.data, _expand2(b)])
        return V(ad * bd, a.type)
    if a.type.is_scalar and b.type.is_matrix:
        ad, bd = devicify_mixed([_expand2(a), b.data])
        return V(ad * bd, b.type)
    if a.type.is_matrix and b.type.is_vector:
        # m * v: out_r = sum_c m[c, r] * v[c]
        c, r = a.type.shape
        if b.type.shape[0] != c:
            raise GlslEvalError(f"mat{a.type.shape} * vec{b.type.shape}")
        out = xp.einsum("...cr,...c->...r", a.data, b.astype("float").data)
        aff = _mat_vec_affine(a, b, "mv")
        return V(out, GType("float", (r,)), affine=aff)
    if a.type.is_vector and b.type.is_matrix:
        # v * m: out_c = dot(v, m[c])
        c, r = b.type.shape
        if a.type.shape[0] != r:
            raise GlslEvalError(f"vec{a.type.shape} * mat{b.type.shape}")
        out = xp.einsum("...r,...cr->...c", a.astype("float").data, b.data)
        aff = _mat_vec_affine(b, a, "vm")
        return V(out, GType("float", (c,)), affine=aff)
    if a.type.is_matrix and b.type.is_matrix:
        ca, ra = a.type.shape
        cb, rb = b.type.shape
        if ca != rb:
            raise GlslEvalError(f"mat{a.type.shape} * mat{b.type.shape}")
        # (a*b)[c] = a * b[c]
        out = xp.einsum("...kr,...ck->...cr", a.data, b.data)
        return V(out, GType("float", (cb, ra)))
    raise GlslEvalError(f"bad operands for mat mul: {a.type} {b.type}")


def _mat_vec_affine(m: V, v: V, order: str):
    """Affine metadata through mat·vec with a CONCRETE batch-less matrix:
    each output component is a constant-coefficient linear combination of
    the vector's components, so the (a, b, c) triples combine linearly.
    This is how ``gl_Position = MVPMatrix * VertexCoord`` keeps the quad
    transform analyzable (engine._quad_transform)."""
    from retrocapture_tpu_torch.frontend.values import affine_of

    if not is_concrete(m.data) or np.shape(m.data) != m.type.shape:
        return None
    vn = v.type.shape[0]
    va = affine_of(v, vn)
    if va is None:
        return None
    md = np.asarray(m.data, np.float64)  # [cols, rows]
    out = []
    if order == "mv":  # out_r = sum_c m[c, r] * v[c]
        for r in range(m.type.shape[1]):
            a = b = c = 0.0
            for ci in range(m.type.shape[0]):
                w = float(md[ci, r])
                a += w * va[ci][0]
                b += w * va[ci][1]
                c += w * va[ci][2]
            out.append((a, b, c))
    else:  # vm: out_c = dot(v, m[c])
        for ci in range(m.type.shape[0]):
            a = b = c = 0.0
            for r in range(m.type.shape[1]):
                w = float(md[ci, r])
                a += w * va[r][0]
                b += w * va[r][1]
                c += w * va[r][2]
            out.append((a, b, c))
    return tuple(out)


def _expand2(s: V):
    d = s.astype("float").data
    d = np.asarray(d) if is_concrete(d) else d
    return d[..., None, None]


# ---------------------------------------------------------------------------
# Builtin registry


def _reduce_last(v: V, fn_name: str) -> tuple:
    xp = _xp(v.data)
    return xp, v.astype("float").data


def _b_dot(a: V, b: V) -> V:
    aa, bb, t = align_pair(a.astype("float"), b.astype("float"))
    xp = _xp(aa.data, bb.data)
    d = union_all_deps((a, b))
    dep = (d,) if d is not None else None
    if t.is_scalar:
        return V(aa.data * bb.data, FLOAT, deps=dep)
    return V(xp.sum(aa.data * bb.data, axis=-1), FLOAT, deps=dep)


def _b_length(a: V) -> V:
    xp, d = _reduce_last(a, "length")
    u = union_all_deps((a,))
    dep = (u,) if u is not None else None
    if a.type.is_scalar:
        return V(xp.abs(d), FLOAT, deps=dep)
    return V(xp.sqrt(xp.sum(d * d, axis=-1)), FLOAT, deps=dep)


def _b_normalize(a: V) -> V:
    xp, d = _reduce_last(a, "normalize")
    if a.type.is_scalar:
        return V(xp.sign(d), FLOAT)
    n = xp.sqrt(xp.sum(d * d, axis=-1, keepdims=True))
    u = union_all_deps((a,))
    dep = tuple(u for _ in range(a.type.shape[0])) if u is not None else None
    return V(d / n, a.type.with_base("float"), deps=dep)


def _b_cross(a: V, b: V) -> V:
    xp = _xp(a.data, b.data)
    x, y = devicify_mixed([a.astype("float").data, b.astype("float").data])
    out = xp.stack(
        [
            x[..., 1] * y[..., 2] - x[..., 2] * y[..., 1],
            x[..., 2] * y[..., 0] - x[..., 0] * y[..., 2],
            x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0],
        ],
        axis=-1,
    )
    return V(out, GType("float", (3,)))


def _b_reflect(i: V, n: V) -> V:
    d = _b_dot(n, i)
    two_d = V(d.data * np.float32(2.0), FLOAT)
    return apply_binary("-", i, apply_binary("*", n, two_d))


def _b_refract(i: V, n: V, eta: V) -> V:
    xp = _xp(i.data, n.data, eta.data)
    d, e, idata, ndata = devicify_mixed([
        _b_dot(n, i).data,
        np.asarray(eta.astype("float").data) if is_concrete(eta.data) else eta.astype("float").data,
        i.astype("float").data,
        n.astype("float").data,
    ])
    k = 1.0 - e * e * (1.0 - d * d)
    coeff = e * d + xp.sqrt(xp.maximum(k, 0.0))
    out = e[..., None] * idata - coeff[..., None] * ndata
    zero = xp.zeros_like(out)
    return V(xp.where((k < 0.0)[..., None], zero, out), i.type.with_base("float"))


def _b_faceforward(nv: V, i: V, nref: V) -> V:
    d = _b_dot(nref, i).data
    xp = _xp(nv.data, i.data, nref.data)
    nd = nv.astype("float").data
    return V(xp.where((d < 0.0)[..., None], nd, -nd), nv.type.with_base("float"))


def _b_mix(x: V, y: V, a: V) -> V:
    if a.type.base == "bool":
        datas, t = _align_variadic([x.astype("float"), y.astype("float"), a])
        xp = _xp(*datas)
        return V(
            xp.where(datas[2], datas[1], datas[0]),
            t.with_base("float"),
            deps=union_deps((x, y, a), max(t.ncomp, 1)),
        )
    return _cw(_mix, x, y, a, result_base="float")


def _mix(xp, x, y, a):
    """``x + (y - x) * a``; on tensors with the product contracted into
    the add, as the reference's jitted fusion computes it."""
    if xp is np:
        return x + (y - x) * a
    return fma32(y - x, a, x)


def _b_clamp(x: V, lo: V, hi: V) -> V:
    base = promote_base(x.type.base, "int")
    rb = x.type.base if x.type.base in ("int", "uint") and lo.type.base != "float" else "float"
    # min(max(x, lo), hi) with GL cmp-select NaN semantics: clamp(NaN,
    # lo, hi) = lo (llvmpipe), not NaN.
    return _cw(lambda xp, a, b, c: _gl_min(xp, _gl_max(xp, a, b), c), x, lo, hi, result_base=rb)


def _b_step(edge: V, x: V) -> V:
    return _cw(
        lambda xp, e, v: xp.where(v < e, np.float32(0.0), np.float32(1.0)),
        edge,
        x,
        result_base="float",
    )


def _b_smoothstep(e0: V, e1: V, x: V) -> V:
    def fn(xp, a, b, v):
        t = xp.clip((v - a) / (b - a), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    return _cw(fn, e0, e1, x, result_base="float")


def _b_mod(x: V, y: V) -> V:
    return apply_binary("%", x, y)


def _b_atan(*args: V) -> V:
    if len(args) == 1:
        return _cw(lambda xp, a: xp.arctan(a), args[0], result_base="float")
    return _cw(lambda xp, y, x: xp.arctan2(y, x), args[0], args[1], result_base="float")


def _b_transpose(m: V) -> V:
    xp = _xp(m.data)
    c, r = m.type.shape
    return V(xp.swapaxes(m.data, -1, -2), GType("float", (r, c)))


def _b_matrix_comp_mult(a: V, b: V) -> V:
    ad, bd = devicify_mixed([a.data, b.data])
    return V(ad * bd, a.type)


def _b_outer_product(a: V, b: V) -> V:
    xp = _xp(a.data, b.data)
    # result[c][r] = a[r] * b[c]  (columns = b's length)
    out = xp.einsum("...r,...c->...cr", a.astype("float").data, b.astype("float").data)
    return V(out, GType("float", (b.type.shape[0], a.type.shape[0])))


def _b_determinant(m: V) -> V:
    xp = _xp(m.data)
    # det(A^T) == det(A), so the [cols, rows] layout needs no transpose.
    det = np.linalg.det(np.asarray(m.data)) if xp is np else tnp.linalg.det(m.data)
    return V(det.astype(np.float32) if xp is np else det, FLOAT)


def _b_inverse(m: V) -> V:
    xp = _xp(m.data)
    # data is [..., cols, rows]; linalg.inv works on [..., rows, cols];
    # inv(A^T) = inv(A)^T so transpose in and out.
    a = xp.swapaxes(m.data, -1, -2)
    if xp is np:
        inv = np.linalg.inv(a)
    else:
        inv = tnp.linalg.inv(a)
    return V(xp.swapaxes(inv, -1, -2), m.type)


def _relational(fn_name: str):
    def impl(a: V, b: V) -> V:
        aa, bb, t = align_pair(a, b)
        xp = _xp(aa.data, bb.data)
        fn = getattr(xp, fn_name)
        return V(fn(aa.data, bb.data), t.with_base("bool"), deps=union_deps((a, b), max(t.ncomp, 1)))

    return impl


def _b_any(a: V) -> V:
    xp = _xp(a.data)
    u = union_all_deps((a,))
    return V(xp.any(a.data, axis=-1), BOOL, deps=(u,) if u is not None else None)


def _b_all(a: V) -> V:
    xp = _xp(a.data)
    u = union_all_deps((a,))
    return V(xp.all(a.data, axis=-1), BOOL, deps=(u,) if u is not None else None)


def _b_not(a: V) -> V:
    xp = _xp(a.data)
    return V(xp.logical_not(a.data), a.type, deps=a.deps)


def _simple(fname):
    return lambda *args: _cw(lambda xp, *d: getattr(xp, fname)(*d), *args, result_base="float")


def _b_sign(a: V) -> V:
    return _cw(lambda xp, d: xp.sign(d), a)


def _b_abs(a: V) -> V:
    return _cw(lambda xp, d: xp.abs(d), a)


def _gl_min(xp, x, y):
    # llvmpipe lowers fmin to a cmp-select (SSE minps: a<b ? a : b), so
    # min(NaN, y) = y while min(x, NaN) = NaN — NOT xp.minimum, which
    # propagates NaN from either side. Shaders lean on min/max to
    # sanitize NaN from pow(neg, y); matching the select keeps parity.
    return xp.where(x < y, x, y)


def _gl_max(xp, x, y):
    return xp.where(x > y, x, y)


def _b_min(a: V, b: V) -> V:
    rb = "float" if "float" in (a.type.base, b.type.base) else a.type.base
    return _cw(_gl_min, a, b, result_base=rb)


def _b_max(a: V, b: V) -> V:
    rb = "float" if "float" in (a.type.base, b.type.base) else a.type.base
    return _cw(_gl_max, a, b, result_base=rb)


def _b_pow(a: V, b: V) -> V:
    # Mesa/GL semantics (probed against llvmpipe 2026-08-17): only the
    # constant exponents 1.0 / 2.0 / 4.0 lower to multiplies
    # (nir_opt_algebraic: fpow(a,1)->a, fpow(a,2)->a*a,
    # fpow(a,4)->(a*a)*(a*a)); EVERY other exponent — including
    # integers like 3.0 and 8.0 — is exp2(y*log2(x)), NaN for x<0,
    # which UNORM framebuffer stores flush to 0
    # (ops/colorspace.quantize_rgba8).
    if is_concrete(b.data) and b.batch_shape == ():
        yv = np.asarray(b.data, np.float64).reshape(-1)
        if yv.size and np.all(yv == yv[0]) and float(yv[0]) in (1.0, 2.0, 4.0):
            n = int(yv[0])

            def ipow(xp, x):
                if n == 1:
                    return x * 1.0
                sq = x * x
                return sq if n == 2 else sq * sq

            return _cw(ipow, a, result_base="float")

    def fn(xp, x, y):
        # Probed llvmpipe pow edge semantics (2026-08-18): any base with
        # |x| below the smallest normal (DAZ, including +-0 and
        # denormals) returns 0 for EVERY exponent — pow(0,0)=0, not 1 or
        # NaN (crt-royale's border factor pow(escape, darkness=0.0)
        # depends on this); negative bases go NaN through log2.
        with np.errstate(divide="ignore", invalid="ignore"):
            out = xp.exp2(y * xp.log2(x))
            return xp.where(
                xp.abs(x) < np.float32(1.1754944e-38), np.float32(0.0), out
            )

    return _cw(fn, a, b, result_base="float")


def _lp_trig(xp, xin, want_cos: bool):
    """llvmpipe's sin/cos, bit-matched (99.9% exact over [0, pi],
    probed 2026-08-17 via RGBA32F readback): sse_mathfun-style octant
    reduction (truncate, (j+1)&~1), 3-step Cody-Waite pi/4 split, and
    the minimax polynomials evaluated with x86 FMA contraction. Shaders
    hash with fract(sin(x)*43758.5453) (crt-mattias rand(), pal
    moire, ...), where any ulp difference from the driver's polynomial
    decorrelates the whole noise field — matching the driver is the
    only way those presets can score.

    On the concrete (numpy) path FMA is emulated in f64 (exact single
    rounding). The tensor path uses stepped f32 ops (~99% exact, 1-ulp
    tail), as the JAX package's device path does."""
    f = np.float32
    if xp is np:
        def fma(a, b, c):
            return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f)
    else:
        def fma(a, b, c):
            return a * b + c
    x = xp.asarray(xin, f) if xp is np else xin.to(torch.float32)
    sign = (
        xp.signbit(x)
        if not want_cos
        else (np.zeros(np.shape(x), bool) if xp is np else torch.zeros_like(x, dtype=torch.bool))
    )
    x = xp.abs(x)
    y = x * f(1.27323954473516)
    j = y.astype(np.int32) if xp is np else _trunc_i32(y)
    j = (j + 1) & ~1
    yf = j.astype(f) if xp is np else j.to(torch.float32)
    if want_cos:
        j = j + 2
    jm = j & 7
    z = x - yf * f(0.78515625)
    z = z.astype(f) if xp is np else z
    z = z - yf * f(2.4187564849853515625e-4)
    z = z.astype(f) if xp is np else z
    z = z - yf * f(3.77489497744594108e-8)
    z = z.astype(f) if xp is np else z
    zz = (z * z).astype(f) if xp is np else z * z
    p = fma(f(-1.9515295891e-4), zz, f(8.3321608736e-3))
    p = fma(p, zz, f(-1.6666654611e-1))
    s = fma((p * zz).astype(f) if xp is np else p * zz, z, z)
    q = fma(f(2.443315711809948e-5), zz, f(-1.388731625493765e-3))
    q = fma(q, zz, f(4.166664568298827e-2))
    zz2 = (zz * zz).astype(f) if xp is np else zz * zz
    c = (q * zz2).astype(f) if xp is np else q * zz2
    c = c - f(0.5) * zz
    c = c.astype(f) if xp is np else c
    c = c + f(1.0)
    c = c.astype(f) if xp is np else c
    sel_cos = (jm == 1) | (jm == 2) | (jm == 5) | (jm == 6)
    sgn = jm >= 4
    r = xp.where(sel_cos, c, s)
    out = xp.where(sgn ^ sign, -r, r)
    return out.astype(f) if xp is np else out


def _trunc_i32(y):
    """f32 -> int32 truncation with XLA's convert semantics: out-of-range
    values saturate, NaN becomes 0 (a direct cast is undefined in torch)."""
    i = y.double().clamp(-2147483648.0, 2147483647.0).to(torch.int64).to(torch.int32)
    return torch.where(torch.isnan(y), torch.zeros_like(i), i)


def _b_sin(a: V) -> V:
    return _cw(lambda xp, d: _lp_trig(xp, d, False), a, result_base="float")


def _b_cos(a: V) -> V:
    return _cw(lambda xp, d: _lp_trig(xp, d, True), a, result_base="float")


def _b_exp(a):
    return _cw(lambda xp, d: xp.exp(d), a, result_base="float")


def _b_inversesqrt(a: V) -> V:
    return _cw(lambda xp, d: 1.0 / xp.sqrt(d), a, result_base="float")


def _b_fract(a: V) -> V:
    return _cw(lambda xp, d: d - xp.floor(d), a, result_base="float")


def _b_round_even(a: V) -> V:
    return _cw(lambda xp, d: xp.round(d), a, result_base="float")


def _b_trunc(a: V) -> V:
    return _cw(lambda xp, d: xp.trunc(d), a, result_base="float")


def _b_distance(a: V, b: V) -> V:
    return _b_length(apply_binary("-", a, b))


def _b_mod289ish_noop(a: V) -> V:  # pragma: no cover
    return a


def _b_isnan(a: V) -> V:
    return _cw(lambda xp, d: xp.isnan(d), a, result_base="bool")


def _b_isinf(a: V) -> V:
    return _cw(lambda xp, d: xp.isinf(d), a, result_base="bool")


def _b_float_bits_to_int(a: V) -> V:
    xp = _xp(a.data)
    d = a.astype("float").data
    view = (
        np.asarray(d, np.float32).view(np.int32)
        if xp is np
        else d.to(torch.float32).view(torch.int32)
    )
    return V(view, a.type.with_base("int"))


def _b_int_bits_to_float(a: V) -> V:
    xp = _xp(a.data)
    d = a.data
    view = (
        np.asarray(d, np.int32).view(np.float32)
        if xp is np
        else d.to(torch.int32).view(torch.float32)
    )
    return V(view, a.type.with_base("float"))


_BUILTINS: dict[str, Callable] = {
    "radians": lambda a: _cw(lambda xp, d: d * np.float32(np.pi / 180.0), a, result_base="float"),
    "degrees": lambda a: _cw(lambda xp, d: d * np.float32(180.0 / np.pi), a, result_base="float"),
    "sin": _b_sin,
    "cos": _b_cos,
    "tan": _simple("tan"),
    "asin": lambda a: _cw(lambda xp, d: xp.arcsin(xp.clip(d, -1.0, 1.0)), a, result_base="float"),
    "acos": lambda a: _cw(lambda xp, d: xp.arccos(xp.clip(d, -1.0, 1.0)), a, result_base="float"),
    "atan": _b_atan,
    "sinh": _simple("sinh"),
    "cosh": _simple("cosh"),
    "tanh": _simple("tanh"),
    "exp": _b_exp,
    "log": _simple("log"),
    "exp2": _simple("exp2"),
    "log2": _simple("log2"),
    "sqrt": _simple("sqrt"),
    "inversesqrt": _b_inversesqrt,
    "pow": _b_pow,
    "abs": _b_abs,
    "sign": _b_sign,
    "floor": lambda a: _cw(lambda xp, d: xp.floor(d), a, result_base="float"),
    "ceil": lambda a: _cw(lambda xp, d: xp.ceil(d), a, result_base="float"),
    "fract": _b_fract,
    "trunc": _b_trunc,
    "round": _b_round_even,
    "roundEven": _b_round_even,
    "mod": _b_mod,
    "min": _b_min,
    "max": _b_max,
    "clamp": _b_clamp,
    "mix": _b_mix,
    "step": _b_step,
    "smoothstep": _b_smoothstep,
    "length": _b_length,
    "distance": _b_distance,
    "dot": _b_dot,
    "cross": _b_cross,
    "normalize": _b_normalize,
    "faceforward": _b_faceforward,
    "reflect": _b_reflect,
    "refract": _b_refract,
    "matrixCompMult": _b_matrix_comp_mult,
    "outerProduct": _b_outer_product,
    "transpose": _b_transpose,
    "inverse": _b_inverse,
    "determinant": _b_determinant,
    "lessThan": _relational("less"),
    "lessThanEqual": _relational("less_equal"),
    "greaterThan": _relational("greater"),
    "greaterThanEqual": _relational("greater_equal"),
    "equal": _relational("equal"),
    "notEqual": _relational("not_equal"),
    "any": _b_any,
    "all": _b_all,
    "not": _b_not,
    "isnan": _b_isnan,
    "isinf": _b_isinf,
    # Non-standard names that appear in corpus shaders without a local
    # definition (HLSL-isms and C leftovers GL drivers tolerate).
    "fmod": lambda a, b: _cw(
        # C fmod truncates toward zero (unlike GLSL mod's floor).
        lambda xp, x, y: x - xp.trunc(x / y) * y,
        a,
        b,
        result_base="float",
    ),
    "saturate": lambda a: _cw(lambda xp, d: xp.clip(d, 0.0, 1.0), a, result_base="float"),
    "floatBitsToInt": _b_float_bits_to_int,
    "floatBitsToUint": _b_float_bits_to_int,
    "intBitsToFloat": _b_int_bits_to_float,
    "uintBitsToFloat": _b_int_bits_to_float,
}


def is_builtin(name: str) -> bool:
    return name in _BUILTINS


def call_builtin(name: str, args: list[V]) -> V:
    fn = _BUILTINS[name]
    return fn(*args)
