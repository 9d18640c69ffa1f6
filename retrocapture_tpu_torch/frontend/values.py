"""Runtime value model for the GLSL -> PyTorch evaluator.

A GLSL value is a ``V``: an array (NumPy when compile-time constant, a
torch tensor when data-dependent) whose trailing dimensions are the
*type* dimensions — ``()`` for scalars, ``(n,)`` for vecN, ``(cols,
rows)`` for matrices (GLSL matrices are column-major: ``m[i]`` is
column ``i``) — and whose leading dimensions are the *batch* (the
``[H, W]`` pixel grid, or empty for uniforms/constants).

Keeping compile-time constants as NumPy is what lets the interpreter
unroll ``for`` loops with literal bounds and fold constant expressions
on the host instead of launching device work for them. Tensors are
never updated in place: the evaluator shares them between ``V``s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from retrocapture_tpu_torch.frontend import tnp
from retrocapture_tpu_torch.policy import upload

__all__ = [
    "GType",
    "V",
    "SamplerVal",
    "ArrayVal",
    "StructVal",
    "FLOAT",
    "INT",
    "BOOL",
    "is_concrete",
    "vec_type",
    "scalar_of",
    "GlslEvalError",
]


class GlslEvalError(Exception):
    pass


# Axis-dependence constants (see V.deps).
DEPS_NONE = frozenset()
DEPS_X = frozenset("x")
DEPS_Y = frozenset("y")
DEPS_XY = frozenset("xy")


def _deps_from_affine(triple) -> frozenset:
    a, b, _ = triple
    d = set()
    if a != 0.0:
        d.add("x")
    if b != 0.0:
        d.add("y")
    return frozenset(d)


def deps_of(v: "V", ncomp: int):
    """Per-component axis-dependence sets for ``v`` expanded to ``ncomp``
    components, or None when unknown. Concrete batch-less values are
    constants (empty set)."""
    d = v.deps
    if d is None:
        if is_concrete(v.data) and v.batch_shape == ():
            return tuple(DEPS_NONE for _ in range(ncomp))
        return None
    if len(d) == 1 and ncomp > 1:
        return tuple(d[0] for _ in range(ncomp))
    if len(d) != ncomp:
        return None
    return d


def union_deps(values, ncomp: int):
    """Component-wise union of axis dependences across aligned operands;
    None if any operand is unknown (conservative)."""
    out = [DEPS_NONE] * ncomp
    for v in values:
        d = deps_of(v, ncomp)
        if d is None:
            return None
        out = [a | b for a, b in zip(out, d)]
    return tuple(out)


def union_all_deps(values):
    """Single dependence set unioned over every component of every
    operand (for reductions like dot/length); None if unknown."""
    out = DEPS_NONE
    for v in values:
        d = deps_of(v, max(v.type.ncomp, 1))
        if d is None:
            return None
        for s in d:
            out = out | s
    return out


@dataclass(frozen=True)
class GType:
    base: str  # 'float' | 'int' | 'uint' | 'bool'
    shape: tuple  # () | (n,) | (cols, rows)

    @property
    def is_scalar(self) -> bool:
        return self.shape == ()

    @property
    def is_vector(self) -> bool:
        return len(self.shape) == 1

    @property
    def is_matrix(self) -> bool:
        return len(self.shape) == 2

    @property
    def ncomp(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def with_base(self, base: str) -> "GType":
        return GType(base, self.shape)


FLOAT = GType("float", ())
INT = GType("int", ())
UINT = GType("uint", ())
BOOL = GType("bool", ())


def vec_type(base: str, n: int) -> GType:
    return GType(base, (n,))


_NP_DTYPES = {
    "float": np.float32,
    "int": np.int32,
    "uint": np.uint32,
    "bool": np.bool_,
}

TYPE_NAMES: dict[str, GType] = {
    "float": FLOAT,
    "int": INT,
    "uint": UINT,
    "bool": BOOL,
    "double": FLOAT,
    **{f"vec{n}": GType("float", (n,)) for n in (2, 3, 4)},
    **{f"ivec{n}": GType("int", (n,)) for n in (2, 3, 4)},
    **{f"uvec{n}": GType("uint", (n,)) for n in (2, 3, 4)},
    **{f"bvec{n}": GType("bool", (n,)) for n in (2, 3, 4)},
    **{f"dvec{n}": GType("float", (n,)) for n in (2, 3, 4)},
    **{f"mat{n}": GType("float", (n, n)) for n in (2, 3, 4)},
    **{
        f"mat{c}x{r}": GType("float", (c, r))
        for c in (2, 3, 4)
        for r in (2, 3, 4)
    },
}


def is_concrete(x: Any) -> bool:
    """True when x is a Python number / NumPy value (foldable on the
    host); False for tensors."""
    return isinstance(x, (int, float, bool, np.generic, np.ndarray))


def scalar_of(value: float, base: str = "float") -> "V":
    return V(np.asarray(value, _NP_DTYPES[base]), GType(base, ()))


def device_of(*datas):
    """Device of the first tensor among ``datas`` (None if all concrete)."""
    for d in datas:
        if isinstance(d, torch.Tensor):
            return d.device
    return None


def smart_device(x, device):
    """Concrete value -> tensor on ``device``.

    Plane-exact varyings are concrete numpy broadcast views, and every
    axis-pure expression the fragment evaluator folds from them stays
    row- or column-constant over the [oh, ow] grid. Such a value is
    uploaded as one row or column and expanded, so the host copies
    O(oh + ow) elements instead of O(oh * ow)."""
    if isinstance(x, torch.Tensor):
        return x
    if not isinstance(x, np.ndarray) or x.ndim < 2 or x.size <= (1 << 14):
        return upload(x, device)
    st = x.strides
    if st[0] == 0 or np.all(x == x[:1]):
        return upload(np.ascontiguousarray(x[:1]), device).expand(x.shape)
    if st[1] == 0 or np.all(x == x[:, :1]):
        return upload(np.ascontiguousarray(x[:, :1]), device).expand(x.shape)
    return upload(x, device)


def devicify_mixed(datas):
    """Given op operand datas, bring concrete values to the device when
    at least one operand is a tensor."""
    dev = device_of(*datas)
    if dev is None:
        return datas
    return [smart_device(d, dev) if is_concrete(d) else d for d in datas]


class V:
    """A typed GLSL value.

    ``affine`` is optional coordinate metadata: a tuple of per-component
    triples ``(a, b, c)`` meaning ``component = a*X + b*Y + c`` where X is
    the output pixel column index and Y the row index (0-based floats).
    It rides along through +,-,*,/-by-constant, swizzles, and vector
    constructors; ``texture()`` uses it to prove a sample grid is
    separable and lower to the per-axis resampling path even though the
    data itself is a tensor (sampling.py). Any op that cannot
    preserve it just drops it.

    ``deps`` is weaker axis-dependence metadata: a tuple of per-component
    frozensets ⊆ {'x', 'y'} stating which output-grid axes the component
    can vary along. Unlike ``affine`` it survives NON-linear
    component-wise math (floor, fract, clamp, sin, …), which is exactly
    what "sharp interpolation" shaders (sharp-bilinear, pixellate,
    quilez) do to texel coordinates per axis. ``texture()`` uses it to
    prove a *tensor* grid is still separable (u varies only along x, v
    only along y) and lower to two on-device resampling matmuls instead
    of the far costlier 2-D warp path. ``None`` means unknown (assume
    both axes).

    ``prod`` marks a float tensor that is one f32 product, as the
    reference's jitted XLA sees it: ``(x, y, fusable)`` with ``data ==
    f32(x * y)``, ``y`` an ``np.float32`` when it is a scalar constant.
    XLA folds a scalar constant into such a constant factor (``(x * c1)
    * c2 -> x * f32(c1 * c2)``), and its CPU code generator contracts a
    ``fusable`` product into the add or subtract that consumes it
    (builtins.apply_binary). Ops that do not keep the product drop it."""

    __slots__ = ("data", "type", "affine", "deps", "prod")

    def __init__(self, data, type: GType, affine=None, deps=None, prod=None):
        self.data = data
        self.type = type
        self.affine = affine
        if deps is None and affine is not None:
            deps = tuple(_deps_from_affine(t) for t in affine)
        self.deps = deps
        self.prod = prod

    # -- shape helpers --------------------------------------------------
    @property
    def batch_shape(self) -> tuple:
        nd = len(self.type.shape)
        shape = np.shape(self.data)
        return shape[: len(shape) - nd] if nd else shape

    def astype(self, base: str) -> "V":
        if base == self.type.base:
            return self
        dt = _NP_DTYPES[base]
        d = self.data
        if self.type.base == "float" and base in ("int", "uint"):
            # GLSL int(float) truncates toward zero.
            d = np.trunc(d).astype(dt) if is_concrete(d) else torch.trunc(d).to(tnp.torch_dtype(dt))
        elif isinstance(d, torch.Tensor):
            d = d.to(tnp.torch_dtype(dt))
        else:
            d = d.astype(dt) if hasattr(d, "astype") else dt(d)
        return V(d, self.type.with_base(base), deps=self.deps)

    def expand_to(self, type_shape: tuple) -> "V":
        """Broadcast a scalar to a vector/matrix shape (GLSL scalar-op-
        vector semantics)."""
        if self.type.shape == type_shape:
            return self
        if not self.type.is_scalar:
            raise GlslEvalError(f"cannot expand {self.type} to {type_shape}")
        concrete = is_concrete(self.data)
        d = np.asarray(self.data) if concrete else self.data
        for _ in type_shape:
            d = d[..., None]
        xp = np if concrete else tnp
        d = xp.broadcast_to(d, d.shape[: d.ndim - len(type_shape)] + type_shape)
        aff = None
        if self.affine is not None and len(type_shape) == 1:
            aff = tuple(self.affine[0] for _ in range(type_shape[0]))
        dep = None
        if len(type_shape) == 1:
            dep = deps_of(self, 1)
            if dep is not None:
                dep = tuple(dep[0] for _ in range(type_shape[0]))
        prod = None
        if self.prod is not None:
            # A broadcast product is still the product in each element.
            x, y, fusable = self.prod
            grow = (...,) + (None,) * len(type_shape)
            prod = tuple(f[grow] if isinstance(f, torch.Tensor) else f for f in (x, y)) + (fusable,)
        return V(d, GType(self.type.base, type_shape), affine=aff, deps=dep, prod=prod)

    def component(self, i: int) -> "V":
        if self.type.is_scalar:
            raise GlslEvalError("component of scalar")
        dep = None
        if not self.type.is_matrix:
            d = deps_of(self, self.type.shape[0])
            if d is not None:
                dep = (d[i],)
        return V(
            self.data[..., i],
            GType(self.type.base, self.type.shape[1:]) if self.type.is_matrix else GType(self.type.base, ()),
            deps=dep,
        )

    def __repr__(self):  # pragma: no cover
        return f"V({self.type.base}{self.type.shape}, batch={self.batch_shape})"


class SamplerVal:
    """A bound sampler2D: texture data + sampling state, resolved by the
    pass binding model (graph/plan.py)."""

    __slots__ = (
        "name", "tex", "filter_linear", "wrap_mode", "size", "mipmap", "quantized"
    )

    def __init__(
        self, name: str, tex, filter_linear: bool, wrap_mode: str,
        mipmap: bool = False, quantized: bool = False,
    ):
        self.name = name
        self.tex = tex  # [H, W, C] float32
        self.filter_linear = filter_linear
        self.wrap_mode = wrap_mode
        self.size = (tex.shape[1], tex.shape[0])  # (W, H)
        self.mipmap = mipmap
        # True when every texel provably sits on the k/255 grid (RGBA8
        # pass outputs, u8-normalized chain input, PNG LUTs): NEAREST
        # matmul taps may then rematerialize through uint8 (sampling.py
        # _requant_u8) — 1/4 the HBM traffic per tap plane.
        self.quantized = quantized


class ArrayVal:
    """GLSL array value: a Python list of Vs (static indexing stays a
    list access; dynamic indexing stacks and gathers)."""

    __slots__ = ("elems", "elem_type")

    def __init__(self, elems: list, elem_type: GType):
        self.elems = elems
        self.elem_type = elem_type

    def __len__(self):
        return len(self.elems)

    def copy(self) -> "ArrayVal":
        return ArrayVal(list(self.elems), self.elem_type)


class StructVal:
    """GLSL struct instance: named fields."""

    __slots__ = ("name", "fields")

    def __init__(self, name: str, fields: dict):
        self.name = name
        self.fields = fields

    def copy(self) -> "StructVal":
        return StructVal(self.name, dict(self.fields))


# ---------------------------------------------------------------------------
# Swizzles

_SWIZZLE_SETS = ("xyzw", "rgba", "stpq")


def swizzle_indices(name: str) -> list[int] | None:
    """Return component indices for a swizzle name, or None if not a
    swizzle (i.e. a struct field access)."""
    for charset in _SWIZZLE_SETS:
        if all(c in charset for c in name):
            return [charset.index(c) for c in name]
    return None


def swizzle_read(v: V, name: str) -> V:
    idx = swizzle_indices(name)
    if idx is None:
        raise GlslEvalError(f"bad swizzle {name!r} on {v.type}")
    if not v.type.is_vector and not v.type.is_scalar:
        raise GlslEvalError(f"swizzle on {v.type}")
    aff = v.affine
    dep = v.deps
    if v.type.is_scalar:
        # scalar.x / scalar.xx — tolerated by some drivers
        if len(idx) == 1:
            return v
        xp = np if is_concrete(v.data) else tnp
        return V(
            xp.stack([v.data] * len(idx), axis=-1),
            GType(v.type.base, (len(idx),)),
            affine=tuple(aff[0] for _ in idx) if aff else None,
            deps=tuple(dep[0] for _ in idx) if dep else None,
        )
    sub_aff = tuple(aff[i] for i in idx) if aff and len(aff) > max(idx) else None
    dep = deps_of(v, v.type.shape[0])
    sub_dep = tuple(dep[i] for i in idx) if dep is not None else None
    if len(idx) == 1:
        return V(v.data[..., idx[0]], GType(v.type.base, ()), affine=sub_aff, deps=sub_dep)
    xp = np if is_concrete(v.data) else tnp
    d = xp.stack([v.data[..., i] for i in idx], axis=-1)
    return V(d, GType(v.type.base, (len(idx),)), affine=sub_aff, deps=sub_dep)


def swizzle_write(target: V, name: str, value: V) -> V:
    """Return a copy of ``target`` with swizzled components replaced.
    Affine coordinate metadata merges per component (varying assignments
    like ``TEX0.xy = TexCoord.xy - offset`` must keep the proof)."""
    idx = swizzle_indices(name)
    if idx is None or not target.type.is_vector:
        raise GlslEvalError(f"bad swizzle write .{name} on {target.type}")
    new_affine = None
    if target.type.base == "float":
        t_aff = affine_of(target, target.type.shape[0])
        v_aff = affine_of(value, len(idx) if not value.type.is_scalar else 1)
        if t_aff is not None and v_aff is not None:
            merged = list(t_aff)
            for j, i in enumerate(idx):
                merged[i] = v_aff[j if not value.type.is_scalar else 0]
            new_affine = tuple(merged)
    new_deps = None
    t_dep = deps_of(target, target.type.shape[0])
    v_dep = deps_of(value, len(idx) if not value.type.is_scalar else 1)
    if t_dep is not None and v_dep is not None:
        md = list(t_dep)
        for j, i in enumerate(idx):
            md[i] = v_dep[j if not value.type.is_scalar else 0]
        new_deps = tuple(md)
    data = target.data
    val = value.data
    if len(idx) == 1:
        comps = [val] if value.type.is_scalar else [val[..., 0]]
    else:
        if value.type.is_scalar:
            comps = [val] * len(idx)
        else:
            comps = [val[..., k] for k in range(len(idx))]
    if is_concrete(data) and all(is_concrete(c) for c in comps):
        out = np.array(data, copy=True)
        # broadcast batch dims
        b = np.broadcast(out[..., 0], *comps)
        if b.shape != out[..., 0].shape:
            out = np.broadcast_to(out, b.shape + (out.shape[-1],)).copy()
        for i, c in zip(idx, comps):
            out[..., i] = c
        return V(out, target.type, affine=new_affine, deps=new_deps)
    data = tnp.asarray(data, device=device_of(data, *comps))
    n = target.type.shape[0]
    cols = [data[..., i] for i in range(n)]
    for i, c in zip(idx, comps):
        cols[i] = c
    cols = tnp.broadcast_arrays(*cols)
    return V(tnp.stack(cols, axis=-1), target.type, affine=new_affine, deps=new_deps)


# ---------------------------------------------------------------------------
# Affine coordinate metadata helpers


def affine_of(v: V, ncomp: int):
    """Affine triples for ``v`` expanded to ``ncomp`` components, or None.
    Concrete batch-less values count as constants ``(0, 0, value)``."""
    aff = v.affine
    if aff is None and is_concrete(v.data) and v.batch_shape == ():
        if v.type.base not in ("float", "int", "uint"):
            return None
        d = np.asarray(v.data, np.float64)
        if v.type.is_scalar:
            aff = ((0.0, 0.0, float(d)),)
        elif v.type.is_vector:
            aff = tuple((0.0, 0.0, float(d[i])) for i in range(v.type.shape[0]))
        else:
            return None
    if aff is None:
        return None
    if len(aff) == 1 and ncomp > 1:
        aff = tuple(aff[0] for _ in range(ncomp))
    if len(aff) != ncomp:
        return None
    return aff


def affine_is_const(aff) -> bool:
    return all(t[0] == 0.0 and t[1] == 0.0 for t in aff)


def combine_affine(op: str, a: V, b: V, ncomp: int):
    """Affine metadata for ``a <op> b``, or None."""
    fa = affine_of(a, ncomp)
    fb = affine_of(b, ncomp)
    if fa is None or fb is None:
        return None
    if op == "+":
        return tuple(
            (x[0] + y[0], x[1] + y[1], x[2] + y[2]) for x, y in zip(fa, fb)
        )
    if op == "-":
        return tuple(
            (x[0] - y[0], x[1] - y[1], x[2] - y[2]) for x, y in zip(fa, fb)
        )
    if op == "*":
        if affine_is_const(fb):
            return tuple((x[0] * y[2], x[1] * y[2], x[2] * y[2]) for x, y in zip(fa, fb))
        if affine_is_const(fa):
            return tuple((y[0] * x[2], y[1] * x[2], y[2] * x[2]) for x, y in zip(fa, fb))
        return None
    if op == "/":
        if affine_is_const(fb) and all(y[2] != 0.0 for y in fb):
            return tuple((x[0] / y[2], x[1] / y[2], x[2] / y[2]) for x, y in zip(fa, fb))
        return None
    return None


# ---------------------------------------------------------------------------
# Promotion / broadcasting helpers

_BASE_RANK = {"bool": 0, "int": 1, "uint": 2, "float": 3}


def promote_base(a: str, b: str) -> str:
    return a if _BASE_RANK[a] >= _BASE_RANK[b] else b


def align_pair(a: V, b: V) -> tuple[V, V, GType]:
    """Align two operands for a component-wise binary op per GLSL rules:
    scalars broadcast against vectors/matrices; bases promote. Mixed
    concrete/tensor pairs bring the concrete side to the tensor's device
    (smart_device), so no numpy operand meets a tensor in an operator."""
    base = promote_base(a.type.base, b.type.base)
    a = a.astype(base)
    b = b.astype(base)
    ac, bc = is_concrete(a.data), is_concrete(b.data)
    if ac != bc:
        dev = device_of(a.data, b.data)
        if ac:
            a = V(smart_device(a.data, dev), a.type, affine=a.affine, deps=a.deps)
        else:
            b = V(smart_device(b.data, dev), b.type, affine=b.affine, deps=b.deps)
    if a.type.shape == b.type.shape:
        return a, b, a.type
    if a.type.is_scalar:
        return a.expand_to(b.type.shape), b, b.type
    if b.type.is_scalar:
        return a, b.expand_to(a.type.shape), a.type
    if a.type.is_vector and b.type.is_vector:
        # Strict GLSL rejects vecN op vecM; real drivers (and therefore
        # corpus shaders, e.g. crt-royale helpers) tolerate it by
        # truncating the wider operand. Match the lenient behavior.
        n = min(a.type.shape[0], b.type.shape[0])

        def trunc(v: V) -> V:
            if v.type.shape[0] == n:
                return v
            return V(
                v.data[..., :n],
                GType(v.type.base, (n,)),
                affine=v.affine[:n] if v.affine else None,
            )

        a, b = trunc(a), trunc(b)
        return a, b, a.type
    raise GlslEvalError(f"shape mismatch {a.type} vs {b.type}")
