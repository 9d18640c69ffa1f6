"""GLSL AST → PyTorch evaluator.

Executes a shader's ``main`` over the whole ``[H, W]`` pixel grid: every
GLSL scalar becomes an ``[H, W]`` tensor (or a NumPy constant when
compile-time foldable), every vecN an ``[H, W, N]`` tensor, and
``texture()`` becomes a sampler call (ops/sampling.py) — the replacement
for the reference's per-pass GLSL dispatch
(ShaderEngine::renderMultipassPass, ShaderEngine.cpp:850-1475). Tensors
live on the pass context's device (``ctx.device``); the evaluator runs
eagerly, once per frame.

Control flow:
* concrete conditions/bounds (literals, consts, loop counters) execute
  natively in Python — ``for`` loops unroll, ``if``s take one branch;
* data-dependent conditions become *predicated execution*: both branches
  run and every assignment merges with ``where(mask, new, old)``;
  ``return`` / ``break`` / ``continue`` / ``discard`` under a per-pixel mask
  fold into the mask logic.

The vertex stage is evaluated the same way with ``TexCoord`` bound to the
output pixel grid; since corpus vertex shaders compute varyings as affine
functions of ``TexCoord``, per-pixel evaluation equals hardware linear
interpolation exactly.
"""

from __future__ import annotations

from typing import Any, Optional, Protocol

import numpy as np
import torch

from retrocapture_tpu_torch.frontend import glsl_ast as A
from retrocapture_tpu_torch.frontend import tnp
from retrocapture_tpu_torch.frontend.builtins import (
    apply_binary,
    apply_unary,
    call_builtin,
    is_builtin,
)
from retrocapture_tpu_torch.frontend.values import (
    ArrayVal,
    BOOL,
    FLOAT,
    GType,
    GlslEvalError,
    INT,
    SamplerVal,
    StructVal,
    TYPE_NAMES,
    V,
    affine_of,
    deps_of,
    align_pair,
    devicify_mixed,
    is_concrete,
    smart_device,
    swizzle_indices,
    swizzle_read,
    swizzle_write,
)

__all__ = ["ShaderEval", "PassContextProtocol", "UnsupportedShaderError"]

MAX_UNROLL = 512
# Counted loops at or past this trip count are the ones the JAX package
# rolls into lax.fori_loop (up to _ROLL_MAX_TRIPS trips). Eager torch has
# no trace to keep small, so the port runs the same loops iteration by
# iteration; the bounds keep the set of loops that run (and the set that
# degrades to passthrough) the same as the reference's.
ROLL_MIN_TRIPS = 40
_ROLL_MAX_TRIPS = 65536


class UnsupportedShaderError(GlslEvalError):
    """Raised when a construct cannot be lowered; the engine degrades to
    passthrough, mirroring the reference's compile-failure fallback
    (ShaderEngine.cpp:294-314)."""


class PassContextProtocol(Protocol):  # pragma: no cover - typing aid
    out_size: tuple[int, int]  # (W, H)

    def resolve_uniform(self, name: str, gtype: GType) -> Optional[V]: ...

    def resolve_sampler(self, name: str) -> Optional[SamplerVal]: ...

    def resolve_struct_uniform(self, name: str, fields: list) -> Optional[StructVal]: ...


# ---------------------------------------------------------------------------
# Signals for fully-concrete control flow


class _BreakSignal(Exception):
    pass


class _ContinueSignal(Exception):
    pass


class _ReturnSignal(Exception):
    def __init__(self, value: Optional[V]):
        self.value = value


class _Frame:
    """One function activation."""

    __slots__ = ("locals", "ret_val", "ret_mask")

    def __init__(self):
        self.locals: dict[str, Any] = {}
        self.ret_val: Optional[V] = None
        self.ret_mask = None  # None | bool array


class _LoopCtx:
    __slots__ = ("break_mask", "continue_mask")

    def __init__(self):
        self.break_mask = None
        self.continue_mask = None


def _mask_xp(*ms):
    return tnp if any(isinstance(m, torch.Tensor) for m in ms) else np


def _or_mask(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return _mask_xp(a, b).logical_or(a, b)


def _and_mask(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return _mask_xp(a, b).logical_and(a, b)


def _not_mask(m):
    return None if m is None else _mask_xp(m).logical_not(m)


def _zero_like_elem(proto):
    """Zero value matching an array element's type (OOB read result)."""
    if isinstance(proto, V):
        shape = proto.type.shape if proto.type.is_vector else ()
        if proto.type.is_matrix:
            shape = proto.type.shape
        dt = {"int": np.int32, "uint": np.uint32, "bool": np.bool_}.get(
            proto.type.base, np.float32
        )
        return V(np.zeros(shape, dt), proto.type)
    if isinstance(proto, ArrayVal):
        return ArrayVal(
            [_zero_like_elem(e) for e in proto.elems], proto.elem_type
        )
    raise UnsupportedShaderError("OOB read of non-numeric array")


def _masked_merge(old, new, mask, dev):
    """where(mask, new, old) for any value kind; the result is a tensor on
    ``dev`` (as the reference's jnp.where result is a device array)."""
    if mask is None or old is None:
        return new
    if isinstance(new, ArrayVal):
        return ArrayVal(
            [_masked_merge(o, n, mask, dev) for o, n in zip(old.elems, new.elems)],
            new.elem_type,
        )
    if isinstance(new, StructVal):
        return StructVal(
            new.name,
            {k: _masked_merge(old.fields.get(k), v, mask, dev) for k, v in new.fields.items()},
        )
    if isinstance(new, SamplerVal):
        return new
    o, n, t = align_pair(old, new)
    m = tnp.asarray(mask, device=dev)
    for _ in t.shape:
        m = m[..., None]
    return V(tnp.where(m, smart_device(n.data, dev), smart_device(o.data, dev)), t)


class ShaderEval:
    """Evaluates one translation unit (one stage of one pass)."""

    def __init__(self, tu: A.TranslationUnit, stage: str):
        self.tu = tu
        self.stage = stage
        self.structs = tu.structs()
        self.fns: dict[str, list[A.FunctionDef]] = {}
        for d in tu.decls:
            if isinstance(d, A.FunctionDef) and d.body is not None:
                self.fns.setdefault(d.name, []).append(d)

    # -- public ---------------------------------------------------------
    def run(
        self,
        ctx: PassContextProtocol,
        inputs: dict[str, Any],
    ) -> tuple[dict[str, Any], Optional[V], Any]:
        """Execute main(). ``inputs`` seeds global variables (attributes /
        varyings / special vars). Returns (globals_after, output_color,
        discard_mask). Output color resolution order: FragColor,
        gl_FragColor, any declared `out vec4`."""
        self.ctx = ctx
        self.dev = ctx.device
        self.globals: dict[str, Any] = {}
        self.out_names: list[str] = []
        self.varying_names: list[str] = []
        self.written_globals: set[str] = set()
        self.discard_mask = None
        self.frames: list[_Frame] = []
        self.loop_stack: list[_LoopCtx] = []
        self.mask = None

        # Root frame exists before global initializers run: they may call
        # helper functions or reference earlier globals.
        frame = _Frame()
        self.frames.append(frame)
        self._init_globals(inputs)
        if "main" not in self.fns:
            raise UnsupportedShaderError("no main()")
        main = self.fns["main"][0]
        try:
            self._exec_block_stmts(main.body.body)
        except _ReturnSignal:
            pass
        self.frames.pop()

        # Output color: prefer an output that main() actually WROTE —
        # compat-era shaders declare `out vec4 FragColor` on the 130 path
        # but still write gl_FragColor (drivers tolerate it when only one
        # is used); the unwritten declaration must not shadow the real
        # output with zeros.
        candidates = ("FragColor", "gl_FragColor", *self.out_names)
        out = None
        for name in candidates:
            v = self.globals.get(name)
            if name in self.written_globals and isinstance(v, V) and v.type.shape == (4,):
                out = v
                break
        if out is None:
            for name in candidates:
                v = self.globals.get(name)
                if isinstance(v, V) and v.type.shape == (4,):
                    out = v
                    break
        if out is None:
            frag_data = self.globals.get("gl_FragData")
            if isinstance(frag_data, ArrayVal) and frag_data.elems:
                cand = frag_data.elems[0]
                if isinstance(cand, V) and cand.type.shape == (4,):
                    out = cand
        return self.globals, out, self.discard_mask

    # -- globals --------------------------------------------------------
    def _init_globals(self, inputs: dict[str, Any]) -> None:
        # Seed built-in variables (gl_FragCoord, attributes, varyings)
        # whether or not the shader declares them.
        for k, v in inputs.items():
            self.globals[k] = v
        for decl in self.tu.globals():
            ts = decl.type
            for d in decl.declarators:
                name = d.name
                if name in inputs:
                    # Coerce to the declared type: e.g. shaders that
                    # declare `in vec2 TexCoord` get the xy of the vec4
                    # attribute the engine supplies.
                    val = inputs[name]
                    want = TYPE_NAMES.get(ts.name)
                    if (
                        isinstance(val, V)
                        and want is not None
                        and want.is_vector
                        and val.type.is_vector
                        and want.shape[0] < val.type.shape[0]
                    ):
                        val = V(
                            val.data[..., : want.shape[0]],
                            GType(val.type.base, want.shape),
                            affine=val.affine[: want.shape[0]] if val.affine else None,
                        )
                    self.globals[name] = val
                    continue
                if ts.name in ("sampler2D", "sampler1D", "sampler3D", "samplerCube"):
                    s = self.ctx.resolve_sampler(name)
                    if s is not None:
                        self.globals[name] = s
                    continue
                if "out" in ts.qualifiers:
                    self.out_names.append(name)
                if ts.is_varying_out:
                    self.varying_names.append(name)
                if ts.is_uniform:
                    gv = self._resolve_uniform_value(name, ts, d)
                    if gv is not None:
                        self.globals[name] = gv
                        continue
                # Plain global (const or mutable) with optional initializer.
                if d.init is not None:
                    self.globals[name] = self._eval_init(ts, d, d.init)
                else:
                    self.globals[name] = self._zero_value(ts, d)

    def _resolve_uniform_value(self, name: str, ts: A.TypeSpec, d: A.Declarator):
        if ts.name in self.structs:
            sd = self.structs[ts.name]
            sv = self.ctx.resolve_struct_uniform(name, sd.fields)
            if sv is not None:
                return sv
            return self._zero_value(ts, d)
        gtype = TYPE_NAMES.get(ts.name)
        if gtype is None:
            return None
        v = self.ctx.resolve_uniform(name, gtype)
        if v is None:
            v = self._zero_value(ts, d)
        return v

    def _zero_value(self, ts: A.TypeSpec, d: Optional[A.Declarator] = None):
        dims = d.array_size if d is not None else None
        if ts.name in self.structs:
            sd = self.structs[ts.name]
            fields = {}
            for ftype, fname, fdims in sd.fields:
                if ftype.name in self.structs:
                    # Nested struct field (voxel-world's
                    # VoxelMarchResult.first: VoxelHit) — recurse so
                    # member access finds a StructVal, not a scalar.
                    fields[fname] = self._zero_value(ftype, None)
                else:
                    fields[fname] = self._zero_for_type(ftype.name)
                if fdims is not None:
                    n = self._static_int(fdims) if not isinstance(fdims, list) else (
                        self._static_int(fdims[0]) if fdims and fdims[0] is not None else 0
                    )
                    elem_t = TYPE_NAMES.get(ftype.name, FLOAT)
                    fields[fname] = ArrayVal([fields[fname]] * max(n, 0), elem_t)
            base = StructVal(ts.name, fields)
        else:
            base = self._zero_for_type(ts.name)
        if dims:
            n = self._static_int(dims[0]) if dims[0] is not None else 0
            elem_t = TYPE_NAMES.get(ts.name, FLOAT)
            arr = ArrayVal([base] * max(n, 0), elem_t)
            return arr
        return base

    def _static_int(self, e) -> int:
        """Evaluate a compile-time-constant integer expression (array
        sizes; GLSL requires constant expressions here)."""
        v = self.eval(e)
        if isinstance(v, V) and is_concrete(v.data) and v.batch_shape == ():
            return int(v.data)
        raise UnsupportedShaderError("non-constant array size")

    def _zero_for_type(self, type_name: str):
        gtype = TYPE_NAMES.get(type_name, FLOAT)
        dt = {"float": np.float32, "int": np.int32, "uint": np.uint32, "bool": np.bool_}[
            gtype.base
        ]
        return V(np.zeros(gtype.shape, dt) if gtype.shape else dt(0), gtype)

    def _eval_init(self, ts: A.TypeSpec, d: A.Declarator, init: A.Expr):
        if isinstance(init, A.BraceInit):
            return self._eval_brace_init(ts, d.array_size or [], init)
        # GLSL array constructor: `vec2 d[2] = vec2[](a, b)` /
        # `mat2 w[2] = mat2[2](x, y)` — the parser yields Call(elem_type)
        # with the declarator carrying the array size.
        if (
            d.array_size
            and isinstance(init, A.Call)
            and init.func == ts.name
        ):
            elem_t = TYPE_NAMES.get(ts.name, FLOAT)
            elems = []
            for a_expr in init.args:
                v = self.eval(a_expr)
                if isinstance(v, V) and not elem_t.is_matrix:
                    v = self._convert_scalar(v, elem_t)
                elems.append(v)
            return ArrayVal(elems, elem_t)
        val = self.eval(init)
        return self._coerce_decl(ts, d, val)

    def _eval_brace_init(self, ts: A.TypeSpec, dims: list, init: A.BraceInit):
        elem_t = TYPE_NAMES.get(ts.name, FLOAT)
        if len(dims) >= 2:
            elems = [
                self._eval_brace_init(ts, dims[1:], p)
                if isinstance(p, A.BraceInit)
                else self.eval(p)
                for p in init.parts
            ]
            return ArrayVal(elems, elem_t)
        elems = []
        for p in init.parts:
            v = self.eval(p) if not isinstance(p, A.BraceInit) else self._eval_brace_init(ts, [], p)
            if isinstance(v, V):
                v = self._convert_scalar(v, elem_t)
            elems.append(v)
        return ArrayVal(elems, elem_t)

    def _convert_scalar(self, v: V, t: GType) -> V:
        if v.type.shape == t.shape:
            return v.astype(t.base)
        if v.type.is_scalar and t.shape:
            return v.astype(t.base).expand_to(t.shape)
        if (
            v.type.is_vector
            and t.is_vector
            and v.type.shape[0] > t.shape[0]
        ):
            # `vec3 x = texture(...)` — GL rejects this; the reference
            # auto-repairs by source rewriting (ShaderEngine.cpp:450-680).
            # We repair by truncating components.
            n = t.shape[0]
            return V(
                v.data[..., :n],
                GType(t.base, (n,)),
                affine=v.affine[:n] if v.affine else None,
            ).astype(t.base)
        return v

    def _coerce_decl(self, ts: A.TypeSpec, d: A.Declarator, val):
        if isinstance(val, (ArrayVal, StructVal, SamplerVal)):
            return val
        gtype = TYPE_NAMES.get(ts.name)
        if gtype is None:
            return val
        if d.array_size:
            return val  # array from constructor call
        return self._convert_scalar(val, gtype)

    # -- statements -----------------------------------------------------
    def _prune_mask(self, base_mask):
        """Subtract return/break/continue masks from the base mask."""
        m = base_mask
        fr = self.frames[-1]
        if fr.ret_mask is not None:
            m = _and_mask(m, _not_mask(fr.ret_mask))
        for lp in self.loop_stack:
            if lp.break_mask is not None:
                m = _and_mask(m, _not_mask(lp.break_mask))
            if lp.continue_mask is not None:
                m = _and_mask(m, _not_mask(lp.continue_mask))
        return m

    def _exec_block_stmts(self, stmts: list[A.Stmt]) -> None:
        base = self.mask
        for s in stmts:
            self.mask = self._prune_mask(base)
            self.exec_stmt(s)
        self.mask = base

    def exec_stmt(self, s: A.Stmt) -> None:
        if isinstance(s, A.Block):
            self._exec_block_stmts(s.body)
        elif isinstance(s, A.ExprStmt):
            self.eval(s.expr)
        elif isinstance(s, A.DeclStmt):
            for d in s.declarators:
                if d.init is not None:
                    val = self._eval_init(s.type, d, d.init)
                elif d.array_size:
                    val = self._zero_value(s.type, d)
                else:
                    val = self._zero_value(s.type)
                self._declare(d.name, val)
        elif isinstance(s, A.If):
            self._exec_if(s)
        elif isinstance(s, A.For):
            self._exec_for(s)
        elif isinstance(s, A.While):
            self._exec_loop(None, s.cond, None, s.body, bound=_shift_loop_bound(s.cond, s.body))
        elif isinstance(s, A.DoWhile):
            self._exec_loop(None, s.cond, None, s.body, do_while=True)
        elif isinstance(s, A.Return):
            self._exec_return(s)
        elif isinstance(s, A.Break):
            self._exec_break()
        elif isinstance(s, A.Continue):
            self._exec_continue()
        elif isinstance(s, A.Discard):
            m = self.mask
            self.discard_mask = _or_mask(
                self.discard_mask, m if m is not None else True
            )
            if m is None:
                raise _ReturnSignal(None)
        else:
            raise UnsupportedShaderError(f"statement {type(s).__name__}")

    def _declare(self, name: str, val) -> None:
        self.frames[-1].locals[name] = val

    def _exec_return(self, s: A.Return) -> None:
        val = self.eval(s.value) if s.value is not None else None
        fr = self.frames[-1]
        if self.mask is None:
            fr.ret_val = val if fr.ret_val is None else _masked_merge(fr.ret_val, val, None, self.dev)
            raise _ReturnSignal(val)
        if val is not None:
            fr.ret_val = _masked_merge(fr.ret_val, val, self.mask, self.dev) if fr.ret_val is not None else _masked_merge(self._zeros_like(val), val, self.mask, self.dev)
        fr.ret_mask = _or_mask(fr.ret_mask, self.mask)

    def _zeros_like(self, v):
        if isinstance(v, StructVal):
            return StructVal(v.name, {k: self._zeros_like(x) for k, x in v.fields.items()})
        if isinstance(v, ArrayVal):
            return ArrayVal([self._zeros_like(x) for x in v.elems], v.elem_type)
        return V(torch.zeros_like(smart_device(v.data, self.dev)), v.type)

    def _exec_break(self) -> None:
        if not self.loop_stack:
            raise UnsupportedShaderError("break outside loop")
        if self.mask is None:
            raise _BreakSignal()
        lp = self.loop_stack[-1]
        lp.break_mask = _or_mask(lp.break_mask, self.mask)

    def _exec_continue(self) -> None:
        if not self.loop_stack:
            raise UnsupportedShaderError("continue outside loop")
        if self.mask is None:
            raise _ContinueSignal()
        lp = self.loop_stack[-1]
        lp.continue_mask = _or_mask(lp.continue_mask, self.mask)

    def _exec_if(self, s: A.If) -> None:
        cond = self.eval(s.cond).astype("bool")
        if is_concrete(cond.data) and cond.batch_shape == ():
            if bool(cond.data):
                self.exec_stmt(s.then)
            elif s.other is not None:
                self.exec_stmt(s.other)
            return
        c = smart_device(cond.data, self.dev)
        outer = self.mask
        self.mask = _and_mask(outer, c)
        self.exec_stmt(s.then)
        if s.other is not None:
            self.mask = self._prune_mask(_and_mask(outer, torch.logical_not(c)))
            self.exec_stmt(s.other)
        self.mask = outer

    def _exec_for(self, s: A.For) -> None:
        # `for (v = E; v < E + k; v += c)` with a TRACED E: the bounds
        # cancel structurally, so the trip count is the fixed ceil(k/c)
        # even though both endpoints are data-dependent — the gendither/
        # powervr2/omniscale pattern that otherwise spins to the unroll
        # cap and degrades the preset to passthrough.
        trips = _static_trip_count(s)
        if trips is not None:
            if s.init is not None:
                self.exec_stmt(s.init)
            self._run_counted_loop(s, trips)
            return
        if s.init is not None:
            self.exec_stmt(s.init)
        # Concrete simple-induction loops (`for (int i=0; i<256; i++)`)
        # get an exact trip count by simulating the induction in its own
        # dtype — the JAX package rolls such loops into lax.fori_loop; the
        # port runs them eagerly up to the same trip bound.
        trips = self._concrete_trip_count(s)
        if trips is not None:
            self._run_counted_loop(s, trips)
            return
        # A step that only touches a simple induction variable updates it
        # UNMASKED: masked-off pixels advancing their counter is harmless
        # (their body writes are masked), and it keeps the counter — and
        # therefore the loop condition — concrete even when the loop sits
        # inside a data-dependent if. This is how divergent lanes execute
        # on real GPUs: everyone iterates, effects are predicated.
        step_uniform = _is_simple_induction_step(s.step)
        self._exec_loop(None, s.cond, s.step, s.body, step_uniform=step_uniform)

    # -- counted loops ---------------------------------------------------
    def _concrete_trip_count(self, s: A.For) -> Optional[int]:
        """Exact trip count of a simple-induction for-loop whose start,
        bound, and step are concrete scalars, found by simulating the
        induction in its own dtype (bit-faithful to what the eager loop
        would evaluate, including f32 accumulation drift). Runs AFTER the
        init statement has executed. None when the pattern doesn't hold."""
        step = s.step
        vname = cval = None
        if (
            isinstance(step, (A.PrefixIncDec, A.PostfixIncDec))
            and isinstance(step.operand, A.Ident)
        ):
            vname = step.operand.name
            cval = 1 if step.op == "++" else -1
        elif isinstance(step, A.Assign) and isinstance(step.target, A.Ident):
            vname = step.target.name
            if step.op in ("+=", "-=") and isinstance(step.value, A.Num):
                cval = step.value.value if step.op == "+=" else -step.value.value
            elif (
                step.op == "="
                and isinstance(step.value, A.Binary)
                and step.value.op in ("+", "-")
                and isinstance(step.value.left, A.Ident)
                and step.value.left.name == vname
                and isinstance(step.value.right, A.Num)
            ):
                cval = (
                    step.value.right.value
                    if step.value.op == "+"
                    else -step.value.right.value
                )
        if vname is None or cval is None or cval == 0:
            return None
        cond = s.cond
        if not (isinstance(cond, A.Binary) and cond.op in ("<", "<=", ">", ">=")):
            return None
        op = cond.op
        if isinstance(cond.left, A.Ident) and cond.left.name == vname:
            rhs = cond.right
        elif isinstance(cond.right, A.Ident) and cond.right.name == vname:
            rhs = cond.left
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}[op]
        else:
            return None
        # The induction var and every name the bound reads must be
        # loop-invariant; _BodyScan also catches writes through out/inout
        # parameters of called functions, which _writes_var cannot see.
        scan = _BodyScan(self.fns).scan(s.body, None)
        if not scan.ok or vname in scan.writes or _mentions_var(rhs, vname):
            return None
        if any(ident in scan.writes for ident in _expr_idents(rhs)):
            return None
        cur = self._lookup(vname)
        if not (
            isinstance(cur, V)
            and cur.type.is_scalar
            and is_concrete(cur.data)
            and np.ndim(cur.data) == 0
        ):
            return None
        try:
            bound_v = self.eval(rhs)
        except GlslEvalError:
            return None
        if not (
            isinstance(bound_v, V)
            and is_concrete(bound_v.data)
            and np.ndim(bound_v.data) == 0
        ):
            return None
        # Simulate with the eager path's arithmetic: int induction is
        # exact; float induction must accumulate in float32.
        if cur.type.base in ("int", "uint"):
            if not float(cval).is_integer():
                return None
            v = np.int64(cur.data)
            c = np.int64(cval)
            lim = float(bound_v.data)
            cmp = {"<": lambda a: a < lim, "<=": lambda a: a <= lim,
                   ">": lambda a: a > lim, ">=": lambda a: a >= lim}[op]
            n = 0
            while n <= _ROLL_MAX_TRIPS and cmp(v):
                n += 1
                v = v + c
        else:
            v = np.float32(cur.data)
            c = np.float32(cval)
            lim = np.float32(bound_v.data)
            cmp = {"<": lambda a: a < lim, "<=": lambda a: a <= lim,
                   ">": lambda a: a > lim, ">=": lambda a: a >= lim}[op]
            n = 0
            while n <= _ROLL_MAX_TRIPS and cmp(v):
                n += 1
                v = np.float32(v + c)
        if n > _ROLL_MAX_TRIPS:
            return None
        return n

    def _one_counted_iteration(self, s: A.For, lp: "_LoopCtx", outer):
        """One body+step of a counted for-loop (step unmasked: counted
        loops have simple induction steps). Returns 'break' on a concrete
        break."""
        lp.continue_mask = None
        try:
            self.mask = self._prune_mask(outer)
            self.exec_stmt(s.body)
        except _ContinueSignal:
            pass
        except _BreakSignal:
            return "break"
        if s.step is not None:
            saved = self.mask
            self.mask = None
            self.eval(s.step)
            self.mask = saved
        return None

    def _run_counted_loop(self, s: A.For, trips: int) -> None:
        lp = _LoopCtx()
        self.loop_stack.append(lp)
        outer = self.mask
        try:
            cap = MAX_UNROLL
            if trips >= ROLL_MIN_TRIPS:
                # The loops the reference rolls into lax.fori_loop: a body
                # the write-set scan can bound and that cannot return.
                scan = _BodyScan(self.fns).scan(s.body, s.step)
                if scan.ok and not scan.has_return:
                    cap = _ROLL_MAX_TRIPS
            if trips > cap:
                raise UnsupportedShaderError(
                    f"loop of {trips} iterations could not be rolled"
                )
            for _ in range(trips):
                if self._one_counted_iteration(s, lp, outer) == "break":
                    break
        finally:
            self.loop_stack.pop()
            self.mask = outer

    def _exec_loop(
        self,
        _init,
        cond_expr,
        step_expr,
        body,
        do_while=False,
        step_uniform=False,
        bound=None,
    ) -> None:
        lp = _LoopCtx()
        self.loop_stack.append(lp)
        outer = self.mask
        iters = 0
        traced_iters = 0
        try:
            while True:
                # -- condition (top of loop; do-while checks at the bottom)
                if cond_expr is not None and not (do_while and iters == 0):
                    c = self.eval(cond_expr).astype("bool")
                    if is_concrete(c.data) and c.batch_shape == ():
                        if not bool(c.data):
                            break
                    else:
                        # pixels whose condition just went false exit here
                        active = self._prune_mask(outer)
                        exited = _and_mask(active, torch.logical_not(smart_device(c.data, self.dev)))
                        if exited is None:
                            exited = torch.logical_not(smart_device(c.data, self.dev))
                        lp.break_mask = _or_mask(lp.break_mask, exited)
                        traced_iters += 1
                        if bound is not None and traced_iters > bound:
                            # Proven-terminating loop (e.g. a shift-to-
                            # zero popcount): every pixel has exited by
                            # the bound; further iterations are no-ops.
                            break
                        if traced_iters > MAX_UNROLL:
                            raise UnsupportedShaderError(
                                "data-dependent loop exceeded unroll cap"
                            )
                # -- body
                lp.continue_mask = None
                try:
                    self.mask = self._prune_mask(outer)
                    self.exec_stmt(body)
                except _ContinueSignal:
                    pass
                except _BreakSignal:
                    break
                # -- step (continue skips the body, not the step)
                if step_expr is not None:
                    if step_uniform:
                        saved = self.mask
                        self.mask = None
                        self.eval(step_expr)
                        self.mask = saved
                    else:
                        self.mask = self._prune_mask_no_continue(outer, lp)
                        self.eval(step_expr)
                # -- do-while bottom condition
                if do_while and cond_expr is not None:
                    c = self.eval(cond_expr).astype("bool")
                    if is_concrete(c.data) and c.batch_shape == ():
                        if not bool(c.data):
                            break
                    else:
                        active = self._prune_mask(outer)
                        exited = _and_mask(active, torch.logical_not(smart_device(c.data, self.dev)))
                        if exited is None:
                            exited = torch.logical_not(smart_device(c.data, self.dev))
                        lp.break_mask = _or_mask(lp.break_mask, exited)
                        traced_iters += 1
                        if traced_iters > MAX_UNROLL:
                            raise UnsupportedShaderError(
                                "data-dependent loop exceeded unroll cap"
                            )
                iters += 1
                if iters > MAX_UNROLL:
                    raise UnsupportedShaderError(
                        f"loop exceeded {MAX_UNROLL} unrolled iterations"
                    )
                if cond_expr is None and not do_while:
                    # `for(;;)` with only concrete breaks is fine; a fully
                    # unbounded loop without any break would spin — the
                    # iteration cap above catches it.
                    pass
        finally:
            self.loop_stack.pop()
            self.mask = outer

    def _prune_mask_no_continue(self, base, current_loop):
        m = base
        fr = self.frames[-1]
        if fr.ret_mask is not None:
            m = _and_mask(m, _not_mask(fr.ret_mask))
        for lp in self.loop_stack:
            if lp.break_mask is not None:
                m = _and_mask(m, _not_mask(lp.break_mask))
            if lp is not current_loop and lp.continue_mask is not None:
                m = _and_mask(m, _not_mask(lp.continue_mask))
        return m

    # -- variable access ------------------------------------------------
    # Built-in fragment outputs exist without declaration (GLSL <= 1.20);
    # they must live in globals so run() can read them after main() pops.
    _BUILTIN_OUTPUTS = ("gl_FragColor", "gl_FragDepth")

    def _lookup(self, name: str):
        fr = self.frames[-1]
        if name in fr.locals:
            return fr.locals[name]
        if name in self.globals:
            return self.globals[name]
        if name == "gl_FragColor":
            v = V(np.zeros(4, np.float32), GType("float", (4,)))
            self.globals[name] = v
            return v
        if name == "gl_FragData":
            # MRT array; only element 0 (the color buffer) is meaningful.
            zero = V(np.zeros(4, np.float32), GType("float", (4,)))
            arr = ArrayVal([zero, zero, zero, zero], GType("float", (4,)))
            self.globals[name] = arr
            return arr
        return None

    def _write_var(self, name: str, val) -> None:
        fr = self.frames[-1]
        if name in fr.locals:
            fr.locals[name] = _masked_merge(fr.locals[name], val, self.mask, self.dev)
        elif name in self.globals:
            self.globals[name] = _masked_merge(self.globals[name], val, self.mask, self.dev)
            self.written_globals.add(name)
        elif name in self._BUILTIN_OUTPUTS:
            self.globals[name] = val
            self.written_globals.add(name)
        else:
            fr.locals[name] = val

    # -- expressions ----------------------------------------------------
    def eval(self, e: A.Expr):
        if isinstance(e, A.Num):
            if e.is_float:
                return V(np.float32(e.value), FLOAT)
            return V(np.int32(e.value), INT)
        if isinstance(e, A.BoolLit):
            return V(np.bool_(e.value), BOOL)
        if isinstance(e, A.Ident):
            v = self._lookup(e.name)
            if v is None:
                raise UnsupportedShaderError(f"undefined identifier {e.name!r}")
            return v
        if isinstance(e, A.Member):
            return self._eval_member(e)
        if isinstance(e, A.Index):
            return self._eval_index(e)
        if isinstance(e, A.Binary):
            return apply_binary(e.op, self.eval(e.left), self.eval(e.right))
        if isinstance(e, A.Unary):
            return apply_unary(e.op, self.eval(e.operand))
        if isinstance(e, A.Assign):
            return self._eval_assign(e)
        if isinstance(e, A.Ternary):
            return self._eval_ternary(e)
        if isinstance(e, A.Call):
            return self._eval_call(e)
        if isinstance(e, (A.PrefixIncDec, A.PostfixIncDec)):
            return self._eval_incdec(e)
        if isinstance(e, A.Comma):
            out = None
            for p in e.parts:
                out = self.eval(p)
            return out
        if isinstance(e, A.BraceInit):
            raise UnsupportedShaderError("brace initializer outside declaration")
        raise UnsupportedShaderError(f"expression {type(e).__name__}")

    def _eval_member(self, e: A.Member):
        obj = self.eval(e.obj)
        if isinstance(obj, StructVal):
            if e.name not in obj.fields:
                raise UnsupportedShaderError(f"no field {e.name} in struct {obj.name}")
            return obj.fields[e.name]
        if isinstance(obj, V):
            return swizzle_read(obj, e.name)
        raise UnsupportedShaderError(f"member access on {type(obj).__name__}")

    def _eval_index(self, e: A.Index):
        obj = self.eval(e.obj)
        idx = self.eval(e.index)
        if isinstance(obj, ArrayVal):
            if is_concrete(idx.data) and idx.batch_shape == ():
                # Out-of-bounds array reads are UB in GLSL; llvmpipe
                # returns 0.0 (probed: a[-2] and a[n+2] both read as 0),
                # and shaders like ntsc-xot lean on that for their
                # chroma-window edge taps.
                k = int(idx.data)
                if 0 <= k < len(obj.elems):
                    return obj.elems[k]
                return _zero_like_elem(obj.elems[0])
            return self._dynamic_array_index(obj, idx)
        if isinstance(obj, V):
            if obj.type.is_matrix:
                c, r = obj.type.shape
                if is_concrete(idx.data) and idx.batch_shape == ():
                    return V(obj.data[..., int(idx.data), :], GType("float", (r,)))
                raise UnsupportedShaderError("dynamic matrix column index")
            if obj.type.is_vector:
                if is_concrete(idx.data) and idx.batch_shape == ():
                    return V(obj.data[..., int(idx.data)], GType(obj.type.base, ()))
                # dynamic component: select via where-chain
                n = obj.type.shape[0]
                i = smart_device(idx.astype("int").data, self.dev)
                od = smart_device(obj.data, self.dev)
                out = od[..., 0]
                for k in range(1, n):
                    out = tnp.where(i == k, od[..., k], out)
                return V(out, GType(obj.type.base, ()))
        raise UnsupportedShaderError(f"index on {type(obj).__name__}")

    def _dynamic_array_index(self, arr: ArrayVal, idx: V):
        if not arr.elems:
            raise UnsupportedShaderError("index into empty array")
        proto = arr.elems[0]
        iraw = smart_device(idx.astype("int").data, self.dev)
        # Clipped before use: an out-of-range index must never reach a
        # device gather (on CUDA it is a device-side assert).
        i = torch.clamp(iraw, 0, len(arr.elems) - 1)
        oob = (iraw < 0) | (iraw >= len(arr.elems))
        if isinstance(proto, V):
            datas = [smart_device(x.data, self.dev) for x in arr.elems]
            if i.dim() == 0:
                stacked = tnp.stack(datas, axis=0)
                out = stacked.index_select(0, i.reshape(1).to(torch.int64))[0]
                out = torch.where(oob, torch.zeros((), dtype=out.dtype, device=out.device), out)
                return V(out, proto.type)
            # Batched index: select elementwise (a where-chain), NOT an
            # outer take — elements may themselves be batch-shaped and an
            # outer take would produce [batch, batch, ...] tensors.
            sel = i
            type_rank = len(proto.type.shape)
            out = datas[0]
            out = out.expand(
                tnp.broadcast_shapes(*(d.shape for d in datas))
            ) if len({tuple(d.shape) for d in datas}) > 1 else out
            for k in range(1, len(datas)):
                m = sel == k
                mm = m
                for _ in range(type_rank):
                    mm = mm[..., None]
                out = torch.where(mm, datas[k], out)
            ob = oob
            for _ in range(type_rank):
                ob = ob[..., None]
            out = torch.where(ob, torch.zeros((), dtype=out.dtype, device=out.device), out)
            return V(out, proto.type)
        if isinstance(proto, ArrayVal):
            # dynamic index into an array of arrays: recurse per element
            inner = [
                self._dynamic_array_index(
                    ArrayVal([a.elems[j] for a in arr.elems], proto.elem_type), idx
                )
                for j in range(len(proto.elems))
            ]
            return ArrayVal(inner, proto.elem_type)
        raise UnsupportedShaderError("dynamic index into non-numeric array")

    def _eval_ternary(self, e: A.Ternary):
        cond = self.eval(e.cond).astype("bool")
        if is_concrete(cond.data) and cond.batch_shape == ():
            return self.eval(e.then) if bool(cond.data) else self.eval(e.other)
        a = self.eval(e.then)
        b = self.eval(e.other)
        if isinstance(a, V) and isinstance(b, V):
            aa, bb, t = align_pair(a, b)
            m = smart_device(np.asarray(cond.data) if is_concrete(cond.data) else cond.data, self.dev)
            for _ in t.shape:
                m = m[..., None]
            av = smart_device(aa.data, self.dev)
            bv = smart_device(bb.data, self.dev)
            return V(tnp.where(m, av, bv), t)
        raise UnsupportedShaderError("ternary on non-numeric values")

    def _eval_incdec(self, e):
        target = e.operand
        old = self.eval(target)
        one = V(np.int32(1) if old.type.base in ("int", "uint") else np.float32(1.0), GType(old.type.base, ()))
        new = apply_binary("+" if e.op == "++" else "-", old, one)
        self._assign_lvalue(target, new)
        return old if isinstance(e, A.PostfixIncDec) else new

    def _eval_assign(self, e: A.Assign):
        if e.op == "=":
            val = self.eval(e.value)
        else:
            cur = self.eval(e.target)
            val = apply_binary(e.op[:-1], cur, self.eval(e.value))
        # Preserve the declared component type on simple-variable writes
        # (e.g. `float x; x = 1;`).
        cur = self._peek_lvalue(e.target)
        if isinstance(cur, V) and isinstance(val, V):
            if cur.type.shape == val.type.shape:
                val = val.astype(cur.type.base)
            elif val.type.is_scalar and cur.type.shape:
                val = self._convert_scalar(val, cur.type)
            elif (
                val.type.is_vector
                and cur.type.is_vector
                and val.type.shape[0] > cur.type.shape[0]
            ):
                val = self._convert_scalar(val, cur.type)
        self._assign_lvalue(e.target, val)
        return val

    def _peek_lvalue(self, target: A.Expr):
        try:
            if isinstance(target, A.Ident):
                return self._lookup(target.name)
            return self.eval(target)
        except GlslEvalError:
            return None

    def _assign_lvalue(self, target: A.Expr, val) -> None:
        if isinstance(target, A.Ident):
            self._write_var(target.name, val)
            return
        if isinstance(target, A.Member):
            obj = self.eval(target.obj)
            if isinstance(obj, StructVal):
                ns = obj.copy()
                ns.fields[target.name] = _masked_merge(
                    ns.fields.get(target.name), val, self.mask, self.dev
                )
                self._assign_lvalue_raw(target.obj, ns)
                return
            if isinstance(obj, V) and obj.type.is_vector:
                merged = swizzle_write(obj, target.name, val)
                if self.mask is not None:
                    merged = _masked_merge(obj, merged, self.mask, self.dev)
                self._assign_lvalue_raw(target.obj, merged)
                return
            if isinstance(obj, V) and obj.type.is_scalar and swizzle_indices(target.name) == [0]:
                self._assign_lvalue(target.obj, val)
                return
            raise UnsupportedShaderError(f"cannot assign member .{target.name}")
        if isinstance(target, A.Index):
            obj = self.eval(target.obj)
            idx = self.eval(target.index)
            if isinstance(obj, ArrayVal):
                if is_concrete(idx.data) and idx.batch_shape == ():
                    na = obj.copy()
                    i = int(idx.data)
                    na.elems[i] = _masked_merge(na.elems[i], val, self.mask, self.dev)
                    self._assign_lvalue_raw(target.obj, na)
                    return
                raise UnsupportedShaderError("dynamic array write")
            if isinstance(obj, V) and obj.type.is_vector:
                if is_concrete(idx.data) and idx.batch_shape == ():
                    name = "xyzw"[int(idx.data)]
                    self._assign_lvalue(A.Member(target.obj, name), val)
                    return
                raise UnsupportedShaderError("dynamic vector component write")
            if isinstance(obj, V) and obj.type.is_matrix:
                if is_concrete(idx.data) and idx.batch_shape == ():
                    i = int(idx.data)
                    col = val if isinstance(val, V) else val
                    data = obj.data if not is_concrete(obj.data) or not is_concrete(col.data) else np.array(obj.data, copy=True)
                    if is_concrete(data) and is_concrete(col.data):
                        cb = np.shape(col.data)[:-1]
                        if cb and np.shape(data)[:-2] != cb:
                            data = np.broadcast_to(data, cb + data.shape[-2:]).copy()
                        data[..., i, :] = col.data
                        nv = V(data, obj.type)
                    else:
                        d = smart_device(obj.data, self.dev)
                        cd = smart_device(col.data, self.dev)
                        cb = tuple(cd.shape[:-1])
                        if cb and tuple(d.shape[: len(cb)]) != cb:
                            # batched column into an unbatched matrix
                            d = d.expand(cb + tuple(d.shape[-2:]))
                        # A fresh copy: the old matrix may be shared.
                        d = d.clone()
                        d[..., i, :] = cd
                        nv = V(d, obj.type)
                    if self.mask is not None:
                        nv = _masked_merge(obj, nv, self.mask, self.dev)
                    self._assign_lvalue_raw(target.obj, nv)
                    return
                raise UnsupportedShaderError("dynamic matrix column write")
            raise UnsupportedShaderError("unsupported indexed assignment")
        raise UnsupportedShaderError(
            f"unsupported l-value {type(target).__name__}"
        )

    def _assign_lvalue_raw(self, target: A.Expr, val) -> None:
        """Assign without re-applying the mask (already merged)."""
        if isinstance(target, A.Ident):
            fr = self.frames[-1]
            if target.name in fr.locals:
                fr.locals[target.name] = val
            elif target.name in self.globals:
                self.globals[target.name] = val
                self.written_globals.add(target.name)
            else:
                fr.locals[target.name] = val
            return
        if isinstance(target, A.Member):
            obj = self.eval(target.obj)
            if isinstance(obj, StructVal):
                ns = obj.copy()
                ns.fields[target.name] = val
                self._assign_lvalue_raw(target.obj, ns)
                return
            if isinstance(obj, V):
                merged = swizzle_write(obj, target.name, val) if isinstance(val, V) and swizzle_indices(target.name) else val
                self._assign_lvalue_raw(target.obj, merged)
                return
        if isinstance(target, A.Index):
            obj = self.eval(target.obj)
            idx = self.eval(target.index)
            if isinstance(obj, ArrayVal) and is_concrete(idx.data):
                k = int(idx.data)
                if not 0 <= k < len(obj.elems):
                    return  # OOB array write: dropped (GLSL UB; llvmpipe)
                na = obj.copy()
                na.elems[k] = val
                self._assign_lvalue_raw(target.obj, na)
                return
        raise UnsupportedShaderError("unsupported raw l-value")

    # -- calls ----------------------------------------------------------
    def _eval_call(self, e: A.Call):
        name = e.func
        # Type constructors
        if name in TYPE_NAMES:
            args = [self.eval(a) for a in e.args]
            return self._construct(name, args)
        if name in self.structs:
            args = [self.eval(a) for a in e.args]
            sd = self.structs[name]
            fields = {fname: arg for (ftype, fname, _), arg in zip(sd.fields, args)}
            return StructVal(name, fields)
        if name in _TEXTURE_FNS:
            return self._eval_texture(name, e.args)
        if name in ("dFdx", "dFdy", "fwidth"):
            return self._eval_derivative(name, e.args)
        if name == "modf" and len(e.args) == 2:
            # modf(x, out ipart): returns fractional part, writes integral.
            x = self.eval(e.args[0]).astype("float")
            xp = np if is_concrete(x.data) else tnp
            ip = xp.trunc(x.data)
            self._assign_lvalue(e.args[1], V(ip, x.type))
            return V(x.data - ip, x.type)
        if name in self.fns:
            return self._call_user(name, e)
        if is_builtin(name):
            args = [self.eval(a) for a in e.args]
            return call_builtin(name, args)
        raise UnsupportedShaderError(f"unknown function {name!r}")

    def _construct(self, type_name: str, args: list):
        t = TYPE_NAMES[type_name]
        # Array constructor: float[2](a, b) parses as Call('float', [a, b]).
        if t.is_scalar and len(args) > 1:
            return ArrayVal([self._convert_scalar(a, t) for a in args], t)
        if t.is_scalar:
            a = args[0]
            if not a.type.is_scalar:
                a = V(a.data[..., 0], GType(a.type.base, ()))
            return a.astype(t.base)
        if t.is_matrix:
            return self._construct_matrix(t, args)
        # vector
        n = t.shape[0]
        if len(args) == 1 and args[0].type.is_scalar:
            return args[0].astype(t.base).expand_to(t.shape)
        if len(args) == 1 and args[0].type.is_matrix:
            # GLSL: a matrix argument is consumed column-major, e.g.
            # vec4(mat2) = (m[0].x, m[0].y, m[1].x, m[1].y)
            # (crt-royale geometry-aa builds its pixel-to-video matrix
            # this way).
            m = args[0]
            cols, rows = m.type.shape
            if cols * rows < n:
                raise GlslEvalError(f"vec{n}({m.type}) too few components")
            xp = np if is_concrete(m.data) else tnp
            flat = xp.reshape(
                m.data, m.data.shape[: m.data.ndim - 2] + (cols * rows,)
            )
            return V(flat[..., :n], GType(t.base, (n,))).astype(t.base)
        comps = []
        comp_affs: list = []
        comp_deps: list = []
        for a in args:
            if a.type.is_scalar:
                comps.append(a.astype(t.base).data)
                fa = affine_of(a, 1) if t.base == "float" else None
                comp_affs.append(fa[0] if fa else None)
                da = deps_of(a, 1)
                comp_deps.append(da[0] if da else None)
            else:
                d = a.astype(t.base).data
                fa = affine_of(a, a.type.shape[0]) if t.base == "float" else None
                da = deps_of(a, a.type.shape[0])
                for i in range(a.type.shape[0]):
                    comps.append(d[..., i])
                    comp_affs.append(fa[i] if fa else None)
                    comp_deps.append(da[i] if da else None)
        comps = comps[:n]
        comp_affs = comp_affs[:n]
        comp_deps = comp_deps[:n]
        if len(comps) < n:
            raise UnsupportedShaderError(
                f"{type_name} constructor with {len(comps)} components"
            )
        aff = tuple(comp_affs) if all(x is not None for x in comp_affs) else None
        dep = tuple(comp_deps) if all(x is not None for x in comp_deps) else None
        if all(is_concrete(c) for c in comps):
            comps = np.broadcast_arrays(*[np.asarray(c) for c in comps])
            return V(np.stack(comps, axis=-1), t, affine=aff, deps=dep)
        comps = tnp.broadcast_arrays(*[smart_device(c, self.dev) for c in comps])
        return V(tnp.stack(comps, axis=-1), t, affine=aff, deps=dep)

    def _construct_matrix(self, t: GType, args: list):
        c, r = t.shape
        if len(args) == 1 and args[0].type.is_scalar:
            eye = np.zeros((c, r), np.float32)
            for i in range(min(c, r)):
                eye[i, i] = 1.0
            s = args[0].astype("float").data
            if is_concrete(s):
                return V(np.asarray(s)[..., None, None] * eye, t)
            return V(s[..., None, None] * smart_device(eye, self.dev), t)
        if len(args) == 1 and args[0].type.is_matrix:
            src = args[0]
            sc, sr = src.type.shape
            out = np.zeros((c, r), np.float32)
            for i in range(min(c, r)):
                out[i, i] = 1.0
            if is_concrete(src.data):
                out = np.broadcast_to(out, np.shape(src.data)[:-2] + (c, r)).copy()
                out[..., : min(c, sc), : min(r, sr)] = src.data[..., : min(c, sc), : min(r, sr)]
                return V(out, t)
            sd = smart_device(src.data, self.dev)
            base = smart_device(out, self.dev).expand(tuple(sd.shape[:-2]) + (c, r)).clone()
            base[..., : min(c, sc), : min(r, sr)] = sd[..., : min(c, sc), : min(r, sr)]
            return V(base, t)
        if len(args) == c and all(a.type.is_vector for a in args):
            cols = [a.astype("float").data for a in args]
            if all(is_concrete(x) for x in cols):
                cols = np.broadcast_arrays(*[np.asarray(x) for x in cols])
                return V(np.stack(cols, axis=-2), t)
            cols = tnp.broadcast_arrays(*[smart_device(x, self.dev) for x in cols])
            return V(tnp.stack(cols, axis=-2), t)
        # flat scalar list, column-major
        comps = []
        for a in args:
            if a.type.is_scalar:
                comps.append(a.astype("float").data)
            else:
                for i in range(a.type.shape[0]):
                    comps.append(a.astype("float").data[..., i])
        if len(comps) != c * r:
            raise UnsupportedShaderError(f"mat constructor with {len(comps)} comps")
        if all(is_concrete(x) for x in comps):
            comps = np.broadcast_arrays(*[np.asarray(x) for x in comps])
            flat = np.stack(comps, axis=-1)
            return V(flat.reshape(flat.shape[:-1] + (c, r)), t)
        comps = tnp.broadcast_arrays(*[smart_device(x, self.dev) for x in comps])
        flat = tnp.stack(comps, axis=-1)
        return V(flat.reshape(flat.shape[:-1] + (c, r)), t)

    def _call_user(self, name: str, e: A.Call):
        overloads = [c for c in self.fns[name] if len(c.params) == len(e.args)]
        if not overloads:
            raise UnsupportedShaderError(f"no overload of {name} with {len(e.args)} args")
        args = [self.eval(a) for a in e.args]
        fn = overloads[0]
        if len(overloads) > 1:
            # GLSL overload resolution (the GL compiler's, which the
            # reference relies on): exact parameter-shape match wins;
            # base-type-only differences (int vs float) are implicit
            # conversions; a shape mismatch disqualifies the candidate
            # (GLSL never promotes scalar->vector at a call site).
            # pmalin-waterfalls depends on noise(float)/noise(vec3) and
            # SmoothNoise(float)/SmoothNoise(vec3) dispatching by type.
            best, best_score = None, -1
            for cand in overloads:
                score = 0
                for p, a in zip(cand.params, args):
                    gt = TYPE_NAMES.get(p.type.name)
                    if gt is None or not isinstance(a, V):
                        continue  # structs/arrays/samplers: wildcard
                    if gt.shape == a.type.shape:
                        score += 2 if gt.base == a.type.base else 1
                    else:
                        score = -1
                        break
                if score > best_score:
                    best, best_score = cand, score
            if best is not None and best_score >= 0:
                fn = best
        frame = _Frame()
        for p, a in zip(fn.params, args):
            if isinstance(a, V):
                gt = TYPE_NAMES.get(p.type.name)
                if gt is not None and not p.array_size:
                    a = self._convert_scalar(a, gt)
            elif isinstance(a, ArrayVal):
                a = a.copy()
            elif isinstance(a, StructVal):
                a = a.copy()
            frame.locals[p.name] = a
        self.frames.append(frame)
        outer_loops = self.loop_stack
        self.loop_stack = []
        try:
            self._exec_block_stmts(fn.body.body)
        except _ReturnSignal:
            pass
        finally:
            self.loop_stack = outer_loops
            self.frames.pop()
        # copy back out/inout params
        for p, arg_expr in zip(fn.params, e.args):
            if p.is_out:
                self._assign_lvalue(arg_expr, frame.locals[p.name])
        ret = frame.ret_val
        if ret is None and fn.return_type.name != "void":
            raise UnsupportedShaderError(f"function {name} missing return")
        # Coerce to the declared return type (drivers tolerate e.g. a
        # vec3 function returning texture(...).rgb-less vec4; the
        # reference repairs such shaders by rewriting, ShaderEngine.cpp:450).
        if isinstance(ret, V):
            want = TYPE_NAMES.get(fn.return_type.name)
            if want is not None and want.shape != ret.type.shape:
                ret = self._convert_scalar(ret, want)
        return ret

    # -- textures -------------------------------------------------------
    def _eval_texture(self, name: str, raw_args: list[A.Expr]):
        from retrocapture_tpu_torch.ops.sampling import sample2d_affine, sample2d_affine_mip

        args = [self.eval(a) for a in raw_args]
        sampler = args[0]
        if not isinstance(sampler, SamplerVal):
            raise UnsupportedShaderError(f"{name}: first arg is not a sampler")
        w, h = sampler.size

        if name == "textureSize":
            return V(np.array([w, h], np.int32), GType("int", (2,)))
        if name in ("texelFetch", "texelFetchOffset"):
            ip = args[1].astype("int")
            if name == "texelFetchOffset" and len(args) >= 4:
                ip = apply_binary("+", ip, args[3].astype("int"))
            ix0 = smart_device(np.asarray(ip.data[..., 0]) if is_concrete(ip.data) else ip.data[..., 0], self.dev)
            iy0 = smart_device(np.asarray(ip.data[..., 1]) if is_concrete(ip.data) else ip.data[..., 1], self.dev)
            # Out-of-range texelFetch returns vec4(0) on the driver
            # (probed llvmpipe 2026-08-18: all four channels, alpha
            # included) — lcd-grid-v2 reads texel -1 at the left edge.
            # Indices are clipped before the gather.
            valid = (ix0 >= 0) & (ix0 < w) & (iy0 >= 0) & (iy0 < h)
            ix = torch.clamp(ix0, 0, w - 1)
            iy = torch.clamp(iy0, 0, h - 1)
            flat = sampler.tex.reshape(h * w, -1)
            lin = (iy * w + ix).to(torch.int64)
            out = flat.index_select(0, lin.reshape(-1)).reshape(tuple(lin.shape) + (flat.shape[1],))
            out = out * valid[..., None].to(out.dtype)
            return V(out, GType("float", (4,)))

        uv = args[1].astype("float")
        if name in ("texture2DProj", "textureProj"):
            d = uv.data
            last = uv.type.shape[0] - 1
            uv = V(d[..., :2] / d[..., last : last + 1], GType("float", (2,)))

        # Explicit-LOD sampling of a mipmapped texture (textureLod /
        # tex2Dlod-era code like crt-royale's mask resizers): a concrete
        # LOD selects box-pyramid levels with a trilinear blend.
        if sampler.mipmap and name in ("textureLod", "texture2DLod") and len(args) >= 3:
            lod_v = args[2]
            if is_concrete(lod_v.data) and lod_v.batch_shape == ():
                from retrocapture_tpu_torch.ops.sampling import sample2d_lod

                lod = float(np.asarray(lod_v.astype("float").data))
                d = uv.data
                if is_concrete(d):
                    d = np.asarray(d, np.float32)
                out = sample2d_lod(
                    sampler.tex,
                    d[..., 0],
                    d[..., 1],
                    lod,
                    filter_linear=sampler.filter_linear,
                    wrap_mode=sampler.wrap_mode,
                )
                return V(out, GType("float", (4,)))
        if name in ("textureOffset", "texture2DOffset", "textureLodOffset"):
            off = args[3 if name == "textureLodOffset" else 2].astype("float")
            texel = np.array([1.0 / w, 1.0 / h], np.float32)
            new_aff = None
            if uv.affine is not None and is_concrete(off.data) and off.batch_shape == ():
                od = np.asarray(off.data, np.float64)
                new_aff = (
                    (uv.affine[0][0], uv.affine[0][1], uv.affine[0][2] + od[0] / w),
                    (uv.affine[1][0], uv.affine[1][1], uv.affine[1][2] + od[1] / h),
                )
            uvd, offd, texel = devicify_mixed([uv.data[..., :2], off.data, texel])
            uv = V(
                uvd + offd * texel,
                GType("float", (2,)),
                affine=new_aff,
                deps=uv.deps[:2] if uv.deps and len(uv.deps) >= 2 else None,
            )

        # Affine fast path: coords provably separable over the output grid
        # → per-axis resampling, no per-pixel coordinate tensors at all
        # (sampling.sample2d_affine).
        aff = affine_of(uv, uv.type.shape[0]) if uv.type.is_vector else None
        if (
            aff is not None
            and len(aff) >= 2
            and aff[0][1] == 0.0
            and aff[1][0] == 0.0
        ):
            ow, oh = self.ctx.out_size
            bs = uv.batch_shape
            if bs == (oh, ow):
                if not sampler.mipmap and is_concrete(uv.data):
                    # Concrete coords carry the evaluator's exact f32
                    # bits (stepped plane math + shader ops); the affine
                    # reconstruction below recomputes them through f64
                    # a0/dadx and can land 1 ulp off, flipping NEAREST
                    # taps that sit exactly on texel boundaries
                    # (crt-blurPi's TEX0 +- 0.5-texel offsets). Sample
                    # from the data — sample2d's separable detection
                    # recovers the same lowering.
                    d = np.asarray(uv.data, np.float32)
                    return self._quantized_tap(sampler, d[..., 0], d[..., 1])
                fn = sample2d_affine_mip if sampler.mipmap else sample2d_affine
                out = fn(
                    sampler.tex,
                    aff[0],
                    aff[1],
                    oh,
                    ow,
                    filter_linear=sampler.filter_linear,
                    wrap_mode=sampler.wrap_mode,
                )
                return V(out, GType("float", (4,)))

        # Separable tensor path: axis-dependence metadata proves u varies
        # only along columns and v only along rows even though the values
        # are tensors (floor/fract/clamp texel sharpening — sharp-bilinear,
        # pixellate, quilez). Slice representative vectors and resample
        # per axis instead of taking the 2-D warp path.
        dep = deps_of(uv, uv.type.shape[0]) if uv.type.is_vector else None
        if (
            dep is not None
            and len(dep) >= 2
            and "y" not in dep[0]
            and "x" not in dep[1]
            and not sampler.mipmap
        ):
            ow, oh = self.ctx.out_size
            if uv.batch_shape == (oh, ow):
                from retrocapture_tpu_torch.ops.sampling import sample2d_separable

                d = uv.data
                out = sample2d_separable(
                    sampler.tex,
                    d[0, :, 0],
                    d[:, 0, 1],
                    filter_linear=sampler.filter_linear,
                    wrap_mode=sampler.wrap_mode,
                )
                res_dep = dep[0] | dep[1]
                return V(out, GType("float", (4,)), deps=(res_dep,) * 4)
        if is_concrete(uv.data) and uv.type.is_vector and np.ndim(uv.data) == 3:
            # Concrete grids without axis-dependence metadata: prove
            # separability by value (plane-exact varyings folded through
            # concrete texel math).
            from retrocapture_tpu_torch.ops.sampling import (
                sample2d_separable,
                separable_rows,
            )

            dnp = np.asarray(uv.data, np.float32)
            rows = separable_rows(dnp[..., 0], dnp[..., 1])
            if rows is not None and not sampler.mipmap:
                out = sample2d_separable(
                    sampler.tex,
                    rows[0],
                    rows[1],
                    filter_linear=sampler.filter_linear,
                    wrap_mode=sampler.wrap_mode,
                )
                return V(out, GType("float", (4,)))

        d = uv.data
        if is_concrete(d):
            d = np.asarray(d, np.float32)
        u, v = d[..., 0], d[..., 1]
        if sampler.mipmap and u.ndim == 2:
            # Warped tap on a mipmap_input pass: per-pixel-LOD trilinear
            # over the box pyramid (the reference generates mipmaps on
            # the bound input for any consumer, ShaderEngine.cpp:1004-1036).
            from retrocapture_tpu_torch.ops.sampling import sample2d_warped_mip

            out = sample2d_warped_mip(
                sampler.tex,
                u,
                v,
                filter_linear=sampler.filter_linear,
                wrap_mode=sampler.wrap_mode,
            )
            return V(out, GType("float", (4,)))
        return self._quantized_tap(sampler, u, v)

    @staticmethod
    def _quantized_tap(sampler: SamplerVal, u, v) -> V:
        """``sample2d`` on the paths where the reference passes the
        sampler's ``quantized`` flag. Where it re-materialises the tap
        through uint8, its HLO holds ``convert(k) * f32(1/255)`` for the
        u8 code ``k``: a product with a constant factor that later
        scalar constants fold into (builtins._product). Its saturating
        u8 convert puts a select between that multiply and any add, so
        the product is never contracted (``fusable`` False)."""
        from retrocapture_tpu_torch.ops.sampling import sample2d_requant

        out, requant = sample2d_requant(
            sampler.tex, u, v, filter_linear=sampler.filter_linear, wrap_mode=sampler.wrap_mode
        )
        prod = None
        if requant and sampler.quantized:
            prod = (torch.round(out * 255.0), np.float32(1.0 / 255.0), False)
        return V(out, GType("float", (4,)), prod=prod)

    def _eval_derivative(self, name: str, raw_args: list[A.Expr]):
        v = self.eval(raw_args[0]).astype("float")
        d = v.data
        aff = v.affine
        if aff is not None and len(aff) == v.type.ncomp:
            # Affine values have exact constant screen-space derivatives.
            if name == "dFdx":
                vals = [t[0] for t in aff]
            elif name == "dFdy":
                vals = [t[1] for t in aff]
            else:
                vals = [abs(t[0]) + abs(t[1]) for t in aff]
            arr = np.asarray(vals, np.float32)
            if v.type.is_scalar:
                return V(arr[0], v.type)
            return V(arr, v.type)
        if is_concrete(d):
            # Concrete-folded per-pixel values (plane varyings, folded
            # coordinate math) still have real screen-space derivatives
            # — GL evaluates them per 2x2 quad like any fragment value
            # (crt-geom-famicom's fwidth(ratio_scale.y) after the
            # curvature transform). Only rank-<2 concrete data (true
            # constants/uniforms) has zero derivatives.
            arr = np.asarray(d)
            if arr.ndim >= 2 + (1 if v.type.shape else 0):

                def np_quad(a, axis):
                    fwd = np.roll(a, -1, axis=axis) - a
                    bwd = a - np.roll(a, 1, axis=axis)
                    idx = np.arange(a.shape[axis]) % 2 == 0
                    shape = [1] * a.ndim
                    shape[axis] = a.shape[axis]
                    return np.where(idx.reshape(shape), fwd, bwd)

                if name == "dFdx":
                    return V(np_quad(arr, 1).astype(np.float32), v.type)
                if name == "dFdy":
                    return V(np_quad(arr, 0).astype(np.float32), v.type)
                out = np.abs(np_quad(arr, 1)) + np.abs(np_quad(arr, 0))
                return V(out.astype(np.float32), v.type)
            return V(np.zeros_like(arr), v.type)
        nb = len(v.batch_shape)
        if nb < 2:
            return V(torch.zeros_like(d), v.type)
        # Batch layout is (H, W); GL quad derivatives are constant per 2x2
        # quad — forward difference on the even texel, replicated.
        ax_y, ax_x = 0, 1

        def quad_diff(arr, axis):
            n = arr.shape[axis]
            fwd = torch.roll(arr, -1, dims=axis) - arr
            bwd = arr - torch.roll(arr, 1, dims=axis)
            idx = torch.arange(n, device=arr.device)
            even = (idx % 2) == 0
            shape = [1] * arr.dim()
            shape[axis] = n
            even = even.reshape(shape)
            return torch.where(even, fwd, bwd)

        if name == "dFdx":
            return V(quad_diff(d, ax_x), v.type)
        if name == "dFdy":
            return V(quad_diff(d, ax_y), v.type)
        return V(torch.abs(quad_diff(d, ax_x)) + torch.abs(quad_diff(d, ax_y)), v.type)


def _shift_loop_bound(cond, body):
    """Iteration bound for ``while (v != 0) { ...; v >>= k; }`` loops
    (omniscale's popcount): a 32-bit int right-shifted by k >= 1 every
    iteration provably reaches 0 within ceil(32/k) trips, so the traced
    condition needs no unroll-cap failure. Requires every write to v in
    the body to be the shift."""
    if not (
        isinstance(cond, A.Binary)
        and cond.op in ("!=", ">")
        and isinstance(cond.left, A.Ident)
        and isinstance(cond.right, A.Num)
        and cond.right.value == 0
    ):
        return None
    vname = cond.left.name
    import dataclasses
    import math

    shift_k = None
    writes = 0
    stack = [body]
    while stack:
        n = stack.pop()
        if n is None:
            continue
        if isinstance(n, list):
            stack.extend(n)
            continue
        if isinstance(n, A.Assign) and isinstance(n.target, A.Ident) and n.target.name == vname:
            writes += 1
            if n.op == ">>=" and isinstance(n.value, A.Num) and n.value.value >= 1:
                shift_k = int(n.value.value)
            elif (
                n.op == "="
                and isinstance(n.value, A.Binary)
                and n.value.op == ">>"
                and isinstance(n.value.left, A.Ident)
                and n.value.left.name == vname
                and isinstance(n.value.right, A.Num)
                and n.value.right.value >= 1
            ):
                shift_k = int(n.value.right.value)
        elif isinstance(n, (A.PrefixIncDec, A.PostfixIncDec)) and isinstance(n.operand, A.Ident) and n.operand.name == vname:
            writes += 2  # not a shift: disqualify
        elif isinstance(n, A.DeclStmt) and any(d.name == vname for d in n.declarators):
            writes += 2
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            for f in dataclasses.fields(n):
                stack.append(getattr(n, f.name))
    if shift_k is None or writes != 1:
        return None
    return int(math.ceil(32 / shift_k)) + 1


def _walk_exprs(node):
    """Yield every Expr reachable from an AST node (dataclass walk)."""
    import dataclasses

    stack = [node]
    while stack:
        n = stack.pop()
        if n is None:
            continue
        if isinstance(n, list):
            stack.extend(n)
            continue
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            if isinstance(n, A.Expr):
                yield n
            for f in dataclasses.fields(n):
                stack.append(getattr(n, f.name))


def _mentions_var(node, name: str) -> bool:
    return any(isinstance(e, A.Ident) and e.name == name for e in _walk_exprs(node))


def _writes_var(node, name: str) -> bool:
    """Conservative: any assignment/inc-dec targeting `name`, or a
    shadowing declaration of it, anywhere under `node`."""
    import dataclasses

    stack = [node]
    while stack:
        n = stack.pop()
        if n is None:
            continue
        if isinstance(n, list):
            stack.extend(n)
            continue
        if isinstance(n, A.Assign) and isinstance(n.target, A.Ident) and n.target.name == name:
            return True
        if isinstance(n, (A.PrefixIncDec, A.PostfixIncDec)) and isinstance(n.operand, A.Ident) and n.operand.name == name:
            return True
        if isinstance(n, A.DeclStmt) and any(d.name == name for d in n.declarators):
            return True
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            for f in dataclasses.fields(n):
                stack.append(getattr(n, f.name))
    return False


def _lv_root(e) -> Optional[str]:
    """Root identifier of an l-value chain (`a.b[i].c` -> 'a')."""
    while isinstance(e, (A.Member, A.Index)):
        e = e.obj
    return e.name if isinstance(e, A.Ident) else None


def _expr_idents(e) -> set[str]:
    return {x.name for x in _walk_exprs(e) if isinstance(x, A.Ident)}


def _decl_names(node) -> set[str]:
    """Every Declarator name anywhere under ``node`` (the interpreter's
    frame scope is flat, so any declaration in a function body names a
    frame-local for the whole activation)."""
    import dataclasses

    out: set[str] = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if n is None:
            continue
        if isinstance(n, list):
            stack.extend(n)
            continue
        if isinstance(n, A.DeclStmt):
            out.update(d.name for d in n.declarators)
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            for f in dataclasses.fields(n):
                stack.append(getattr(n, f.name))
    return out


class _BodyScan:
    """Syntactic facts about a counted loop's body+step needed to roll it
    into ``lax.fori_loop``: every caller-visible name the body can write
    (assignment/inc-dec roots, out/inout copy-backs, and — transitively —
    global writes of called user functions), plus whether it contains
    break/continue at this loop's level, return, or discard. ``ok=False``
    means a construct the analysis can't bound (non-ident l-value root,
    recursion) — the caller then unrolls eagerly as before."""

    def __init__(self, fns: dict):
        self.fns = fns
        self.writes: set[str] = set()
        self.has_break = False
        self.has_continue = False
        self.has_return = False
        self.has_discard = False
        self.ok = True
        self._memo: dict[int, tuple] = {}
        self._stack: set[int] = set()

    def scan(self, body, step) -> "_BodyScan":
        self._stmt(body, 0)
        if step is not None:
            self._expr(step)
        return self

    def _stmt(self, s, depth: int) -> None:
        if s is None or not self.ok:
            return
        if isinstance(s, A.Block):
            for p in s.body:
                self._stmt(p, depth)
        elif isinstance(s, A.ExprStmt):
            self._expr(s.expr)
        elif isinstance(s, A.DeclStmt):
            for d in s.declarators:
                # Flat frame scope: the declared value persists past the
                # iteration, so it is loop-carried state.
                self.writes.add(d.name)
                if d.init is not None:
                    self._expr(d.init)
                for dim in d.array_size or []:
                    if dim is not None:
                        self._expr(dim)
        elif isinstance(s, A.If):
            self._expr(s.cond)
            self._stmt(s.then, depth)
            self._stmt(s.other, depth)
        elif isinstance(s, A.For):
            self._stmt(s.init, depth + 1)
            self._expr(s.cond)
            self._expr(s.step)
            self._stmt(s.body, depth + 1)
        elif isinstance(s, A.While):
            self._expr(s.cond)
            self._stmt(s.body, depth + 1)
        elif isinstance(s, A.DoWhile):
            self._stmt(s.body, depth + 1)
            self._expr(s.cond)
        elif isinstance(s, A.Return):
            self.has_return = True
            self._expr(s.value)
        elif isinstance(s, A.Break):
            if depth == 0:
                self.has_break = True
        elif isinstance(s, A.Continue):
            if depth == 0:
                self.has_continue = True
        elif isinstance(s, A.Discard):
            self.has_discard = True
        else:
            self.ok = False

    def _expr(self, e) -> None:
        if e is None or not self.ok:
            return
        if isinstance(e, (A.Num, A.BoolLit, A.Ident)):
            return
        if isinstance(e, A.Assign):
            self._mark_write(e.target)
            self._expr(e.target)
            self._expr(e.value)
        elif isinstance(e, (A.PrefixIncDec, A.PostfixIncDec)):
            self._mark_write(e.operand)
            self._expr(e.operand)
        elif isinstance(e, A.Unary):
            self._expr(e.operand)
        elif isinstance(e, A.Binary):
            self._expr(e.left)
            self._expr(e.right)
        elif isinstance(e, A.Ternary):
            self._expr(e.cond)
            self._expr(e.then)
            self._expr(e.other)
        elif isinstance(e, A.Member):
            self._expr(e.obj)
        elif isinstance(e, A.Index):
            self._expr(e.obj)
            self._expr(e.index)
        elif isinstance(e, (A.Comma, A.BraceInit)):
            for p in e.parts:
                self._expr(p)
        elif isinstance(e, A.Call):
            self._call(e)
        else:
            self.ok = False

    def _mark_write(self, target) -> None:
        root = _lv_root(target)
        if root is None:
            self.ok = False
        else:
            self.writes.add(root)

    def _call(self, e: A.Call) -> None:
        for a in e.args:
            self._expr(a)
        cands = self.fns.get(e.func)
        if cands:
            for fd in cands:
                if len(fd.params) != len(e.args):
                    continue
                for p, arg in zip(fd.params, e.args):
                    if p.is_out:
                        self._mark_write(arg)
                        if not self.ok:
                            return
                gw, disc = self._fn_effects(fd)
                if gw is None:
                    self.ok = False
                    return
                self.writes |= gw
                self.has_discard |= disc
            return
        # Builtins, texture fns, constructors: no caller-visible writes
        # except modf's out parameter.
        if e.func == "modf" and len(e.args) == 2:
            self._mark_write(e.args[1])

    def _fn_effects(self, fd):
        """(frozenset of global writes, has_discard) of a user function,
        transitive over its callees; (None, False) when unanalyzable."""
        key = id(fd)
        if key in self._memo:
            return self._memo[key]
        if key in self._stack or fd.body is None:
            return None, False
        self._stack.add(key)
        sub = _BodyScan(self.fns)
        sub._memo = self._memo
        sub._stack = self._stack
        sub._stmt(fd.body, 1)
        self._stack.discard(key)
        if not sub.ok:
            out = (None, False)
        else:
            local = {p.name for p in fd.params} | _decl_names(fd.body)
            out = (frozenset(sub.writes - local), sub.has_discard)
        self._memo[key] = out
        return out


def _static_trip_count(s):
    """Trip count of ``for (v = E; v </<= E + k; v++/v += c)`` where the
    bounds cancel structurally (dataclass equality compares the two E
    subtrees), or None. E must not mention v and the body must not write
    v, otherwise the cancellation is invalid."""
    import math

    init = s.init
    if isinstance(init, A.ExprStmt):
        init = init.expr
    if (
        isinstance(init, A.DeclStmt)
        and len(init.declarators) == 1
        and init.declarators[0].init is not None
        and init.declarators[0].array_size is None
    ):
        vname, base = init.declarators[0].name, init.declarators[0].init
    elif isinstance(init, A.Assign) and init.op == "=" and isinstance(init.target, A.Ident):
        vname, base = init.target.name, init.value
    else:
        return None
    cond = s.cond
    if not (
        isinstance(cond, A.Binary)
        and cond.op in ("<", "<=")
        and isinstance(cond.left, A.Ident)
        and cond.left.name == vname
    ):
        return None
    rhs = cond.right
    k = None
    if isinstance(rhs, A.Binary) and rhs.op == "+":
        if rhs.left == base and isinstance(rhs.right, A.Num):
            k = rhs.right.value
        elif rhs.right == base and isinstance(rhs.left, A.Num):
            k = rhs.left.value
    if k is None or not isinstance(k, (int, float)) or k <= 0:
        return None
    step = s.step
    c = None
    if (
        isinstance(step, (A.PrefixIncDec, A.PostfixIncDec))
        and isinstance(step.operand, A.Ident)
        and step.operand.name == vname
    ):
        c = 1 if step.op == "++" else None
    elif isinstance(step, A.Assign) and isinstance(step.target, A.Ident) and step.target.name == vname:
        if step.op == "+=" and isinstance(step.value, A.Num):
            c = step.value.value
        elif (
            step.op == "="
            and isinstance(step.value, A.Binary)
            and step.value.op == "+"
            and isinstance(step.value.left, A.Ident)
            and step.value.left.name == vname
            and isinstance(step.value.right, A.Num)
        ):
            c = step.value.right.value
    if not c or c <= 0:
        return None
    if _mentions_var(base, vname) or _writes_var(s.body, vname):
        return None
    if cond.op == "<":
        trips = int(math.ceil(k / c))
    else:  # <=
        trips = int(math.floor(k / c)) + 1
    if trips <= 0 or trips > MAX_UNROLL:
        return None
    return trips


def _is_simple_induction_step(step) -> bool:
    """True when a for-step only writes one simple variable (i++/i--/
    i+=c/i-=c/i=i+c): safe to execute unmasked."""
    if step is None:
        return False
    if isinstance(step, (A.PrefixIncDec, A.PostfixIncDec)):
        return isinstance(step.operand, A.Ident)
    if isinstance(step, A.Assign):
        return isinstance(step.target, A.Ident)
    if isinstance(step, A.Comma):
        return all(_is_simple_induction_step(p) for p in step.parts)
    return False


_TEXTURE_FNS = {
    "texture",
    "texture2D",
    "textureLod",
    "texture2DLod",
    "texelFetch",
    "texelFetchOffset",
    "textureSize",
    "textureOffset",
    "texture2DOffset",
    "textureLodOffset",
    "textureProj",
    "texture2DProj",
    "textureGrad",
}
