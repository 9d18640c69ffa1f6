"""AST node definitions for the GLSL front-end.

The reference compiles GLSL with the GL driver (ShaderEngine::compilePass,
ShaderEngine.cpp:321); we parse it ourselves and lower fragment ``main``
to JAX. Nodes are plain dataclasses; the tree is produced by
``glsl_parser.parse`` and consumed by ``interp.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

# ---------------------------------------------------------------------------
# Expressions


@dataclass
class Expr:
    pass


@dataclass
class Num(Expr):
    value: Union[int, float]
    is_float: bool


@dataclass
class BoolLit(Expr):
    value: bool


@dataclass
class Ident(Expr):
    name: str


@dataclass
class Unary(Expr):
    op: str  # '-', '+', '!', '~'
    operand: Expr


@dataclass
class PrefixIncDec(Expr):
    op: str  # '++' or '--'
    operand: Expr


@dataclass
class PostfixIncDec(Expr):
    op: str
    operand: Expr


@dataclass
class Binary(Expr):
    op: str  # arithmetic / relational / logical / bitwise
    left: Expr
    right: Expr


@dataclass
class Assign(Expr):
    op: str  # '=', '+=', '-=', '*=', '/=', ...
    target: Expr  # Ident | Member | Index
    value: Expr


@dataclass
class Ternary(Expr):
    cond: Expr
    then: Expr
    other: Expr


@dataclass
class Call(Expr):
    func: str  # function or type-constructor name
    args: list[Expr] = field(default_factory=list)


@dataclass
class Member(Expr):
    obj: Expr
    name: str  # swizzle or struct field


@dataclass
class Index(Expr):
    obj: Expr
    index: Expr


@dataclass
class Comma(Expr):
    parts: list[Expr]


@dataclass
class BraceInit(Expr):
    """C-style brace initializer ``{a, b, ...}`` (possibly nested), which
    some corpus shaders use for array constants; GL drivers tolerate it."""

    parts: list[Expr]


# ---------------------------------------------------------------------------
# Statements


@dataclass
class Stmt:
    pass


@dataclass
class ExprStmt(Stmt):
    expr: Expr


@dataclass
class Declarator:
    name: str
    # None = scalar; otherwise one entry per array dimension (an entry is
    # None for an unsized dimension, e.g. `float w[] = ...`).
    array_size: Optional[list[Optional[Expr]]]
    init: Optional[Expr]


@dataclass
class DeclStmt(Stmt):
    type: "TypeSpec"
    declarators: list[Declarator]


@dataclass
class Block(Stmt):
    body: list[Stmt]


@dataclass
class If(Stmt):
    cond: Expr
    then: Stmt
    other: Optional[Stmt]


@dataclass
class For(Stmt):
    init: Optional[Stmt]
    cond: Optional[Expr]
    step: Optional[Expr]
    body: Stmt


@dataclass
class While(Stmt):
    cond: Expr
    body: Stmt


@dataclass
class DoWhile(Stmt):
    body: Stmt
    cond: Expr


@dataclass
class Return(Stmt):
    value: Optional[Expr]


@dataclass
class Break(Stmt):
    pass


@dataclass
class Continue(Stmt):
    pass


@dataclass
class Discard(Stmt):
    pass


# ---------------------------------------------------------------------------
# Declarations / top level


@dataclass
class TypeSpec:
    name: str  # 'float', 'vec3', 'mat3', 'sampler2D', struct name, ...
    qualifiers: tuple[str, ...] = ()
    array_size: Optional[Expr] = None  # for `float[4] x` style

    @property
    def is_const(self) -> bool:
        return "const" in self.qualifiers

    @property
    def is_uniform(self) -> bool:
        return "uniform" in self.qualifiers

    @property
    def is_attribute(self) -> bool:
        return "attribute" in self.qualifiers or "in" in self.qualifiers

    @property
    def is_varying_out(self) -> bool:
        return "varying" in self.qualifiers or "out" in self.qualifiers


@dataclass
class Param:
    type: TypeSpec
    name: str
    array_size: Optional[Expr] = None

    @property
    def is_out(self) -> bool:
        return "out" in self.type.qualifiers or "inout" in self.type.qualifiers

    @property
    def is_in(self) -> bool:
        return "out" not in self.type.qualifiers


@dataclass
class FunctionDef:
    return_type: TypeSpec
    name: str
    params: list[Param]
    body: Optional[Block]  # None => prototype


@dataclass
class StructDef:
    name: str
    fields: list[tuple[TypeSpec, str, Optional[Expr]]]  # (type, name, array_size)


@dataclass
class GlobalDecl:
    type: TypeSpec
    declarators: list[Declarator]


@dataclass
class TranslationUnit:
    decls: list[Union[FunctionDef, GlobalDecl, StructDef]]

    def functions(self) -> dict[str, FunctionDef]:
        out: dict[str, FunctionDef] = {}
        for d in self.decls:
            if isinstance(d, FunctionDef) and d.body is not None:
                out[d.name] = d
        return out

    def globals(self) -> list[GlobalDecl]:
        return [d for d in self.decls if isinstance(d, GlobalDecl)]

    def structs(self) -> dict[str, StructDef]:
        return {d.name: d for d in self.decls if isinstance(d, StructDef)}
