"""GLSL lexer and recursive-descent parser.

Parses preprocessed (macro-free) GLSL — the output of ``cpp.preprocess``
— into the AST of ``glsl_ast``. Covers the C-like subset the RetroArch
shader corpus uses: global/uniform/varying declarations, struct defs,
function definitions with in/out/inout params, full C expression
precedence, if/for/while/do-while/return/break/continue/discard, arrays,
and type constructors. Precision statements, layout qualifiers and
invariant declarations are parsed and discarded.
"""

from __future__ import annotations

import re
from typing import Optional

from retrocapture_tpu_torch.frontend.glsl_ast import (
    Assign,
    Binary,
    Block,
    BoolLit,
    BraceInit,
    Break,
    Call,
    Comma,
    Continue,
    Declarator,
    DeclStmt,
    Discard,
    DoWhile,
    Expr,
    ExprStmt,
    For,
    FunctionDef,
    GlobalDecl,
    Ident,
    If,
    Index,
    Member,
    Num,
    Param,
    PostfixIncDec,
    PrefixIncDec,
    Return,
    Stmt,
    StructDef,
    Ternary,
    TranslationUnit,
    TypeSpec,
    Unary,
    While,
)

__all__ = ["parse", "parse_expression", "GlslSyntaxError"]


class GlslSyntaxError(SyntaxError):
    pass


# ---------------------------------------------------------------------------
# Lexer

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<float>(?:\d+\.\d*|\.\d+)(?:[eE][-+]?\d+)?(?:lf|LF|[fF])?
            |\d+(?:[eE][-+]?\d+)(?:lf|LF|[fF])?
            |\d+[fF])
  | (?P<hex>0[xX][0-9a-fA-F]+[uU]?)
  | (?P<int>\d+[uU]?)
  | (?P<id>[A-Za-z_]\w*)
  | (?P<op><<=|>>=|\+\+|--|<<|>>|<=|>=|==|!=|&&|\|\||\^\^|\+=|-=|\*=|/=|%=|&=|\|=|\^=
        |[-+*/%<>=!&|^~?:;,.(){}\[\]])
  | (?P<bad>.)
    """,
    re.VERBOSE,
)

_QUALIFIERS = {
    "const",
    "uniform",
    "varying",
    "attribute",
    "in",
    "out",
    "inout",
    "highp",
    "mediump",
    "lowp",
    "flat",
    "smooth",
    "noperspective",
    "invariant",
    "centroid",
    "precise",
}

_TYPE_WORDS = {
    "void",
    "float",
    "int",
    "uint",
    "bool",
    "double",
    "vec2",
    "vec3",
    "vec4",
    "ivec2",
    "ivec3",
    "ivec4",
    "uvec2",
    "uvec3",
    "uvec4",
    "bvec2",
    "bvec3",
    "bvec4",
    "dvec2",
    "dvec3",
    "dvec4",
    "mat2",
    "mat3",
    "mat4",
    "mat2x2",
    "mat2x3",
    "mat2x4",
    "mat3x2",
    "mat3x3",
    "mat3x4",
    "mat4x2",
    "mat4x3",
    "mat4x4",
    "sampler1D",
    "sampler2D",
    "sampler3D",
    "samplerCube",
    "sampler2DArray",
    "sampler2DShadow",
}


class _Tok:
    __slots__ = ("kind", "text")

    def __init__(self, kind: str, text: str):
        self.kind = kind
        self.text = text

    def __repr__(self):  # pragma: no cover - debug aid
        return f"{self.kind}:{self.text}"


def _lex(src: str) -> list[_Tok]:
    toks: list[_Tok] = []
    for m in _TOKEN_RE.finditer(src):
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group(0)
        if kind == "bad":
            # Tolerate stray bytes (e.g. encoding replacement chars in
            # comments that survived); skip them.
            continue
        toks.append(_Tok(kind, text))
    toks.append(_Tok("eof", ""))
    return toks


# ---------------------------------------------------------------------------
# Parser


class _Parser:
    def __init__(self, tokens: list[_Tok], struct_names: Optional[set] = None):
        self.toks = tokens
        self.pos = 0
        self.struct_names: set[str] = set(struct_names or ())

    # -- token helpers --------------------------------------------------
    def peek(self, ahead: int = 0) -> _Tok:
        i = min(self.pos + ahead, len(self.toks) - 1)
        return self.toks[i]

    def next(self) -> _Tok:
        t = self.toks[self.pos]
        if t.kind != "eof":
            self.pos += 1
        return t

    def at(self, text: str) -> bool:
        return self.peek().text == text

    def accept(self, text: str) -> bool:
        if self.at(text):
            self.next()
            return True
        return False

    def expect(self, text: str) -> _Tok:
        t = self.peek()
        if t.text != text:
            ctx = " ".join(x.text for x in self.toks[max(0, self.pos - 5) : self.pos + 5])
            raise GlslSyntaxError(f"expected {text!r}, got {t.text!r} near: {ctx}")
        return self.next()

    def is_type_start(self, ahead: int = 0) -> bool:
        t = self.peek(ahead)
        return t.kind == "id" and (
            t.text in _TYPE_WORDS or t.text in _QUALIFIERS or t.text in self.struct_names
        )

    # -- top level ------------------------------------------------------
    def parse_unit(self) -> TranslationUnit:
        decls = []
        while self.peek().kind != "eof":
            if self.accept(";"):
                continue
            if self.at("precision"):
                # precision mediump float;
                while not self.accept(";") and self.peek().kind != "eof":
                    self.next()
                continue
            if self.at("layout"):
                self._skip_layout()
                # A bare `layout(...) ;` or followed by qualifiers+decl
                if self.accept(";"):
                    continue
            if self.at("struct"):
                sd = self.parse_struct()
                decls.append(sd)
                continue
            decls.append(self.parse_global_or_function())
        return TranslationUnit(decls)

    def _skip_layout(self) -> None:
        self.expect("layout")
        self.expect("(")
        depth = 1
        while depth and self.peek().kind != "eof":
            t = self.next().text
            if t == "(":
                depth += 1
            elif t == ")":
                depth -= 1

    def parse_struct(self) -> StructDef:
        self.expect("struct")
        name = self.next().text
        self.struct_names.add(name)
        self.expect("{")
        fields: list[tuple[TypeSpec, str, Optional[Expr]]] = []
        while not self.accept("}"):
            ftype = self.parse_type()
            while True:
                fname = self.next().text
                asize = None
                if self.accept("["):
                    asize = self.parse_expr() if not self.at("]") else None
                    self.expect("]")
                fields.append((ftype, fname, asize))
                if not self.accept(","):
                    break
            self.expect(";")
        # optional instance declarator: struct S {...} name;
        self.accept(";")
        if self.peek().kind == "id" and self.peek(1).text in (";", "=", "["):
            # struct with immediate instance — represent as global decl later;
            # rare in corpus; skip the instance name.
            self.next()
            while not self.accept(";") and self.peek().kind != "eof":
                self.next()
        return StructDef(name, fields)

    def parse_type(self) -> TypeSpec:
        quals: list[str] = []
        while True:
            t = self.peek()
            if t.text == "layout":
                self._skip_layout()
                continue
            if t.kind == "id" and t.text in _QUALIFIERS:
                quals.append(self.next().text)
                continue
            break
        t = self.peek()
        if t.kind != "id":
            raise GlslSyntaxError(f"expected type, got {t.text!r}")
        name = self.next().text
        array_size = None
        if self.accept("["):
            array_size = self.parse_expr() if not self.at("]") else None
            self.expect("]")
        return TypeSpec(name, tuple(quals), array_size)

    def parse_global_or_function(self):
        ts = self.parse_type()
        if self.at(";"):  # e.g. `invariant gl_Position;` style or stray
            self.next()
            return GlobalDecl(ts, [])
        name = self.next().text
        if self.at("("):
            return self.parse_function(ts, name)
        return self.parse_global_tail(ts, name)

    def parse_function(self, ret: TypeSpec, name: str) -> FunctionDef:
        self.expect("(")
        params: list[Param] = []
        if not self.at(")"):
            while True:
                if self.at("void") and self.peek(1).text == ")":
                    self.next()
                    break
                ptype = self.parse_type()
                pname = ""
                if self.peek().kind == "id" and self.peek().text not in (",", ")"):
                    pname = self.next().text
                asize = None
                if self.accept("["):
                    asize = self.parse_expr() if not self.at("]") else None
                    self.expect("]")
                params.append(Param(ptype, pname, asize))
                if not self.accept(","):
                    break
        self.expect(")")
        if self.accept(";"):
            return FunctionDef(ret, name, params, None)
        body = self.parse_block()
        return FunctionDef(ret, name, params, body)

    def _parse_array_dims(self) -> Optional[list]:
        dims = None
        while self.accept("["):
            if dims is None:
                dims = []
            dims.append(self.parse_expr() if not self.at("]") else None)
            self.expect("]")
        return dims

    def _parse_initializer(self) -> Expr:
        if self.at("{"):
            self.next()
            parts: list[Expr] = []
            if not self.at("}"):
                while True:
                    parts.append(self._parse_initializer())
                    if not self.accept(","):
                        break
            self.expect("}")
            return BraceInit(parts)
        return self.parse_assignment()

    def parse_global_tail(self, ts: TypeSpec, first_name: str) -> GlobalDecl:
        decls: list[Declarator] = []
        name = first_name
        while True:
            asize = self._parse_array_dims()
            init = None
            if self.accept("="):
                init = self._parse_initializer()
            decls.append(Declarator(name, asize, init))
            if self.accept(","):
                name = self.next().text
                continue
            break
        self.expect(";")
        return GlobalDecl(ts, decls)

    # -- statements -----------------------------------------------------
    def parse_block(self) -> Block:
        self.expect("{")
        body: list[Stmt] = []
        while not self.accept("}"):
            body.append(self.parse_statement())
        return Block(body)

    def parse_statement(self) -> Stmt:
        t = self.peek()
        if t.text == "{":
            return self.parse_block()
        if t.text == ";":
            self.next()
            return Block([])
        if t.text == "if":
            return self.parse_if()
        if t.text == "for":
            return self.parse_for()
        if t.text == "while":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            return While(cond, self.parse_statement())
        if t.text == "do":
            self.next()
            body = self.parse_statement()
            self.expect("while")
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            self.expect(";")
            return DoWhile(body, cond)
        if t.text == "return":
            self.next()
            val = None if self.at(";") else self.parse_expr()
            self.expect(";")
            return Return(val)
        if t.text == "break":
            self.next()
            self.expect(";")
            return Break()
        if t.text == "continue":
            self.next()
            self.expect(";")
            return Continue()
        if t.text == "discard":
            self.next()
            self.expect(";")
            return Discard()
        if t.text == "precision":
            while not self.accept(";") and self.peek().kind != "eof":
                self.next()
            return Block([])
        if self._looks_like_decl():
            return self.parse_decl_stmt()
        expr = self.parse_expr()
        self.expect(";")
        return ExprStmt(expr)

    def _looks_like_decl(self) -> bool:
        """A statement starts a declaration iff it starts with qualifiers/
        type words followed by an identifier (not a '(' constructor call)."""
        i = 0
        saw_type = False
        while True:
            t = self.peek(i)
            if t.kind != "id":
                return False
            if t.text in _QUALIFIERS:
                i += 1
                continue
            if t.text in _TYPE_WORDS or t.text in self.struct_names:
                saw_type = True
                i += 1
                # allow `float[3] x` style
                if self.peek(i).text == "[":
                    depth = 0
                    while True:
                        txt = self.peek(i).text
                        if txt == "[":
                            depth += 1
                        elif txt == "]":
                            depth -= 1
                            if depth == 0:
                                i += 1
                                break
                        elif self.peek(i).kind == "eof":
                            return False
                        i += 1
                break
            return False
        nxt = self.peek(i)
        return saw_type and nxt.kind == "id"

    def parse_decl_stmt(self) -> DeclStmt:
        ts = self.parse_type()
        decls: list[Declarator] = []
        while True:
            name = self.next().text
            asize = self._parse_array_dims()
            if asize is None and ts.array_size is not None:
                asize = [ts.array_size]  # `float[3] x` style
            init = None
            if self.accept("="):
                init = self._parse_initializer()
            decls.append(Declarator(name, asize, init))
            if not self.accept(","):
                break
        self.expect(";")
        return DeclStmt(ts, decls)

    def parse_if(self) -> If:
        self.expect("if")
        self.expect("(")
        cond = self.parse_expr()
        self.expect(")")
        then = self.parse_statement()
        other = None
        if self.accept("else"):
            other = self.parse_statement()
        return If(cond, then, other)

    def parse_for(self) -> For:
        self.expect("for")
        self.expect("(")
        init: Optional[Stmt] = None
        if not self.accept(";"):
            if self._looks_like_decl():
                init = self.parse_decl_stmt()
            else:
                init = ExprStmt(self.parse_expr())
                self.expect(";")
        cond = None if self.at(";") else self.parse_expr()
        self.expect(";")
        step = None if self.at(")") else self.parse_expr()
        self.expect(")")
        body = self.parse_statement()
        return For(init, cond, step, body)

    # -- expressions ----------------------------------------------------
    def parse_expr(self) -> Expr:
        e = self.parse_assignment()
        if self.at(","):
            parts = [e]
            while self.accept(","):
                parts.append(self.parse_assignment())
            return Comma(parts)
        return e

    _ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "<<=", ">>="}

    def parse_assignment(self) -> Expr:
        left = self.parse_ternary()
        t = self.peek()
        if t.text in self._ASSIGN_OPS:
            self.next()
            value = self.parse_assignment()
            return Assign(t.text, left, value)
        return left

    def parse_ternary(self) -> Expr:
        cond = self.parse_binary(0)
        if self.accept("?"):
            then = self.parse_assignment()
            self.expect(":")
            other = self.parse_assignment()
            return Ternary(cond, then, other)
        return cond

    _PRECEDENCE = [
        ["||"],
        ["^^"],
        ["&&"],
        ["|"],
        ["^"],
        ["&"],
        ["==", "!="],
        ["<", ">", "<=", ">="],
        ["<<", ">>"],
        ["+", "-"],
        ["*", "/", "%"],
    ]

    def parse_binary(self, level: int) -> Expr:
        if level >= len(self._PRECEDENCE):
            return self.parse_unary()
        ops = self._PRECEDENCE[level]
        left = self.parse_binary(level + 1)
        while self.peek().text in ops:
            op = self.next().text
            right = self.parse_binary(level + 1)
            left = Binary(op, left, right)
        return left

    def parse_unary(self) -> Expr:
        t = self.peek()
        if t.text in ("-", "+", "!", "~"):
            self.next()
            return Unary(t.text, self.parse_unary())
        if t.text in ("++", "--"):
            self.next()
            return PrefixIncDec(t.text, self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self) -> Expr:
        e = self.parse_primary()
        while True:
            t = self.peek()
            if t.text == ".":
                self.next()
                e = Member(e, self.next().text)
            elif t.text == "[":
                self.next()
                idx = self.parse_expr()
                self.expect("]")
                e = Index(e, idx)
            elif t.text in ("++", "--"):
                self.next()
                e = PostfixIncDec(t.text, e)
            else:
                return e

    def parse_primary(self) -> Expr:
        t = self.next()
        if t.kind == "float":
            txt = t.text.rstrip("fF")
            if txt.endswith(("lf", "LF")):
                txt = txt[:-2]
            return Num(float(txt), True)
        if t.kind == "int":
            return Num(int(t.text.rstrip("uU")), False)
        if t.kind == "hex":
            return Num(int(t.text.rstrip("uU"), 16), False)
        if t.text == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if t.kind == "id":
            if t.text == "true":
                return BoolLit(True)
            if t.text == "false":
                return BoolLit(False)
            name = t.text
            # `float[3](...)` constructor or `vec3(...)` or plain call
            if self.at("["):
                # array-typed constructor: T[N](args)
                save = self.pos
                self.next()
                if not self.at("]"):
                    try:
                        self.parse_expr()
                    except GlslSyntaxError:
                        self.pos = save
                        return Ident(name)
                if self.at("]") and self.peek(1).text == "(":
                    self.next()  # ]
                    return self._parse_call(name)
                self.pos = save
                return Ident(name)
            if self.at("("):
                return self._parse_call(name)
            return Ident(name)
        raise GlslSyntaxError(f"unexpected token {t.text!r}")

    def _parse_call(self, name: str) -> Call:
        self.expect("(")
        args: list[Expr] = []
        if not self.at(")"):
            if self.at("void") and self.peek(1).text == ")":
                self.next()
            else:
                while True:
                    args.append(self.parse_assignment())
                    if not self.accept(","):
                        break
        self.expect(")")
        return Call(name, args)


def parse(source: str) -> TranslationUnit:
    """Parse preprocessed GLSL source into a TranslationUnit."""
    return _Parser(_lex(source)).parse_unit()


def parse_expression(source: str) -> Expr:
    """Parse a single GLSL expression (testing helper)."""
    return _Parser(_lex(source)).parse_expr()
