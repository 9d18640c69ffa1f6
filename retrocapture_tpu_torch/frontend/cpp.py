"""C-preprocessor front-end for RetroArch single-source GLSL shaders.

The reference compiles the same ``.glsl`` file twice, prepending
``#define VERTEX`` or ``#define FRAGMENT`` (plus ``PARAMETER_UNIFORM`` only
when ``#pragma parameter`` lines exist — ShaderPreprocessor.cpp:207-217),
and resolves ``#include`` recursively with comment awareness
(ShaderPreprocessor.cpp:222-363). This module is a clean-room
implementation of the subset of cpp those shaders use:

* ``#include "file"`` (recursive, relative to the including file)
* object-like and function-like ``#define`` / ``#undef`` with rescanning
* ``#if / #ifdef / #ifndef / #elif / #else / #endif`` with ``defined()``,
  integer arithmetic, comparisons and boolean operators
* ``#version`` (recorded, stripped; sets ``__VERSION__``)
* ``#pragma parameter NAME "DESC" INITIAL MIN MAX [STEP]`` extraction
  (regex semantics of ShaderPreprocessor.cpp:36, signed numbers) with the
  pragma line blanked from the output
* other ``#pragma`` / ``#extension`` / ``precision`` lines are dropped

We emulate a desktop GL 3.3 context: ``__VERSION__ = 330`` and ``GL_ES``
undefined, so ``COMPAT_TEXTURE`` resolves to ``texture`` and precision
qualifiers are no-ops (all math is float32 on TPU).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

__all__ = ["Preprocessor", "PragmaParameter", "preprocess", "PreprocessError"]


class PreprocessError(ValueError):
    pass


_NUM = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"
# ShaderPreprocessor.cpp:36 — name "desc" default min max [step]
_PRAGMA_PARAM_RE = re.compile(
    r'#pragma\s+parameter\s+(\w+)\s+"([^"]*)"\s+(' + _NUM + r")\s+(" + _NUM + r")"
    r"(?:\s+(" + _NUM + r"))?(?:\s+(" + _NUM + r"))?"
)

_IDENT_RE = re.compile(r"[A-Za-z_]\w*")
_DEFINED_RE = re.compile(r"defined\s*(?:\(\s*(\w+)\s*\)|(\w+))")

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>0[xX][0-9a-fA-F]+[uU]*|(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?[fFuUlL]*)
  | (?P<id>[A-Za-z_]\w*)
  | (?P<punct>\#\#|<<=|>>=|\+\+|--|\+=|-=|\*=|/=|%=|&=|\|=|\^=|<<|>>|<=|>=|==|!=
        |&&|\|\||\^\^|[-+*/%<>=!&|^~?:;,.(){}\[\]\#])
  | (?P<other>.)
    """,
    re.VERBOSE,
)


@dataclass(frozen=True)
class PragmaParameter:
    """A ``#pragma parameter`` runtime parameter declaration."""

    name: str
    description: str
    initial: float
    minimum: float
    maximum: float
    step: float = 0.0


@dataclass
class _Macro:
    name: str
    params: Optional[list[str]]  # None => object-like
    body: str
    variadic: bool = False


def _tokenize(text: str) -> list[str]:
    out = []
    for m in _TOKEN_RE.finditer(text):
        if m.lastgroup == "ws":
            if out and out[-1] != " ":
                out.append(" ")
        else:
            out.append(m.group(0))
    return out


def strip_comments(text: str) -> str:
    """Remove // and /* */ comments, preserving newlines inside block
    comments so line numbers stay stable (comment-safe like
    ShaderPreprocessor.cpp:222-363)."""
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            j = text.find("\n", i)
            i = n if j < 0 else j
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            seg = text[i : (n if j < 0 else j + 2)]
            out.append("\n" * seg.count("\n"))
            i = n if j < 0 else j + 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


class Preprocessor:
    """One preprocessing run over a shader source tree."""

    def __init__(
        self,
        defines: Optional[dict[str, str]] = None,
        include_resolver: Optional[Callable[[str, Optional[str]], tuple[str, str]]] = None,
        max_include_depth: int = 16,
    ):
        self.macros: dict[str, _Macro] = {}
        self.parameters: list[PragmaParameter] = []
        self.version: Optional[str] = None
        self._include_resolver = include_resolver or _default_include_resolver
        self._max_depth = max_include_depth
        for k, v in (defines or {}).items():
            self.macros[k] = _Macro(k, None, str(v))

    # -- public ---------------------------------------------------------
    def run(self, text: str, filename: Optional[str] = None) -> str:
        expanded = self._read_and_expand_includes(text, filename, 0)
        self._extract_pragma_parameters(expanded)
        # PARAMETER_UNIFORM is defined iff pragma parameters exist
        # (ShaderPreprocessor.cpp:207-217; crt-royale's #else branch
        # depends on its absence when no pragmas are present).
        if self.parameters and "PARAMETER_UNIFORM" not in self.macros:
            self.macros["PARAMETER_UNIFORM"] = _Macro("PARAMETER_UNIFORM", None, "1")
        expanded = _PRAGMA_PARAM_RE.sub("", expanded)
        expanded = strip_comments(expanded)
        lines = expanded.split("\n")
        out = self._process(lines)
        return "\n".join(out)

    # -- includes -------------------------------------------------------
    def _read_and_expand_includes(
        self, text: str, filename: Optional[str], depth: int
    ) -> str:
        if depth > self._max_depth:
            raise PreprocessError(f"#include depth exceeded at {filename}")
        # Splice line continuations first.
        text = text.replace("\\\r\n", "").replace("\\\n", "")
        stripped = strip_comments(text)
        out_lines: list[str] = []
        for raw, clean in zip(text.split("\n"), stripped.split("\n")):
            m = re.match(r'\s*#\s*include\s+[<"]([^">]+)[">]', clean)
            if m:
                inc_text, inc_name = self._include_resolver(m.group(1), filename)
                out_lines.append(
                    self._read_and_expand_includes(inc_text, inc_name, depth + 1)
                )
            else:
                out_lines.append(raw)
        return "\n".join(out_lines)

    def _extract_pragma_parameters(self, text: str) -> None:
        seen = {p.name for p in self.parameters}
        for m in _PRAGMA_PARAM_RE.finditer(text):
            name, desc, init, mn = m.group(1), m.group(2), m.group(3), m.group(4)
            mx = m.group(5) if m.group(5) is not None else init
            step = m.group(6) if m.group(6) is not None else "0"
            if name not in seen:
                seen.add(name)
                self.parameters.append(
                    PragmaParameter(
                        name, desc, float(init), float(mn), float(mx), float(step)
                    )
                )

    # -- conditional / directive processing -----------------------------
    def _process(self, lines: list[str]) -> list[str]:
        out: list[str] = []
        # Stack of (parent_active, this_branch_taken_yet, currently_active)
        stack: list[list[bool]] = []

        def active() -> bool:
            return all(frame[2] for frame in stack)

        pending: list[str] = []  # active ordinary lines awaiting expansion

        def flush() -> None:
            # Expand a contiguous run of ordinary lines as ONE token
            # stream so function-like macro calls spanning lines (e.g.
            # adaptive-sharpen's max4 over two lines) expand correctly.
            if pending:
                out.extend(self._expand_region(pending))
                pending.clear()

        for line in lines:
            m = re.match(r"\s*#\s*(\w+)\b(.*)", line)
            if not m:
                if active():
                    pending.append(line)
                else:
                    flush()
                    out.append("")
                continue
            flush()
            directive, rest = m.group(1), m.group(2).strip()
            if directive in ("if", "ifdef", "ifndef"):
                parent = active()
                if directive == "ifdef":
                    cond = parent and rest.split()[0] in self.macros if rest else False
                elif directive == "ifndef":
                    cond = parent and (not rest or rest.split()[0] not in self.macros)
                else:
                    cond = parent and bool(self._eval_condition(rest))
                stack.append([parent, cond, cond])
                out.append("")
            elif directive == "elif":
                if not stack:
                    raise PreprocessError("#elif without #if")
                frame = stack[-1]
                if frame[0] and not frame[1]:
                    cond = bool(self._eval_condition(rest))
                    frame[1] = frame[2] = cond
                else:
                    frame[2] = False
                out.append("")
            elif directive == "else":
                if not stack:
                    raise PreprocessError("#else without #if")
                frame = stack[-1]
                frame[2] = frame[0] and not frame[1]
                frame[1] = True
                out.append("")
            elif directive == "endif":
                if not stack:
                    raise PreprocessError("#endif without #if")
                stack.pop()
                out.append("")
            elif not active():
                out.append("")
            elif directive == "define":
                self._handle_define(rest)
                out.append("")
            elif directive == "undef":
                self.macros.pop(rest.split()[0], None) if rest else None
                out.append("")
            elif directive == "version":
                self.version = rest
                ver = rest.split()[0] if rest else "330"
                self.macros["__VERSION__"] = _Macro("__VERSION__", None, ver)
                if "es" in rest.lower().split():
                    self.macros["GL_ES"] = _Macro("GL_ES", None, "1")
                out.append("")
            elif directive in ("pragma", "extension", "line", "error"):
                out.append("")
            elif directive == "include":
                # already expanded in _read_and_expand_includes
                out.append("")
            else:
                out.append("")
        flush()
        return out

    def _expand_region(self, lines: list[str]) -> list[str]:
        """Expand a run of ordinary lines as one token stream, with "\\n"
        tokens marking line boundaries."""
        tokens: list[str] = []
        for ln in lines:
            tokens.extend(_tokenize(ln))
            tokens.append("\n")
        if not any(t in self.macros for t in tokens):
            return lines
        expanded = self._expand_tokens(tokens, frozenset())
        text = _detokenize(expanded)
        out = text.split("\n")
        # The trailing "\n" token yields one empty tail entry.
        if out and out[-1] == "":
            out.pop()
        # Newlines may be consumed inside macro arg lists; keep the line
        # count stable for downstream error messages.
        while len(out) < len(lines):
            out.append("")
        return out

    def _handle_define(self, rest: str) -> None:
        m = re.match(r"(\w+)(\(([^)]*)\))?\s?(.*)", rest, re.DOTALL)
        if not m:
            return
        name = m.group(1)
        if m.group(2) is not None and rest[len(name) : len(name) + 1] == "(":
            raw_params = [p.strip() for p in m.group(3).split(",")] if m.group(3).strip() else []
            variadic = bool(raw_params) and raw_params[-1] == "..."
            if variadic:
                raw_params = raw_params[:-1]
            self.macros[name] = _Macro(name, raw_params, m.group(4).strip(), variadic)
        else:
            body = rest[len(name) :].strip()
            self.macros[name] = _Macro(name, None, body)

    # -- expression evaluation for #if ----------------------------------
    def _eval_condition(self, expr: str) -> int:
        # Resolve defined() before macro expansion.
        def _repl_defined(m: re.Match) -> str:
            name = m.group(1) or m.group(2)
            return "1" if name in self.macros else "0"

        expr = _DEFINED_RE.sub(_repl_defined, expr)
        expr = self._expand_line(expr)
        expr = _DEFINED_RE.sub(_repl_defined, expr)  # macros may expand to defined()
        # Remaining identifiers evaluate to 0 (C semantics).
        expr = _IDENT_RE.sub("0", expr)
        expr = expr.replace("&&", " and ").replace("||", " or ")
        expr = re.sub(r"!(?!=)", " not ", expr)
        expr = re.sub(r"(\d)[fFuUlL]+\b", r"\1", expr)
        if not expr.strip():
            return 0
        try:
            return int(bool(eval(expr, {"__builtins__": {}}, {})))  # noqa: S307
        except Exception:
            return 0

    # -- macro expansion -------------------------------------------------
    def _expand_line(self, line: str) -> str:
        if "#" in line and re.match(r"\s*#", line):
            return ""
        tokens = _tokenize(line)
        if not any(t in self.macros for t in tokens if t and t[0].isalpha() or t.startswith("_")):
            # cheap path: no identifiers matching macros
            if not any((t in self.macros) for t in tokens):
                return line
        expanded = self._expand_tokens(tokens, frozenset())
        return _detokenize(expanded)

    def _expand_tokens(self, tokens: list[str], hide: frozenset) -> list[str]:
        out: list[str] = []
        i = 0
        n = len(tokens)
        while i < n:
            tok = tokens[i]
            macro = self.macros.get(tok)
            if macro is None or tok in hide:
                out.append(tok)
                i += 1
                continue
            if macro.params is None:
                body_toks = _tokenize(macro.body)
                out.extend(self._expand_tokens(body_toks, hide | {tok}))
                i += 1
                continue
            # function-like: need '(' as next non-space token
            j = i + 1
            while j < n and tokens[j] in (" ", "\n"):
                j += 1
            if j >= n or tokens[j] != "(":
                out.append(tok)
                i += 1
                continue
            args, end = _collect_args(tokens, j)
            if end is None:
                out.append(tok)
                i += 1
                continue
            # Expand arguments first (call-by-value expansion).
            exp_args = [self._expand_tokens(a, hide) for a in args]
            body_toks = _tokenize(macro.body)
            subst: list[str] = []
            for bt in body_toks:
                if bt in macro.params:
                    k = macro.params.index(bt)
                    if k < len(exp_args):
                        subst.extend(exp_args[k])
                elif bt == "__VA_ARGS__" and macro.variadic:
                    extra = exp_args[len(macro.params) :]
                    for ei, ea in enumerate(extra):
                        if ei:
                            subst.append(",")
                        subst.extend(ea)
                else:
                    subst.append(bt)
            # Handle ## token pasting.
            subst = _paste(subst)
            out.extend(self._expand_tokens(subst, hide | {tok}))
            i = end + 1
        return out


def _collect_args(tokens: list[str], open_idx: int):
    """Collect macro call arguments starting at tokens[open_idx] == '('.
    Returns (args, index_of_closing_paren) or (None, None)."""
    depth = 0
    args: list[list[str]] = [[]]
    i = open_idx
    n = len(tokens)
    while i < n:
        t = tokens[i]
        if t == "(":
            depth += 1
            if depth > 1:
                args[-1].append(t)
        elif t == ")":
            depth -= 1
            if depth == 0:
                if len(args) == 1 and not any(x.strip() for x in args[0]):
                    args = []
                return args, i
            args[-1].append(t)
        elif t == "," and depth == 1:
            args.append([])
        elif t == "\n":
            args[-1].append(" ")
        else:
            args[-1].append(t)
        i += 1
    return None, None


def _paste(tokens: list[str]) -> list[str]:
    if "##" not in tokens:
        return tokens
    out: list[str] = []
    i = 0
    while i < len(tokens):
        if tokens[i] == "##":
            while out and out[-1] == " ":
                out.pop()
            j = i + 1
            while j < len(tokens) and tokens[j] == " ":
                j += 1
            if out and j < len(tokens):
                out[-1] = out[-1] + tokens[j]
                i = j + 1
                continue
            i += 1
        else:
            out.append(tokens[i])
            i += 1
    return out


def _detokenize(tokens: list[str]) -> str:
    # Insert spaces between identifier/number tokens that would merge.
    out: list[str] = []
    prev = ""
    for t in tokens:
        if t in (" ", "\n"):
            out.append(t)
            prev = " "
            continue
        if prev and prev != " " and _needs_space(prev, t):
            out.append(" ")
        out.append(t)
        prev = t
    return "".join(out)


def _word_like(t: str) -> bool:
    return bool(t) and (t[0].isalnum() or t[0] == "_")


def _needs_space(a: str, b: str) -> bool:
    if _word_like(a) and _word_like(b):
        return True
    # avoid creating '--', '++', '+=' etc. accidentally
    if a[-1] in "+-" and b and b[0] in "+-=":
        return True
    return False


def _default_include_resolver(name: str, from_file: Optional[str]) -> tuple[str, str]:
    base = Path(from_file).parent if from_file else Path(".")
    p = (base / name).resolve()
    if not p.is_file():
        raise PreprocessError(f"#include not found: {name} (from {from_file})")
    return p.read_text(encoding="utf-8", errors="replace"), str(p)


def preprocess(
    source: str,
    stage: str,
    filename: Optional[str] = None,
    extra_defines: Optional[dict[str, str]] = None,
) -> tuple[str, list[PragmaParameter]]:
    """Preprocess a RetroArch single-source GLSL shader for one stage.

    ``stage`` is ``"vertex"`` or ``"fragment"``; mirrors the reference's
    stage-define injection (ShaderPreprocessor.cpp:207-217) under an
    emulated desktop GL 3.3 profile.
    """
    assert stage in ("vertex", "fragment")
    defines = {
        "VERTEX" if stage == "vertex" else "FRAGMENT": "1",
        "__VERSION__": "330",
    }
    if extra_defines:
        defines.update(extra_defines)
    pp = Preprocessor(defines=defines)
    out = pp.run(source, filename=filename)
    return out, pp.parameters
