"""Preset compilation and the per-pass binding model.

``compile_preset`` turns a parsed ``Preset`` into a ``PresetProgram``:
each pass's GLSL is preprocessed and parsed once, LUT PNGs are loaded,
and the runtime parameter table is merged with the reference's precedence
(custom > preset-file override > pragma default —
ShaderEngine::getShaderParameters, ShaderEngine.cpp:3264).

``PassContext`` implements the RetroArch uniform/sampler protocol the
reference applies in renderMultipassPass/setupUniforms (the ~40 uniform
families catalogued in SURVEY.md §2.1):

* input sampler under Texture/Source/Input/s_p/tex/image — and any
  *unbound* sampler2D also resolves to the input, because GL sampler
  uniforms default to texture unit 0 where the input is bound (this is
  how shaders like xbr-lv2's ``decal`` work);
* pass 0 history: PrevTexture / Prev{1..6}Texture / PassPrev#Texture;
* later passes: PassPrev<N>Texture = output of pass i-N (N>i = original
  input), PrevTexture = pass 0 output, Prev{k}Texture = pass k output;
* aliases (aliasN = Name → sampler Name + vec4 NameSize);
* PassFeedback<N>[Texture] = previous frame's pass-N output;
* OrigTexture = original input; LUTs by preset name;
* size/frame-state uniform families (SourceSize, OutputSize vec2/3/4 by
  declared type, TextureSize=InputSize=input size, OriginalHistorySize#,
  FrameCount with frame_count_mod, MVPMatrix, …).

GL texture-state fidelity: the reference sets filter/wrap only on the
*bound input* texture each pass (ShaderEngine.cpp:1004-1036), so a pass
output later sampled via PassPrev keeps the filter of the pass that
consumed it as input (pass j+1); FBO textures default to LINEAR +
clamp_to_edge (createFramebuffer :2902-2904). We replicate that rule.

Textures are torch tensors on the device the engine names; uniforms that
are compile-time constants stay numpy.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from retrocapture_tpu_torch.frontend import glsl_ast as A
from retrocapture_tpu_torch.frontend.cpp import PragmaParameter, preprocess
from retrocapture_tpu_torch.frontend.glsl_parser import parse
from retrocapture_tpu_torch.frontend.interp import ShaderEval
from retrocapture_tpu_torch.frontend.values import (
    FLOAT,
    GType,
    INT,
    SamplerVal,
    StructVal,
    V,
)
from retrocapture_tpu_torch.graph.scale import PassShapes
from retrocapture_tpu_torch.policy import upload
from retrocapture_tpu_torch.presets.glslp import Preset

__all__ = ["PresetProgram", "CompiledPass", "PassContext", "compile_preset", "TexBinding"]

_INPUT_SAMPLER_NAMES = ("Texture", "Source", "Input", "s_p", "tex", "image")

# Hardcoded legacy fallback defaults (ShaderEngine.cpp:2258-2375) applied
# when a shader samples a tweak uniform that has no pragma and no preset
# override (zfast_crt, Afterglow, resswitch etc.).
LEGACY_PARAM_DEFAULTS: dict[str, float] = {
    "BLURSCALEX": 0.30,
    "LOWLUMSCAN": 6.0,
    "HILUMSCAN": 8.0,
    "BRIGHTBOOST": 1.25,
    "MASK_DARK": 0.25,
    "MASK_FADE": 0.8,
    "RESSWITCH_ENABLE": 1.0,
    "RESSWITCH_GLITCH_TRESHOLD": 0.1,
    "RESSWITCH_GLITCH_BAR_STR": 0.6,
    "RESSWITCH_GLITCH_BAR_SIZE": 0.5,
    "RESSWITCH_GLITCH_BAR_SMOOTH": 1.0,
    "RESSWITCH_GLITCH_SHAKE_MAX": 0.25,
    "RESSWITCH_GLITCH_ROT_MAX": 0.2,
    "RESSWITCH_GLITCH_WOB_MAX": 0.1,
    "AS": 0.20,
    "asat": 0.33,
    "PR": 0.32,
    "PG": 0.32,
    "PB": 0.32,
}

_PASSPREV_TEX_RE = re.compile(r"^PassPrev(\d+)Texture$")
_PREVK_TEX_RE = re.compile(r"^Prev(\d*)Texture$")
_FEEDBACK_RE = re.compile(r"^PassFeedback(\d+)(Texture)?$")
_PASSPREV_SIZE_RE = re.compile(r"^PassPrev(\d+)(TextureSize|InputSize|OutputSize)$")
_PASS_SIZE_RE = re.compile(r"^Pass(Output|Input)Size(\d+)$")
_HISTORY_SIZE_RE = re.compile(r"^OriginalHistorySize(\d+)$")


@dataclass
class LutTexture:
    name: str
    data: np.ndarray  # [H, W, 4] float32
    linear: bool
    wrap_mode: str
    mipmap: bool


@dataclass
class CompiledPass:
    index: int
    vertex_eval: ShaderEval
    fragment_eval: ShaderEval
    parameters: list[PragmaParameter]
    # Names this pass's fragment+vertex reference (for temporal-state
    # detection and binding checks).
    sampler_names: tuple[str, ...]
    texture_calls: int = 0  # static texture() sites (diagnostic only)
    # The vertex stage reads nothing that changes from frame to frame
    # (_vertex_is_static): its varyings depend on the geometry and the
    # parameters only, so what a hand kernel derives from them may be kept.
    vertex_static: bool = False


@dataclass
class PresetProgram:
    preset: Preset
    passes: list[CompiledPass]
    luts: dict[str, LutTexture]
    # name → (pragma meta, effective default after preset override)
    parameters: dict[str, PragmaParameter]
    defaults: dict[str, float]

    def uses_history(self) -> bool:
        for cp in self.passes:
            for n in cp.sampler_names:
                if _PREVK_TEX_RE.match(n):
                    return True
                if cp.index == 0 and _PASSPREV_TEX_RE.match(n):
                    return True
        return False

    def uses_feedback(self) -> bool:
        return any(
            _FEEDBACK_RE.match(n) for cp in self.passes for n in cp.sampler_names
        )


class PresetCompileError(Exception):
    pass


def _load_png_rgba(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGBA")
        arr = np.asarray(im, np.float32) / 255.0
    return arr


def _compat_rewrites(src: str, shader_path: str, cfg) -> str:
    """Per-shader compatibility source rewrites, mirroring the
    reference's injectCompatibilityCode (ShaderPreprocessor.cpp:527-634):

    * box-center.glsl treats gl_FragCoord as normalized in its border
      test (black screen otherwise) — normalize it;
    * interlacing.glsl in a height-scaling pass needs line-replicated
      input coords and output-based interlace parity."""
    base = Path(shader_path).name
    if base == "box-center.glsl":
        pat = "bordertest = gl_FragCoord.xy;"
        src = src.replace(
            pat, pat + "\n   bordertest = bordertest / OutputSize.xy;"
        )
    if base == "interlacing.glsl":
        scales_height = cfg.scale_type_y in ("viewport", "absolute") or (
            cfg.scale_type_y == "source" and cfg.scale_y != 1.0
        )
        if scales_height:
            src = src.replace(
                "TEX0.xy = TexCoord.xy;",
                "TEX0.xy = TexCoord.xy;\n"
                "   TEX0.y = (floor(TEX0.y * OutputSize.y / 2.0) + 0.5) / InputSize.y;",
            )
            src = re.sub(
                r"\by\s*=\s*2\.0+[0-9]*\s*\*\s*TextureSize\.y\s*\*\s*vTexCoord\.y",
                "y = 2.000001 * TextureSize.y * (gl_FragCoord.y / OutputSize.y)",
                src,
            )
            src = re.sub(
                r"\by\s*=\s*TextureSize\.y\s*\*\s*vTexCoord\.y",
                "y = TextureSize.y * (gl_FragCoord.y / OutputSize.y)",
                src,
            )
    return src


_FRAME_UNIFORMS = frozenset({"FrameCount", "FRAMEINDEX", "TIME", "Time"})


def _idents(node, out: set) -> None:
    """Every identifier referenced under an AST node."""
    if isinstance(node, A.Ident):
        out.add(node.name)
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            _idents(getattr(node, f.name), out)
    elif isinstance(node, (list, tuple)):
        for x in node:
            _idents(x, out)


def _vertex_is_static(tu: A.TranslationUnit) -> bool:
    """True when the vertex stage references no frame-state uniform
    (FrameCount, Time, a history frame's size, a struct uniform, which
    carries frame_count) and no sampler (texel values change with the
    frame). A declaration alone does
    not count: the corpus's vertex stages declare FrameCount and never read
    it."""
    used: set = set()
    for d in tu.decls:
        if isinstance(d, A.FunctionDef):
            _idents(d.body, used)
        elif isinstance(d, A.GlobalDecl):
            _idents([x.init for x in d.declarators], used)
    structs = tu.structs()
    for g in tu.globals():
        for d in g.declarators:
            if d.name not in used:
                continue
            if g.type.name.startswith("sampler"):
                return False
            if g.type.is_uniform and (
                d.name in _FRAME_UNIFORMS or g.type.name in structs or _HISTORY_SIZE_RE.match(d.name)
            ):
                return False
    return True


def compile_preset(preset: Preset) -> PresetProgram:
    passes: list[CompiledPass] = []
    all_params: dict[str, PragmaParameter] = {}
    for i, cfg in enumerate(preset.passes):
        path = Path(cfg.shader_path)
        if not path.is_file():
            raise PresetCompileError(f"pass {i}: shader not found: {cfg.shader_path}")
        src = path.read_text(encoding="utf-8", errors="replace")
        src = _compat_rewrites(src, str(path), cfg)
        vsrc, vparams = preprocess(src, "vertex", filename=str(path))
        fsrc, fparams = preprocess(src, "fragment", filename=str(path))
        vtu = parse(vsrc)
        ftu = parse(fsrc)
        samplers = []
        for tu in (vtu, ftu):
            for g in tu.globals():
                if g.type.name.startswith("sampler"):
                    samplers.extend(d.name for d in g.declarators)
        n_tex = len(
            re.findall(r"\b(?:texture2D|texture|texelFetch|textureLod)\s*\(", fsrc)
        )
        cp = CompiledPass(
            index=i,
            vertex_eval=ShaderEval(vtu, "vertex"),
            fragment_eval=ShaderEval(ftu, "fragment"),
            parameters=fparams,
            sampler_names=tuple(samplers),
            texture_calls=n_tex,
            vertex_static=_vertex_is_static(vtu),
        )
        passes.append(cp)
        for p in fparams:
            all_params.setdefault(p.name, p)

    luts: dict[str, LutTexture] = {}
    for name, tc in preset.textures.items():
        if not tc.path or not Path(tc.path).is_file():
            continue
        luts[name] = LutTexture(
            name=name,
            data=_load_png_rgba(tc.path),
            linear=tc.linear,
            wrap_mode=tc.wrap_mode,
            mipmap=tc.mipmap,
        )

    # Effective defaults: pragma default overridden by preset-file value
    # (custom user values layer on top at apply() time).
    defaults = {name: p.initial for name, p in all_params.items()}
    for k, v in preset.parameters.items():
        defaults[k] = v
    return PresetProgram(
        preset=preset, passes=passes, luts=luts, parameters=all_params, defaults=defaults
    )


# ---------------------------------------------------------------------------


@dataclass
class TexBinding:
    tex: Any  # [H, W, 4] array
    filter_linear: bool
    wrap_mode: str
    mipmap: bool = False
    # Texels provably on the k/255 grid (RGBA8 pass outputs, history
    # entries, u8 chain input, PNG LUTs) — see SamplerVal.quantized.
    quantized: bool = False

    def sampler(self, name: str) -> SamplerVal:
        return SamplerVal(
            name, self.tex, self.filter_linear, self.wrap_mode, self.mipmap,
            self.quantized,
        )


def _vec(vals, base="float") -> V:
    dt = np.int32 if base == "int" else np.float32
    return V(np.asarray(vals, dt), GType(base, (len(vals),)))


def _as_f32(x):
    """float(FrameCount): a device scalar stays on the device."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return x.astype(np.float32) if hasattr(x, "astype") else np.float32(x)


def _size_vec4(w: float, h: float) -> np.ndarray:
    return np.array(
        [w, h, 1.0 / w if w else 0.0, 1.0 / h if h else 0.0], np.float32
    )


class PassContext:
    """Uniform/sampler resolution context for one pass execution."""

    def __init__(
        self,
        program: PresetProgram,
        pass_index: int,
        *,
        shapes: list[PassShapes],
        viewport: tuple[int, int],
        source_size: tuple[int, int],
        input_binding: TexBinding,
        original_binding: TexBinding,
        pass_outputs: list[Optional[TexBinding]],
        history: list[TexBinding],
        feedback: dict[int, TexBinding],
        frame_count,
        frame_time,
        params: dict[str, Any],
        device,
    ):
        self.program = program
        self.i = pass_index
        self.shapes = shapes
        self.viewport = viewport
        self.source_size = source_size
        self.input_binding = input_binding
        self.original_binding = original_binding
        self.pass_outputs = pass_outputs
        self.history = history
        self.feedback = feedback
        self.frame_count = frame_count
        self.frame_time = frame_time
        self.params = params
        # Every tensor the pass creates lives here (the evaluator reads
        # it as ctx.device).
        self.device = device
        sh = shapes[pass_index]
        self.in_size = (sh.in_w, sh.in_h)
        self.out_size = (sh.out_w, sh.out_h)
        self._alias_to_pass = {
            cfg.alias: j
            for j, cfg in enumerate(program.preset.passes)
            if cfg.alias
        }

    # -- samplers -------------------------------------------------------
    def resolve_sampler(self, name: str) -> Optional[SamplerVal]:
        b = self._resolve_binding(name)
        return b.sampler(name) if b is not None else None

    def _output_binding(self, j: int) -> Optional[TexBinding]:
        if 0 <= j < len(self.pass_outputs):
            return self.pass_outputs[j]
        return None

    def _resolve_binding(self, name: str) -> Optional[TexBinding]:
        prog, i = self.program, self.i
        if name in prog.luts:
            lut = prog.luts[name]
            data = upload(lut.data, self.device)
            return TexBinding(
                data, lut.linear, lut.wrap_mode, lut.mipmap,
                quantized=True,  # PNG bytes / 255 (see _load_lut)
            )
        if name in self._alias_to_pass:
            j = self._alias_to_pass[name]
            if j < i:
                b = self._output_binding(j)
                if b is not None:
                    return b
        if name in _INPUT_SAMPLER_NAMES:
            return self.input_binding
        if name == "OrigTexture":
            return self.original_binding
        m = _FEEDBACK_RE.match(name)
        if m:
            j = int(m.group(1))
            fb = self.feedback.get(j)
            return fb if fb is not None else self._output_binding(j) or self.input_binding
        if i == 0:
            m = _PREVK_TEX_RE.match(name)
            if m:
                k = int(m.group(1)) if m.group(1) else 0
                return self._history_or_input(k)
            m = _PASSPREV_TEX_RE.match(name)
            if m:
                # At pass 0 the reference pairs PassPrevNTexture with
                # PrevNTexture — both bind history[N]
                # (ShaderEngine.cpp:1100-1125).
                return self._history_or_input(int(m.group(1)))
        else:
            m = _PASSPREV_TEX_RE.match(name)
            if m:
                n = int(m.group(1))
                if n <= i:
                    b = self._output_binding(i - n)
                    if b is not None:
                        return b
                return self.original_binding  # kawase_glow pattern
            m = _PREVK_TEX_RE.match(name)
            if m:
                k = int(m.group(1)) if m.group(1) else 0
                b = self._output_binding(k)
                if b is not None:
                    return b
        # Unbound sampler → texture unit 0 → the pass input.
        return self.input_binding

    def _history_or_input(self, k: int) -> TexBinding:
        if 0 <= k < len(self.history):
            return self.history[k]
        return self.input_binding

    # -- uniforms -------------------------------------------------------
    def resolve_uniform(self, name: str, gtype: GType) -> Optional[V]:
        iw, ih = self.in_size
        ow, oh = self.out_size
        sw, sh = self.source_size

        def sized(w, h):
            full = _size_vec4(w, h)
            if gtype.is_scalar:
                return V(np.float32(full[0]), FLOAT)
            n = gtype.shape[0] if gtype.is_vector else 4
            return _vec(full[:n])

        if name in ("SourceSize",):
            return sized(iw, ih)
        if name in ("OriginalSize", "TexSize0"):
            return sized(sw, sh)
        if name in ("OutputSize", "OutSize", "outsize"):
            return sized(ow, oh)
        if name == "TextureSize":
            return sized(iw, ih)
        if name == "InputSize":
            return sized(iw, ih)
        m = _PASSPREV_SIZE_RE.match(name)
        if m and self.i > 0:
            n = int(m.group(1))
            kind = m.group(2)
            j = self.i - n
            if 0 <= j < len(self.shapes):
                t = self.shapes[j]
                if kind == "InputSize":
                    return sized(t.in_w, t.in_h)
                return sized(t.out_w, t.out_h)
            return sized(sw, sh)
        m = _PASS_SIZE_RE.match(name)
        if m:
            j = int(m.group(2))
            if 0 <= j < len(self.shapes):
                t = self.shapes[j]
                if m.group(1) == "Output":
                    return sized(t.out_w, t.out_h)
                return sized(t.in_w, t.in_h)
        m = _HISTORY_SIZE_RE.match(name)
        if m:
            k = int(m.group(1))
            if k == 0 or not (0 < k <= len(self.history)):
                return sized(sw, sh)
            b = self.history[k - 1]
            return sized(b.tex.shape[1], b.tex.shape[0])
        if name in self._alias_to_pass and gtype.is_vector:
            # vec4 <Alias>Size
            j = self._alias_to_pass[name]
            t = self.shapes[j]
            return sized(t.out_w, t.out_h)
        if name.endswith("Size") and name[:-4] in self._alias_to_pass:
            j = self._alias_to_pass[name[:-4]]
            t = self.shapes[j]
            return sized(t.out_w, t.out_h)
        # Alias-prefixed cg-style size uniforms (crt-royale declares e.g.
        # `uniform vec2 HALATION_BLURtexture_size;` — RetroArch sets these;
        # the reference leaves them 0, black-screening royale chains).
        for suffix, kind in (
            ("texture_size", "out"),
            ("output_size", "out"),
            ("video_size", "in"),
        ):
            if name.endswith(suffix) and name[: -len(suffix)] in self._alias_to_pass:
                j = self._alias_to_pass[name[: -len(suffix)]]
                t = self.shapes[j]
                if kind == "out":
                    return sized(t.out_w, t.out_h)
                return sized(t.in_w, t.in_h)
        if name.endswith("Size") and name[:-4] in self.program.luts:
            lut = self.program.luts[name[:-4]]
            return sized(lut.data.shape[1], lut.data.shape[0])
        if name in ("FrameCount", "FRAMEINDEX"):
            fc = self.frame_count
            mod = self.program.preset.passes[self.i].frame_count_mod
            if mod and mod > 0:
                fc = fc % mod
            if gtype.base == "float":
                return V(_as_f32(fc), FLOAT)
            return V(fc, INT)
        if name == "FrameDirection":
            return V(np.int32(1) if gtype.base != "float" else np.float32(1.0), GType(gtype.base, ()))
        if name in ("TIME", "Time"):
            return V(self.frame_time, FLOAT)
        if name == "MVPMatrix":
            return V(np.eye(4, dtype=np.float32), GType("float", (4, 4)))
        if name == "internal_res":
            return V(np.float32(1.0), FLOAT)
        if name == "auto_res":
            return V(np.float32(0.0), FLOAT)
        if name in self.params:
            return V(self.params[name], FLOAT)
        if name in LEGACY_PARAM_DEFAULTS:
            return V(np.float32(LEGACY_PARAM_DEFAULTS[name]), FLOAT)
        return None

    def resolve_struct_uniform(self, name: str, fields: list) -> Optional[StructVal]:
        iw, ih = self.in_size
        ow, oh = self.out_size
        sw, sh = self.source_size
        out: dict[str, Any] = {}
        for ftype, fname, _ in fields:
            if fname == "video_size":
                out[fname] = _vec([sw, sh])
            elif fname == "texture_size":
                out[fname] = _vec([iw, ih])
            elif fname == "output_size":
                out[fname] = _vec([ow, oh])
            elif fname == "frame_count":
                fc = self.frame_count
                out[fname] = V(fc, INT) if ftype.name == "int" else V(_as_f32(fc), FLOAT)
            elif fname == "frame_direction":
                out[fname] = V(np.float32(1.0), FLOAT)
            else:
                out[fname] = V(np.float32(0.0), FLOAT)
        return StructVal(name, out)
