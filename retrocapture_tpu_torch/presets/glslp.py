"""RetroArch ``.glslp`` preset parser.

Parses the preset grammar the reference implements in
src/shader/ShaderPreset.cpp (load :18, parseLine :115): a line-oriented
``key = value`` format with ``#`` comment lines, optional quoting on both
sides, a ``shaders = N`` pass count, per-pass keys suffixed with the pass
index, a ``textures = "A;B;..."`` declaration followed by per-texture
attribute keys, and any other bare ``key = value`` acting as a global
parameter override.

Deviations from the reference (all strictly more correct; documented for
the parity check):

* ``frame_count_modN`` is honored. In the reference the handler at
  ShaderPreset.cpp:300-316 is unreachable — any key containing a digit
  takes the per-pass branch at :186, where no sub-branch matches
  ``frame_count_mod``, so the key is silently dropped and every pass keeps
  ``frameCountMod = 0``. We implement the documented RetroArch semantics
  (FrameCount is taken modulo N for that pass) because shipped presets
  (e.g. ntsc/ntsc-320px.glslp) rely on it.
* Global parameters whose names contain digits (e.g. ``param2``) are
  parsed as parameters; the reference's first-digit heuristic
  (ShaderPreset.cpp:187) would misroute them into the per-pass branch and
  drop them. We only treat ``<known-prefix><index>`` keys as per-pass.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["Preset", "PassConfig", "TextureConfig", "PresetError"]


class PresetError(ValueError):
    """Raised when a preset file cannot be parsed or resolved."""


_WRAP_MODES = ("clamp_to_edge", "clamp_to_border", "repeat", "mirrored_repeat")

# Ordered so longer prefixes are tried before their own prefixes
# (scale_type_x before scale_type before scale; mirrors the if-chain order
# in ShaderPreset.cpp:199-283).
_PASS_KEY_RE = re.compile(
    r"^(shader|filter_linear|wrap_mode|mipmap_input|alias|float_framebuffer"
    r"|srgb_framebuffer|frame_count_mod|scale_type_x|scale_type_y|scale_type"
    r"|scale_x|scale_y|scale)(\d+)$"
)


def _parse_bool(value: str) -> bool:
    return value.strip().lower() in ("true", "1")


def _parse_float(value: str) -> float:
    """Tolerant float parse: accepts leading numeric prefix like std::stof."""
    m = re.match(r"\s*[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?", value)
    if not m:
        return 0.0
    return float(m.group(0))


@dataclass
class PassConfig:
    """One shader pass, mirroring ShaderPass (ShaderPreset.h:7-29)."""

    shader_path: str = ""
    filter_linear: bool = False
    wrap_mode: str = "clamp_to_edge"
    mipmap_input: bool = False
    alias: str = ""
    float_framebuffer: bool = False
    srgb_framebuffer: bool = False
    frame_count_mod: int = 0  # 0 = no modulo
    scale_type_x: str = ""  # "", "source", "viewport", "absolute"
    scale_type_y: str = ""
    scale_x: float = 1.0
    scale_y: float = 1.0


@dataclass
class TextureConfig:
    """One preset LUT texture (ShaderPreset.h texture entry)."""

    path: str = ""
    linear: bool = True  # GL default for preset LUTs in the reference loader
    wrap_mode: str = "clamp_to_edge"
    mipmap: bool = False


@dataclass
class Preset:
    """Parsed .glslp preset: passes, LUT textures, global parameter overrides."""

    path: str = ""
    passes: list[PassConfig] = field(default_factory=list)
    textures: dict[str, TextureConfig] = field(default_factory=dict)
    parameters: dict[str, float] = field(default_factory=dict)

    # ------------------------------------------------------------------
    @classmethod
    def load(cls, preset_path: str | os.PathLike) -> "Preset":
        p = Path(preset_path).resolve()
        if not p.is_file():
            raise PresetError(f"preset not found: {preset_path}")
        text = p.read_text(encoding="utf-8", errors="replace")
        return cls.loads(text, path=str(p))

    @classmethod
    def loads(cls, text: str, path: str = "") -> "Preset":
        self = cls(path=path)
        base = Path(path).parent if path else Path(".")
        declared_order: list[str] = []

        for raw in text.splitlines():
            line = raw.strip()
            if not line or line.startswith("#") or line.startswith("//"):
                continue
            eq = line.find("=")
            if eq < 0:
                continue
            key = line[:eq].strip().strip('"')
            value = line[eq + 1 :].strip().strip('"').strip()
            if not key:
                continue

            if key == "shaders":
                n = int(_parse_float(value))
                while len(self.passes) < n:
                    self.passes.append(PassConfig())
                continue

            if key == "textures":
                for name in value.split(";"):
                    name = name.strip().strip('"')
                    if name and name not in self.textures:
                        self.textures[name] = TextureConfig()
                        declared_order.append(name)
                continue

            # Texture attributes / path for an already-declared texture.
            if self._maybe_texture_key(key, value, base):
                continue

            m = _PASS_KEY_RE.match(key)
            if m:
                self._set_pass_key(m.group(1), int(m.group(2)), value, base)
                continue

            # Undeclared texture path via Sampler* convention
            # (ShaderPreset.cpp:246-255).
            if key.startswith("Sampler") and not key.endswith(
                ("_wrap_mode", "_mipmap", "_linear")
            ):
                tex = self.textures.setdefault(key, TextureConfig())
                tex.path = _resolve_asset(value, base)
                continue

            # Anything else: global parameter override (ShaderPreset.cpp:328).
            self.parameters[key] = _parse_float(value)

        return self

    # ------------------------------------------------------------------
    def _maybe_texture_key(self, key: str, value: str, base: Path) -> bool:
        for suffix, attr in (
            ("_linear", "linear"),
            ("_wrap_mode", "wrap_mode"),
            ("_mipmap", "mipmap"),
        ):
            if key.endswith(suffix):
                name = key[: -len(suffix)]
                if name in self.textures:
                    tex = self.textures[name]
                    if attr == "wrap_mode":
                        tex.wrap_mode = value if value in _WRAP_MODES else tex.wrap_mode
                    else:
                        setattr(tex, attr, _parse_bool(value))
                    return True
        if key in self.textures:
            self.textures[key].path = _resolve_asset(value, base)
            return True
        return False

    def _set_pass_key(self, prefix: str, idx: int, value: str, base: Path) -> None:
        while len(self.passes) <= idx:
            self.passes.append(PassConfig())
        ps = self.passes[idx]
        if prefix == "shader":
            ps.shader_path = _resolve_asset(value, base)
        elif prefix == "filter_linear":
            ps.filter_linear = _parse_bool(value)
        elif prefix == "wrap_mode":
            ps.wrap_mode = value if value in _WRAP_MODES else ps.wrap_mode
        elif prefix == "mipmap_input":
            ps.mipmap_input = _parse_bool(value)
        elif prefix == "alias":
            ps.alias = value
        elif prefix == "float_framebuffer":
            ps.float_framebuffer = _parse_bool(value)
        elif prefix == "srgb_framebuffer":
            ps.srgb_framebuffer = _parse_bool(value)
        elif prefix == "frame_count_mod":
            ps.frame_count_mod = int(_parse_float(value))
        elif prefix == "scale_type_x":
            ps.scale_type_x = value
        elif prefix == "scale_type_y":
            ps.scale_type_y = value
        elif prefix == "scale_type":
            ps.scale_type_x = ps.scale_type_y = value
        elif prefix == "scale_x":
            ps.scale_x = _parse_float(value)
        elif prefix == "scale_y":
            ps.scale_y = _parse_float(value)
        elif prefix == "scale":
            ps.scale_x = ps.scale_y = _parse_float(value)

    # ------------------------------------------------------------------
    def save_as(self, out_path: str | os.PathLike, parameters: dict[str, float]) -> None:
        """Rewrite parameter lines of the original preset file with new
        values, preserving all other formatting (mirrors
        ShaderPreset::saveAs, ShaderPreset.cpp:557-661). Parameters not
        present in the original file are appended at the end."""
        src = Path(self.path)
        lines = (
            src.read_text(encoding="utf-8", errors="replace").splitlines(keepends=False)
            if src.is_file()
            else []
        )
        remaining = dict(parameters)
        out_lines: list[str] = []
        for raw in lines:
            stripped = raw.strip()
            eq = stripped.find("=")
            replaced = False
            if stripped and not stripped.startswith("#") and eq > 0:
                key = stripped[:eq].strip().strip('"')
                if key in remaining and key in self.parameters:
                    out_lines.append(f"{key} = \"{_fmt_float(remaining.pop(key))}\"")
                    replaced = True
            if not replaced:
                out_lines.append(raw)
        for key, val in remaining.items():
            out_lines.append(f"{key} = \"{_fmt_float(val)}\"")
        Path(out_path).write_text("\n".join(out_lines) + "\n", encoding="utf-8")


def _fmt_float(v: float) -> str:
    s = f"{v:.6f}".rstrip("0").rstrip(".")
    return s if s else "0"


def _resolve_asset(rel: str, base: Path) -> str:
    """Resolve a shader/texture path referenced from a preset.

    Strategies (a simplification of ShaderPreset::resolvePath,
    ShaderPreset.cpp:335-538): absolute paths pass through; otherwise
    resolve relative to the preset directory (handles ``../``); then try
    ``$RETROCAPTURE_SHADER_PATH``-rooted resolution; finally fall back to a
    basename search upward from the preset dir within a ``shaders_glsl``
    root, mirroring the reference's recursive-search rescue."""
    rel = rel.strip()
    if not rel:
        return rel
    cand = Path(rel)
    if cand.is_absolute():
        return str(cand)
    direct = (base / rel).resolve()
    if direct.exists():
        return str(direct)
    env_root = os.environ.get("RETROCAPTURE_SHADER_PATH")
    if env_root:
        envp = (Path(env_root) / rel).resolve()
        if envp.exists():
            return str(envp)
    # Rescue: walk up to the shader-tree root and search for the basename.
    name = Path(rel).name
    root = base
    for _ in range(6):
        if (root / "shaders_glsl").is_dir() or root.name == "shaders_glsl":
            tree = root if root.name == "shaders_glsl" else root / "shaders_glsl"
            hits = sorted(tree.rglob(name))
            if hits:
                return str(hits[0])
            break
        if root.parent == root:
            break
        root = root.parent
    return str(direct)  # best effort; caller reports missing file
