"""Recursive preset discovery — the ShaderScanner equivalent
(src/utils/ShaderScanner, used by the UI preset gallery and the API's
shader list route)."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator, Optional

__all__ = ["scan_presets", "default_shader_root"]


def default_shader_root() -> Optional[Path]:
    """Shader tree resolution: $RETROCAPTURE_SHADER_PATH first (the env
    override the reference honors, ShaderPreset.cpp:353), then the
    mounted reference tree."""
    env = os.environ.get("RETROCAPTURE_SHADER_PATH")
    if env and Path(env).is_dir():
        return Path(env)
    ref = Path("shaders_glsl")
    return ref if ref.is_dir() else None


def scan_presets(
    root: Optional[str | Path] = None, *, include_glsl: bool = False
) -> Iterator[Path]:
    """Yield every .glslp (and optionally bare .glsl) under root,
    sorted, relative paths stable across runs."""
    base = Path(root) if root else default_shader_root()
    if base is None or not base.is_dir():
        return
    patterns = ["*.glslp"] + (["*.glsl"] if include_glsl else [])
    seen = set()
    for pat in patterns:
        for p in sorted(base.rglob(pat)):
            if p not in seen:
                seen.add(p)
                yield p
