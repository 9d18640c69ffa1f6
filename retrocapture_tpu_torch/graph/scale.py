"""Static pass-size inference.

Replicates ShaderEngine::calculateScale (ShaderEngine.cpp:1881-1910) and
the last-pass-fills-viewport default (:868-889): ``source`` scales the
pass input, ``viewport`` scales the window viewport, ``absolute`` is
literal pixels, empty means source x1; the last pass defaults to
viewport x1 unless it explicitly specifies a scale (an explicit
``source 1.0`` also upgrades to viewport, matching :881-889).

All sizes are static Python ints: each (source, viewport) pair produces
one fixed shape plan, which is what keys the jit cache (SURVEY.md §7
"shape-specialized jit cache").
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from retrocapture_tpu_torch.presets.glslp import PassConfig, Preset

__all__ = ["PassShapes", "compute_chain_shapes"]


def _round(x: float) -> int:
    """std::round — half away from zero (Python round() is banker's,
    which gives off-by-one pass sizes at half-integer products)."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


@dataclass(frozen=True)
class PassShapes:
    in_w: int
    in_h: int
    out_w: int
    out_h: int


def _calc(source: int, scale_type: str, scale: float, viewport: int) -> int:
    if scale_type in ("", "source"):
        s = scale if scale != 0.0 else 1.0
        return max(1, _round(source * s))
    if scale_type == "viewport":
        s = scale if scale != 0.0 else 1.0
        return max(1, _round(viewport * s))
    if scale_type == "absolute":
        return max(1, _round(scale))
    return max(1, source)


def pass_output_size(
    cfg: PassConfig,
    in_w: int,
    in_h: int,
    viewport_w: int,
    viewport_h: int,
    is_last: bool,
) -> tuple[int, int]:
    stx, sx = cfg.scale_type_x, cfg.scale_x
    sty, sy = cfg.scale_type_y, cfg.scale_y
    if is_last and stx != "viewport" and (stx == "" or (stx == "source" and sx == 1.0)):
        stx, sx = "viewport", 1.0
    if is_last and sty != "viewport" and (sty == "" or (sty == "source" and sy == 1.0)):
        sty, sy = "viewport", 1.0
    return _calc(in_w, stx, sx, viewport_w), _calc(in_h, sty, sy, viewport_h)


def _clamp_pass_output(ow: int, oh: int, max_w: int, max_h: int) -> tuple[int, int]:
    """Per-pass max-shader-resolution clamp, aspect-preserving, even dims
    (ShaderEngine.cpp:896-909)."""
    if max_w > 0 and ow > max_w:
        aspect = ow / oh
        ow = max_w
        oh = max((_round(max_w / aspect) // 2) * 2, 2)
    if max_h > 0 and oh > max_h:
        aspect = ow / oh
        oh = max_h
        ow = max((_round(max_h * aspect) // 2) * 2, 2)
    return ow, oh


def compute_chain_shapes(
    preset: Preset,
    source_w: int,
    source_h: int,
    viewport_w: int,
    viewport_h: int,
    max_resolution: Optional[tuple[int, int]] = None,
) -> list[PassShapes]:
    shapes: list[PassShapes] = []
    cur_w, cur_h = source_w, source_h
    n = len(preset.passes)
    for i, cfg in enumerate(preset.passes):
        ow, oh = pass_output_size(cfg, cur_w, cur_h, viewport_w, viewport_h, i == n - 1)
        if max_resolution is not None:
            ow, oh = _clamp_pass_output(ow, oh, max_resolution[0], max_resolution[1])
        shapes.append(PassShapes(cur_w, cur_h, ow, oh))
        cur_w, cur_h = ow, oh
    return shapes
