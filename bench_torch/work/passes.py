"""The sizes of a configuration's passes, from its ``passes`` entries, by
RetroArch's scale rules as the program applies them: an axis scales the
pass's input (``source``, or the key unset), the viewport (``viewport``)
or is a literal size (``absolute``), rounded half away from zero; on the
last pass an axis left unset or at ``source`` 1.0 takes the viewport's.

An entry gives ``scale_type`` and ``scale`` for both axes, or
``scale_type_x`` / ``scale_x`` and ``scale_type_y`` / ``scale_y``. The
readers of kernels whose shapes are a pass's take them from here.
"""

from __future__ import annotations

import math


def _axis(entry: dict, axis: str):
    kind = entry.get(f"scale_type_{axis}", entry.get("scale_type", ""))
    scale = float(entry.get(f"scale_{axis}", entry.get("scale", 1.0)) or 1.0)
    return kind, scale


def _size(source: int, kind: str, scale: float, viewport: int) -> int:
    if kind == "absolute":
        x = scale
    elif kind == "viewport":
        x = viewport * scale
    else:
        x = source * scale
    return max(1, int(math.floor(x + 0.5)))


def sizes(config: dict, src_hw, viewport) -> list:
    """``[(out_h, out_w), ...]`` of each pass of ``config`` over a source
    ``src_hw`` (h, w) at ``viewport`` (W, H)."""
    (h, w), (vw, vh) = src_hw, viewport
    out = []
    passes = config["passes"]
    for i, entry in enumerate(passes):
        dims = []
        for axis, source, view in (("x", w, vw), ("y", h, vh)):
            kind, scale = _axis(entry, axis)
            if i == len(passes) - 1 and (kind == "" or (kind == "source" and scale == 1.0)):
                kind, scale = "viewport", 1.0
            dims.append(_size(source, kind, scale, view))
        w, h = dims
        out.append((h, w))
    return out
