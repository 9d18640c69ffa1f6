"""Offline preset thumbnails — the ThumbnailGenerator equivalent
(src/utils/ThumbnailGenerator: renders preset previews to PNG for the
UI preset gallery)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["generate_preset_thumbnail", "generate_gallery"]


def generate_preset_thumbnail(
    preset_path: str | Path,
    out_png: str | Path,
    *,
    source: Optional[np.ndarray] = None,
    size: tuple[int, int] = (320, 240),
    frames: int = 2,
    device="cuda",
) -> bool:
    """Render ``preset_path`` applied to ``source`` (default: the SMPTE
    test pattern) on ``device`` and write a PNG preview. Returns False
    when the preset fails to compile (no thumbnail, like the reference's
    gallery)."""
    from PIL import Image

    from retrocapture_tpu_torch import Engine
    from retrocapture_tpu_torch.io.testpattern import TestPatternSource

    w, h = size
    if source is None:
        source = TestPatternSource(320, 240).capture_frame()
    eng = Engine(viewport=(w, h), device=device)
    if not eng.load_preset(str(preset_path)):
        return False
    out = None
    for _ in range(max(frames, 1)):  # temporal presets need warm history
        out = eng.apply_u8(source)
    Path(out_png).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.asarray(out)).save(str(out_png))
    return True


def generate_gallery(
    shader_root: str | Path,
    out_dir: str | Path,
    *,
    limit: int = 0,
    size: tuple[int, int] = (320, 240),
    device="cuda",
) -> dict:
    """Thumbnail every .glslp under shader_root into out_dir, mirroring
    the directory layout. Returns {preset: ok} summary."""
    from retrocapture_tpu_torch.utils.scanner import scan_presets

    root = Path(shader_root)
    results = {}
    for i, p in enumerate(scan_presets(root)):
        if limit and i >= limit:
            break
        rel = p.relative_to(root)
        dest = Path(out_dir) / rel.with_suffix(".png")
        try:
            results[str(rel)] = generate_preset_thumbnail(p, dest, size=size, device=device)
        except RuntimeError:
            # No device, or a kernel that did not build or launch: not a
            # fault of this preset, and every later one would hit it too.
            raise
        except Exception:  # noqa: BLE001 - gallery keeps going
            results[str(rel)] = False
    return results
