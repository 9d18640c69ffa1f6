"""Per-frame pipeline around the Engine — the equivalent of
FrameCapturePipeline::renderAndDistributeFrame
(src/core/FrameCapturePipeline.cpp:93) plus the final
OpenGLRenderer::renderTexture blit (src/renderer/OpenGLRenderer.cpp:389).
The port of ``retrocapture_tpu/runtime/pipeline.py``.

Stages, all on the engine's device:

1. *Logical-resolution downscale* — when a logical capture resolution is
   set and smaller than the source, the frame is downscaled with NEAREST
   so CRT shaders see pixelated low-res input as designed
   (FrameCapturePipeline.cpp:142-258);
2. *Overscan crop* — X/Y percent cropped from each side via the
   enlarged-viewport trick, clamped to 45% per side (:211-223);
3. the shader chain (runtime/engine.py);
4. *Final blit* — brightness/contrast/flip-Y as in the GL 3 fragment
   (OpenGLRenderer.cpp: ``color*brightness`` then
   ``(color-0.5)*contrast+0.5``) and letterbox/pillarbox viewport math
   (:449-463) with black bars.

The sampling grids of stages 1-2 and 4 are numpy, built once per key and
kept. The image controls round as the reference's jitted blit does: a
multiply that feeds an add or a subtract is contracted (``fma32``), a
brightness of 1.0 drops out, and at a contrast of 1.0 the constants
cancel.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from retrocapture_tpu_torch.ops.sampling import sample2d
from retrocapture_tpu_torch.policy import fma32
from retrocapture_tpu_torch.runtime.engine import Engine, _grids
from retrocapture_tpu_torch.utils.metrics import FrameStats

__all__ = ["FramePipeline", "ImageSettings"]


@dataclass
class ImageSettings:
    """The image controls the UI exposes (UIConfigurationImage)."""

    brightness: float = 1.0
    contrast: float = 1.0
    flip_y: bool = False
    maintain_aspect: bool = False


class FramePipeline:
    """Engine + source preparation + final blit, mirroring the per-frame
    path of the reference application."""

    def __init__(
        self,
        engine: Engine,
        *,
        logical_resolution: Optional[tuple[int, int]] = None,  # (W, H)
        overscan_percent: tuple[float, float] = (0.0, 0.0),  # X%, Y% per side
        image: Optional[ImageSettings] = None,
        window: Optional[tuple[int, int]] = None,  # (W, H) final blit target
    ):
        self.engine = engine
        self.logical_resolution = logical_resolution
        self.overscan_percent = overscan_percent
        self.image = image or ImageSettings()
        self.window = window
        self._prep_grids: dict = {}
        self._blit_plans: dict = {}
        self.stats = FrameStats()

    # -- source preparation --------------------------------------------
    def _prepare(self, frames):
        """Logical-res NEAREST downscale + overscan crop (batched)."""
        h, w = frames.shape[1], frames.shape[2]
        lw, lh = self.logical_resolution or (0, 0)
        needs_downscale = 0 < lw < w and 0 < lh < h
        ox = float(np.clip(self.overscan_percent[0] / 100.0, 0.0, 0.45))
        oy = float(np.clip(self.overscan_percent[1] / 100.0, 0.0, 0.45))
        needs_overscan = ox > 1e-5 or oy > 1e-5
        if not needs_downscale and not needs_overscan:
            return frames
        fw, fh = (lw, lh) if needs_downscale else (w, h)
        key = (h, w, fw, fh, ox, oy)
        grids = self._prep_grids.get(key)
        if grids is None:
            # Overscan maps output [0,1] into the central visible fraction of
            # the source: u' = ox + u*(1-2*ox) (FrameCapturePipeline.cpp:211).
            u, v = _grids(fw, fh)
            u = (ox + u * (1.0 - 2.0 * ox)).astype(np.float32)
            v = (oy + v * (1.0 - 2.0 * oy)).astype(np.float32)
            grids = self._prep_grids[key] = (u, v)
        u, v = grids
        return torch.stack([sample2d(t, u, v, filter_linear=False) for t in frames])

    # -- final blit -----------------------------------------------------
    def _blit_plan(self, h: int, w: int):
        """(u, v, (vx, vy, vw, vh), (ww, wh)) of the final blit of an
        ``h x w`` frame, kept per geometry and image setting."""
        img = self.image
        ww, wh = self.window or (w, h)
        key = (h, w, ww, wh, img.flip_y, img.maintain_aspect)
        plan = self._blit_plans.get(key)
        if plan is None:
            # Letterbox/pillarbox placement (OpenGLRenderer.cpp:449-463).
            vx, vy, vw, vh = 0, 0, ww, wh
            if img.maintain_aspect and w > 0 and h > 0:
                tex_aspect = w / h
                win_aspect = ww / wh
                if tex_aspect > win_aspect:
                    vh = int(ww / tex_aspect)
                    vy = (wh - vh) // 2
                else:
                    vw = int(wh * tex_aspect)
                    vx = (ww - vw) // 2
            u, v = _grids(vw, vh)
            if img.flip_y:
                v = 1.0 - v
            plan = self._blit_plans[key] = (u, v, (vx, vy, vw, vh), (ww, wh))
        return plan

    def _blit(self, frames):
        img = self.image
        if self.window is None and not img.flip_y and img.brightness == 1.0 and img.contrast == 1.0:
            return frames
        u, v, (vx, vy, vw, vh), (ww, wh) = self._blit_plan(frames.shape[1], frames.shape[2])
        brightness = float(np.float32(img.brightness))
        contrast = float(np.float32(img.contrast))
        outs = []
        for t in frames:
            out = sample2d(t, u, v, filter_linear=True)
            # out * brightness, then (out - 0.5) * contrast + 0.5. At
            # contrast 1.0 the two constants cancel (XLA folds
            # ``(x - 0.5) + 0.5`` into ``x``).
            if contrast == 1.0:
                out = out if brightness == 1.0 else out * brightness
            else:
                out = out - 0.5 if brightness == 1.0 else fma32(out, brightness, -0.5)
                out = fma32(out, contrast, 0.5)
            outs.append(torch.clamp(out, 0.0, 1.0))
        out = torch.stack(outs)
        if (vx, vy, vw, vh) != (0, 0, ww, wh):
            canvas = torch.zeros((out.shape[0], wh, ww, out.shape[-1]), dtype=out.dtype, device=out.device)
            canvas[:, vy : vy + vh, vx : vx + vw] = out
            out = canvas
        return out

    # -- public ---------------------------------------------------------
    def process(self, frames):
        """uint8/float [H,W,3] or [B,H,W,3] (numpy, or a tensor on the
        engine's device) → float32 RGB at the window (or viewport) size on
        the engine's device, shader chain applied when loaded."""
        t0 = time.monotonic()
        arr = self.engine._upload(frames)
        batched = arr.dim() == 4
        if not batched:
            arr = arr[None]
        n = arr.shape[0]
        if arr.dtype == torch.uint8:
            arr = arr.to(torch.float32) * (1.0 / 255.0)
        arr = self._prepare(arr)
        out = self.engine.apply(arr)
        out = self._blit(out)
        self.stats.tick(n, latency_s=time.monotonic() - t0)
        return out if batched else out[0]
