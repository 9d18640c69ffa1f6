"""Synthetic SMPTE-bar test source — the framework's test fixture.

TPU-native equivalent of VideoCaptureTestPattern
(src/capture/VideoCaptureTestPattern.cpp:56-102): 8 color bars chosen so
channel collapse/swap is detectable, plus a moving 1-column-per-frame
marker so temporal checks can assert the stream isn't frozen
(tools/smoke-test.sh:168-215 asserts brightness, spatial std, saturation,
>=5 distinct bars, and temporal mean-diff on exactly this pattern).
"""

from __future__ import annotations

import numpy as np

__all__ = ["TestPatternSource", "BAR_COLORS"]

# White, yellow, cyan, green, magenta, red, blue, near-black — the SMPTE
# ordering the reference uses; distinct in every channel permutation.
BAR_COLORS = np.array(
    [
        [255, 255, 255],
        [255, 255, 0],
        [0, 255, 255],
        [0, 255, 0],
        [255, 0, 255],
        [255, 0, 0],
        [0, 0, 255],
        [16, 16, 16],
    ],
    np.uint8,
)


class TestPatternSource:
    """Frame generator with the IVideoCapture-ish surface the host queue
    consumes: ``capture_frame() -> uint8 [H, W, 3]``."""

    def __init__(self, width: int = 1280, height: int = 720, fps: float = 60.0):
        self.width = int(width)
        self.height = int(height)
        self.fps = float(fps)
        self.frame_index = 0
        self._base = self._make_base()

    def _make_base(self) -> np.ndarray:
        h, w = self.height, self.width
        frame = np.zeros((h, w, 3), np.uint8)
        bw = max(w // 8, 1)
        for i in range(8):
            x0 = i * bw
            x1 = w if i == 7 else min((i + 1) * bw, w)
            frame[:, x0:x1] = BAR_COLORS[i]
        return frame

    def capture_frame(self) -> np.ndarray:
        """Next frame: bars + a white moving marker column that advances
        one column per frame (the temporal-aliveness signal)."""
        frame = self._base.copy()
        h, w = self.height, self.width
        mw = max(w // 100, 2)
        x = (self.frame_index * mw) % w  # advance a marker-width per frame
        band_h = max(h // 10, 1)
        # Dark band under the bars so the white marker is visible on every
        # bar (including the white one).
        frame[h - band_h :, :] = 32
        frame[h - band_h :, x : min(x + max(w // 100, 2), w)] = 255
        self.frame_index += 1
        return frame

    def capture_batch(self, n: int) -> np.ndarray:
        return np.stack([self.capture_frame() for _ in range(n)])
