"""Lightweight runtime metrics — frame timing, throughput EMA, counters.

The reference has NO tracing/profiling (SURVEY.md §5: observability is
an FPS overlay and throttled debug logs). This module is the upgrade: a
cheap, dependency-free stats aggregator any pipeline stage can feed, and
that the CLI's --stats and the info surfaces read."""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

__all__ = ["FrameStats", "Timer"]


@dataclass
class FrameStats:
    """Throughput/latency aggregator. ``tick(n_frames)`` per processed
    batch; snapshot() for reporting."""

    window: int = 120
    frames: int = 0
    batches: int = 0
    _t0: float = field(default_factory=time.monotonic)
    _last: float = field(default_factory=time.monotonic)
    _lat: deque = field(default_factory=lambda: deque(maxlen=240))
    fps_ema: float = 0.0

    def tick(self, n_frames: int = 1, latency_s: float | None = None) -> None:
        now = time.monotonic()
        dt = now - self._last
        self._last = now
        self.frames += n_frames
        self.batches += 1
        if dt > 0:
            inst = n_frames / dt
            alpha = 0.2
            self.fps_ema = inst if self.fps_ema == 0 else (
                alpha * inst + (1 - alpha) * self.fps_ema
            )
        if latency_s is not None:
            self._lat.append(latency_s)

    def snapshot(self) -> dict:
        lat = sorted(self._lat)
        n = len(lat)
        pct = lambda p: (lat[min(int(p * n), n - 1)] if n else None)  # noqa: E731
        up = time.monotonic() - self._t0
        return {
            "frames": self.frames,
            "batches": self.batches,
            "uptime_s": round(up, 3),
            "fps_avg": round(self.frames / up, 2) if up > 0 else None,
            "fps_ema": round(self.fps_ema, 2),
            "latency_p50_ms": round(pct(0.50) * 1000, 3) if n else None,
            "latency_p95_ms": round(pct(0.95) * 1000, 3) if n else None,
        }


class Timer:
    """Context-manager span timer feeding a FrameStats latency track."""

    def __init__(self, stats: FrameStats, n_frames: int = 1):
        self.stats = stats
        self.n = n_frames

    def __enter__(self):
        self._t = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.stats.tick(self.n, latency_s=time.monotonic() - self._t)
        return False
