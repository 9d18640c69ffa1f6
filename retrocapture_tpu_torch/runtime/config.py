"""Persistent configuration — the core-scope slice of UIManager's role as
"the config model of record" (docs/ARCHITECTURE.md:292-299 in the
reference: config.json written on every change, loaded at startup), plus
named capture-preset profiles (utils/PresetManager).

Only frame-core settings exist here (preset, parameters, viewport,
logical resolution, overscan, image controls); capture-card/streaming/UI
settings are out of scope per BASELINE.json.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional

from retrocapture_tpu_torch.utils.paths import config_dir, data_dir

__all__ = ["CoreConfig", "ProfileManager"]


@dataclass
class CoreConfig:
    """config.json model. save() on every mutation, like the reference."""

    preset: str = ""
    parameters: dict = field(default_factory=dict)  # name -> float
    viewport: Optional[list] = None  # [W, H]
    logical_resolution: Optional[list] = None  # [W, H]
    overscan_percent: list = field(default_factory=lambda: [0.0, 0.0])
    brightness: float = 1.0
    contrast: float = 1.0
    flip_y: bool = False
    maintain_aspect: bool = False

    @classmethod
    def path(cls) -> Path:
        return config_dir() / "config.json"

    @classmethod
    def load(cls) -> "CoreConfig":
        p = cls.path()
        if not p.is_file():
            return cls()
        try:
            raw = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            return cls()
        cfg = cls()
        for k, v in raw.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        return cfg

    def save(self) -> None:
        p = self.path()
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(asdict(self), indent=1))

    # -- engine wiring ---------------------------------------------------
    def apply_to(self, engine) -> None:
        if self.preset:
            engine.load_preset(self.preset)
        for name, val in self.parameters.items():
            engine.set_parameter(name, float(val))
        if self.viewport:
            engine.set_viewport(*self.viewport)

    def build_pipeline(self, engine):
        from retrocapture_tpu_torch.runtime.pipeline import FramePipeline, ImageSettings

        return FramePipeline(
            engine,
            logical_resolution=tuple(self.logical_resolution)
            if self.logical_resolution
            else None,
            overscan_percent=tuple(self.overscan_percent),
            image=ImageSettings(
                brightness=self.brightness,
                contrast=self.contrast,
                flip_y=self.flip_y,
                maintain_aspect=self.maintain_aspect,
            ),
        )


class ProfileManager:
    """Named config profiles as JSON under the data dir (the capture-
    preset/profile pattern shared by PresetManager / RecordingProfileManager
    / StreamingProfileManager in the reference)."""

    def __init__(self, kind: str = "profiles"):
        self.dir = data_dir() / kind
        self.dir.mkdir(parents=True, exist_ok=True)

    def list(self) -> list[str]:
        return sorted(p.stem for p in self.dir.glob("*.json"))

    def save(self, name: str, cfg: CoreConfig) -> None:
        (self.dir / f"{name}.json").write_text(json.dumps(asdict(cfg), indent=1))

    def load(self, name: str) -> Optional[CoreConfig]:
        p = self.dir / f"{name}.json"
        if not p.is_file():
            return None
        raw = json.loads(p.read_text())
        cfg = CoreConfig()
        for k, v in raw.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        return cfg

    def delete(self, name: str) -> bool:
        p = self.dir / f"{name}.json"
        if p.is_file():
            p.unlink()
            return True
        return False
