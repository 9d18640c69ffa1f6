"""XDG-style path roles — the Paths equivalent (src/utils/Paths.h:19-58):
config / data / cache directories resolved from the environment with
sensible fallbacks, so presets, profiles, and logs land where the
platform expects."""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["config_dir", "data_dir", "cache_dir", "log_file"]

_APP = "retrocapture_tpu"


def _xdg(var: str, fallback: str) -> Path:
    base = os.environ.get(var)
    root = Path(base) if base else Path.home() / fallback
    return root / _APP


def config_dir(create: bool = True) -> Path:
    p = _xdg("XDG_CONFIG_HOME", ".config")
    if create:
        p.mkdir(parents=True, exist_ok=True)
    return p


def data_dir(create: bool = True) -> Path:
    p = _xdg("XDG_DATA_HOME", ".local/share")
    if create:
        p.mkdir(parents=True, exist_ok=True)
    return p


def cache_dir(create: bool = True) -> Path:
    p = _xdg("XDG_CACHE_HOME", ".cache")
    if create:
        p.mkdir(parents=True, exist_ok=True)
    return p


def log_file() -> Path:
    """retrocapture.log lives in the cache dir (Logger.h; the reference
    smoke test greps it)."""
    return cache_dir() / "retrocapture_tpu.log"
