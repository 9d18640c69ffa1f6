"""Leveled logger (the reference's utils/Logger writes retrocapture.log
with a RETROCAPTURE_LOG_LEVEL env override, Logger.h:18-21; we map that
onto stdlib logging with the same env variable)."""

from __future__ import annotations

import logging
import os

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "warn": logging.WARNING,
    "error": logging.ERROR,
}

_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = _LEVELS.get(
            os.environ.get("RETROCAPTURE_LOG_LEVEL", "info").lower(), logging.INFO
        )
        logging.basicConfig(
            level=level,
            format="[%(levelname)s] %(name)s: %(message)s",
        )
        _configured = True
    return logging.getLogger(name)
