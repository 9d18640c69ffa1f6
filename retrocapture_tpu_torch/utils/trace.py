"""Named host spans of the port's hot path, on the profiler's clock.

``span(name)`` opens a ``torch.profiler.record_function`` range while a
profiler is recording, so the frame queue's, the engine's and the
replay's work shows up by name beside the device's activity records of
the same trace. With no profiler recording it returns one shared no-op
context manager: a bare ``record_function`` costs microseconds a call
even then, the check a fraction of one. A recording profiler is the only
switch; no flag or environment variable turns the spans on.

Every span's name starts with ``rctpu.``; README.md lists them. A span is
opened once a batch or a call, never inside a walk, a captured region or
a kernel wrapper: a CUDA graph's replay runs none of those in Python.
"""

from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a host range while a
    profiler is recording, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return record_function(name)
