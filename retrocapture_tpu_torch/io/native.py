"""ctypes bindings for the native framehost library (native/framehost).

Native host-side runtime pieces: the bounded frame ring with drop-oldest
and captureLatestFrame drain semantics, fixed-point BT.601 pixel-format
converters, and the SMPTE test-pattern generator. Falls back cleanly when
the .so has not been built (``make -C native/framehost``); call
``ensure_built()`` to build on demand with the in-image toolchain.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["load", "ensure_built", "NativeRing", "native_available"]

_ROOT = Path(__file__).resolve().parents[2]
_DIR = _ROOT / "native" / "framehost"
_SO = _DIR / "libframehost.so"

_lib: Optional[ctypes.CDLL] = None


def ensure_built() -> bool:
    """Build libframehost.so if missing. Returns availability."""
    if _SO.is_file():
        return True
    try:
        subprocess.run(
            ["make", "-C", str(_DIR)], check=True, capture_output=True, timeout=120
        )
    except Exception:
        return False
    return _SO.is_file()


def load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not _SO.is_file() and not ensure_built():
        return None
    lib = ctypes.CDLL(str(_SO))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rc_ring_create.restype = ctypes.c_void_p
    lib.rc_ring_create.argtypes = [ctypes.c_uint32, ctypes.c_size_t]
    lib.rc_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.rc_ring_push.argtypes = [ctypes.c_void_p, u8p]
    lib.rc_ring_pop.restype = ctypes.c_int
    lib.rc_ring_pop.argtypes = [ctypes.c_void_p, u8p]
    lib.rc_ring_pop_latest.restype = ctypes.c_int64
    lib.rc_ring_pop_latest.argtypes = [ctypes.c_void_p, u8p]
    lib.rc_ring_size.restype = ctypes.c_uint32
    lib.rc_ring_size.argtypes = [ctypes.c_void_p]
    lib.rc_ring_pushed.restype = ctypes.c_uint64
    lib.rc_ring_pushed.argtypes = [ctypes.c_void_p]
    lib.rc_ring_dropped.restype = ctypes.c_uint64
    lib.rc_ring_dropped.argtypes = [ctypes.c_void_p]
    for name in ("rc_yuyv_to_rgb24", "rc_uyvy_to_rgb24", "rc_bgra_to_rgb24", "rc_rgba_to_rgb24"):
        fn = getattr(lib, name)
        fn.argtypes = [u8p, u8p, ctypes.c_uint32, ctypes.c_uint32]
    lib.rc_nv12_to_rgb24.argtypes = [u8p, u8p, u8p, ctypes.c_uint32, ctypes.c_uint32]
    lib.rc_testpattern_fill.argtypes = [u8p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64]
    _lib = lib
    return lib


def native_available() -> bool:
    return load() is not None


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeRing:
    """Python wrapper over the native frame ring."""

    def __init__(self, capacity: int, frame_shape: tuple, dtype=np.uint8):
        lib = load()
        if lib is None:
            raise RuntimeError("libframehost.so unavailable (run make -C native/framehost)")
        self._lib = lib
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self.frame_bytes = int(np.prod(frame_shape)) * self.dtype.itemsize
        self._h = lib.rc_ring_create(capacity, self.frame_bytes)
        if not self._h:
            raise RuntimeError("rc_ring_create failed")

    def push(self, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame, self.dtype)
        assert frame.nbytes == self.frame_bytes
        self._lib.rc_ring_push(self._h, _ptr(frame))

    def pop(self) -> Optional[np.ndarray]:
        out = np.empty(self.frame_shape, self.dtype)
        if not self._lib.rc_ring_pop(self._h, _ptr(out)):
            return None
        return out

    def pop_latest(self) -> Optional[tuple[np.ndarray, int]]:
        """Newest frame + number of discarded older frames
        (captureLatestFrame, IVideoCapture.h:76)."""
        out = np.empty(self.frame_shape, self.dtype)
        n = self._lib.rc_ring_pop_latest(self._h, _ptr(out))
        if n < 0:
            return None
        return out, int(n)

    def __len__(self) -> int:
        return int(self._lib.rc_ring_size(self._h))

    @property
    def stats(self) -> dict:
        return {
            "pushed": int(self._lib.rc_ring_pushed(self._h)),
            "dropped": int(self._lib.rc_ring_dropped(self._h)),
        }

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.rc_ring_destroy(h)
            self._h = None


def yuyv_to_rgb24(raw: np.ndarray, w: int, h: int) -> np.ndarray:
    lib = load()
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    lib.rc_yuyv_to_rgb24(_ptr(raw), _ptr(out), w, h)
    return out


def uyvy_to_rgb24(raw: np.ndarray, w: int, h: int) -> np.ndarray:
    lib = load()
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    lib.rc_uyvy_to_rgb24(_ptr(raw), _ptr(out), w, h)
    return out


def nv12_to_rgb24(y: np.ndarray, uv: np.ndarray, w: int, h: int) -> np.ndarray:
    lib = load()
    y = np.ascontiguousarray(y, np.uint8)
    uv = np.ascontiguousarray(uv, np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    lib.rc_nv12_to_rgb24(_ptr(y), _ptr(uv), _ptr(out), w, h)
    return out


def bgra_to_rgb24(raw: np.ndarray, w: int, h: int) -> np.ndarray:
    lib = load()
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    lib.rc_bgra_to_rgb24(_ptr(raw), _ptr(out), w, h)
    return out


def testpattern(w: int, h: int, frame_index: int = 0) -> np.ndarray:
    lib = load()
    out = np.empty((h, w, 3), np.uint8)
    lib.rc_testpattern_fill(_ptr(out), w, h, frame_index)
    return out
