"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C entry point (no PyTorch headers),
so one nvcc call per file takes seconds, and ``build_all`` runs them in
parallel: a cold build of every kernel takes as long as the slowest
source, not their sum, and stays so as kernels are added. Each file is
compiled for Hopper
(``sm_90a``) into ``build/kernels/`` at the root of the checkout, at the
first launch of one of its kernels, under a name that carries a hash of
the source: an edited kernel is rebuilt, an unchanged one is reused.

Nothing here runs at import time, so the CPU tests import every module
without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "KERNELS", "EXTRA_FLAGS", "load", "build_all", "BUILD_LOG"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# name -> (C entry point, its argument types); every entry returns
# cudaGetLastError() as an int and takes the stream last.
KERNELS = {
    "resample_u8": ("resample_u8_launch", [_P] * 12 + [_I] * 9 + [_P]),
    "warp_sample": ("warp_sample_launch", [_P] * 4 + [_I] * 8 + [_P]),
    "blur_groups": ("blur_groups_launch", [_P] * 7 + [_I] * 8 + [_P]),
    "resample_xphase": ("resample_xphase_launch", [_P, _P] + [_P] * 7 + [_I] * 6 + [_P]),
    "xbr_epilogue": ("xbr_epilogue_launch", [_P] * 8 + [_I] * 7 + [_P]),
    "mirrors": ("mirrors_launch", [_P, _P, _L, _I, _F, _P]),
    "fma": ("fma_launch", [_P, _P, _P, _F, _F, _F, _P, _I, _P, _I, _P]),
    "xbr_front": ("xbr_front_launch", [_P] + [_L] * 4 + [_P] * 8 + [_I] * 8 + [_P]),
    "mattias_epilogue": ("mattias_epilogue_launch",
                         [_P] * 3 + [_L] * 3 + [_P] * 7 + [_I] + [_P] * 2 + [_I, _P, _I, _P, _I, _L, _P]),
    "nnedi3": ("nnedi3_launch", [_P] + [_L] * 4 + [_P] * 3 + [_I] * 6 + [_P]),
}
# nvcc flags of one source beyond NVCC_FLAGS: the mirrors', the fma
# operator's, the xbr front section's, crt-mattias's epilogue's and nnedi3's
# roundings are all explicit, and no multiply-add may be contracted behind
# them.
EXTRA_FLAGS = {name: ["-fmad=false"] for name in ("mirrors", "fma", "xbr_front", "mattias_epilogue", "nnedi3")}

NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
]

# name -> loaded entry point, and name -> nvcc's output (registers, spills).
_ENTRIES: dict[str, object] = {}
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([\w.]+\.cuh)"', re.MULTILINE)


def _library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(source)
    for header in sorted(set(_INCLUDE.findall(source))):
        digest.update((CSRC / header.decode()).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _build(names) -> None:
    """Compile the libraries of ``names`` that are not built yet, one nvcc
    per source, all started together."""
    todo = {n: _library_path(n) for n in names if not _library_path(n).is_file()}
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        BUILD_LOG[name] = proc.communicate()[0].strip()
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(f"{n}:\n{BUILD_LOG[n]}" for n in failed))


def load(name: str):
    """The C entry point of kernel ``name``, its argument types set; the
    library is built on first use."""
    fn = _ENTRIES.get(name)
    if fn is not None:
        return fn
    _build([name])
    entry, argtypes = KERNELS[name]
    fn = getattr(ctypes.CDLL(str(_library_path(name))), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _ENTRIES[name] = fn
    return fn


def build_all() -> float:
    """Build (or find built) and load every kernel; seconds taken."""
    t0 = time.perf_counter()
    _build(KERNELS)
    for name in KERNELS:
        load(name)
    return time.perf_counter() - t0
