#!/usr/bin/env python3
"""Where the blit kernel's time goes, by taking parts of it out.

    python3 tools/torch_blit_kernel_variants.py        (needs an NVIDIA GPU and nvcc)

Builds variants of ``retrocapture_tpu_torch/csrc/resample_u8.cu`` by
textual patches (each patch names a line of the source and fails loudly if
the source no longer has it), launches each with the arguments the wrapper
gives the real kernel, and prints the device time per launch (CUDA events
around the launch, behind a spin kernel, mean of 10; two rounds, the first
of which holds each variant's first launches, so read the second) at three
shapes: [128, 240, 320, 3], [128, 1080, 1920, 3] and [128, 224, 256, 3] to
1080p. A variant marked ``!`` writes other bytes than the kernel (it leaves
work out); the others must write the same.

Variants: ``base`` (the source as it is); ``nostore`` (no global stores);
``nostage`` (no staging stores and no global stores); ``nox`` (the x pass
reads no shared memory); ``noy`` (no y pass); ``noall`` (all four: what is
left is the arithmetic, the loops, the shuffles and the row fetches);
``occ1`` (shared memory padded so that one block fits an SM: 8 warps
instead of 16); ``lb3`` (``__launch_bounds__(256, 3)``: 80 registers with
spills, 24 warps an SM). PERF.md quotes its output.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = [(128, 240, 320, 1080, 1920), (128, 1080, 1920, 1080, 1920), (128, 224, 256, 1080, 1920)]

NOSTORE = [(
    "      *reinterpret_cast<uint4*>(orow + e) = *reinterpret_cast<const uint4*>(stage + s + e);",
    "      if (OW < 0) *reinterpret_cast<uint4*>(orow + e) = *reinterpret_cast<const uint4*>(stage + s + e);",
)]
NOSTAGE = [(
    "              for (int c = 0; c < C; ++c) mine[c] = static_cast<unsigned char>(q[c]);",
    "              for (int c = 0; c < C; ++c) if (q[c] == 77777) mine[c] = static_cast<unsigned char>(q[c]);",
)]
NOX = [
    ("            const Texel<C> a0 = load_texel<C>(ya + e0[j]);",
     "            Texel<C> a0; for (int c = 0; c < C; ++c) a0.v[c] = w0[j] + e0[j];"),
    ("            if (HAS_X) a1 = load_texel<C>(ya + e1[j]);",
     "            if (HAS_X) for (int c = 0; c < C; ++c) a1.v[c] = w1[j] + e1[j];"),
]
NOY = [(
    "        for (int t = lane; t < n; t += 32) {\n          const Texel<C> ta",
    "        for (int t = lane; t < (OW < 0 ? n : 0); t += 32) {\n          const Texel<C> ta",
)]
OCC1 = [(
    "  const size_t shmem = kWarps * unit_bytes(HAS_Y, a.cap, C);",
    "  const size_t shmem = kWarps * unit_bytes(HAS_Y, a.cap, C) + 120 * 1024;",
)]
LB3 = [("__global__ void __launch_bounds__(kThreads)", "__global__ void __launch_bounds__(kThreads, 3)")]
VARIANTS = {
    "base": [], "nostore": NOSTORE, "nostage": NOSTAGE + NOSTORE, "nox": NOX, "noy": NOY,
    "noall": NOX + NOY + NOSTAGE + NOSTORE, "occ1": OCC1, "lb3": LB3,
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_blit_kernel_variants: needs an NVIDIA GPU")
    sys.path.insert(0, str(REPO))
    from retrocapture_tpu_torch.ops.cuda import _build
    from retrocapture_tpu_torch.ops.cuda import resample as rs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    source = (_build.CSRC / "resample_u8.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    entries = {}
    for name, patches in VARIANTS.items():
        text = source
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: the source has {text.count(old)} times the line\n{old}")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                             capture_output=True, text=True)
        if log.returncode:
            raise SystemExit(f"variant {name} does not build:\n{log.stderr[-3000:]}")
        regs = [ln.split("Used ")[1].split(",")[0] for ln in (log.stdout + log.stderr).splitlines() if "Used " in ln]
        fn = getattr(ctypes.CDLL(str(so)), _build.KERNELS["resample_u8"][0])
        fn.argtypes, fn.restype = _build.KERNELS["resample_u8"][1], ctypes.c_int
        entries[name] = fn
        print(f"{name}: built, registers per variant kernel {sorted(set(regs))}", flush=True)

    def launch_ms(fn, args, iters=10):
        total = 0.0
        for _ in range(iters):
            torch.cuda._sleep(1_000_000)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*args)
            stop.record()
            torch.cuda.synchronize()
            if rc != 0:
                raise SystemExit(f"launch failed: cudaError {rc}")
            total += start.elapsed_time(stop)
        return total / iters

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    _build.build_all()
    for b, h, w, oh, ow in SHAPES:
        tex = torch.rand((b, h, w, 3), generator=gen, device="cuda")
        raw, seen = _build.load("resample_u8"), []
        _build._ENTRIES["resample_u8"] = lambda *a: (seen.append(a), raw(*a))[1]
        try:
            want = rs.blit_u8(tex, ow, oh)  # the blit cache keeps the device tables alive
        finally:
            _build._ENTRIES["resample_u8"] = raw
        launch_ms(entries["base"], list(seen[0]), 30)  # bring the clocks up
        for rnd in (1, 2):
            line = f"[{b},{h},{w},3] -> {oh}x{ow}, round {rnd}:"
            for name, fn in entries.items():
                out = torch.zeros_like(want)
                args = list(seen[0])
                args[1] = out.data_ptr()
                ms = launch_ms(fn, args)
                line += f" {name} {ms:.3f}{'' if torch.equal(out, want) else '!'}"
            print(line, flush=True)
        del tex, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
