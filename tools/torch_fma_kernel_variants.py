#!/usr/bin/env python3
"""Where the multiply-add kernel's time goes, by changing one of its knobs.

    python3 tools/torch_fma_kernel_variants.py        (needs an NVIDIA GPU and nvcc)

Builds variants of ``retrocapture_tpu_torch/csrc/fma.cu`` by textual
patches (each patch names a line of the source and fails loudly if the
source no longer has it), launches each with the arguments the wrapper
gives the shipped kernel (its cached plan) on the main paths' operand forms
at their real sizes, checks that every variant writes the shipped kernel's
bits, and prints the device time per launch (CUDA events around the
launch, behind a spin kernel, mean of 20; two rounds, read the second)
beside ``torch.addcmul`` on the same operands and the byte bound (each
distinct operand's own bytes read once, the result written once, over
3.35 TB/s).

Variants: ``base`` (the source as it is: default loads, streaming
stores); ``streaming`` (streaming loads too, ``__ldcs``); ``plain``
(default stores instead of ``__stcs``); ``resident`` (the dense path's
grid: the blocks that fit on the card at once, by the occupancy query,
grid-stride, instead of a block per 512 float4s); ``unroll1``,
``unroll4`` (float4s of an operand a dense-path thread holds in flight);
``rows32`` (tiles of 32 rows instead of 16); ``warps4``, ``warps16`` (4
or 16 warps a tile block instead of 8: 4 or 1 rows a thread); ``lb64``
(``__launch_bounds__`` that hold the tile kernels to 64 registers);
``fmaf!``
(``__fmaf_rn`` in both modes: no f64 conversions; other bits, not
checked).
Prints one JSON object and writes it to
``chiprun_out/fma_kernel_variants.json``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PEAK_BYTES_S = 3.35e12
SPIN_CYCLES = 200_000
ITERS = 20

STREAMING = [  # (default, streaming) of the loads, then of the stores
    ("__device__ __forceinline__ float ld_once(const float* p) { return *p; }",
     "__device__ __forceinline__ float ld_once(const float* p) { return __ldcs(p); }"),
    ("__device__ __forceinline__ float4 ld_once(const float4* p) { return *p; }",
     "__device__ __forceinline__ float4 ld_once(const float4* p) { return __ldcs(p); }"),
    ("__device__ __forceinline__ void st_once(float* p, float v) { *p = v; }",
     "__device__ __forceinline__ void st_once(float* p, float v) { __stcs(p, v); }"),
    ("__device__ __forceinline__ void st_once(float4* p, float4 v) { *p = v; }",
     "__device__ __forceinline__ void st_once(float4* p, float4 v) { __stcs(p, v); }"),
]
# The dense path's grid sized by the occupancy query instead.
RESIDENT = """  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fma_dense_kernel<MODE, VEC>, kThreads, 0);
  const int blocks = static_cast<int>(want < per_sm * sms ? (want > 0 ? want : 1) : per_sm * sms);"""
# Variants whose name ends in "!" change the bits (they leave work out or
# change the arithmetic) and are not held to the shipped kernel's.
VARIANTS = {
    "base": [],
    "streaming": STREAMING[:2],
    "plain": [(new, old) for old, new in STREAMING[2:]],
    "resident": [("  const int blocks = static_cast<int>(want > 0 ? want : 1);", RESIDENT)],
    "unroll1": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 1;")],
    "unroll4": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")],
    "rows32": [("constexpr int kTileRows = 16;", "constexpr int kTileRows = 32;")],
    "warps4": [("constexpr int kTileWarps = 8;", "constexpr int kTileWarps = 4;")],
    "warps16": [("constexpr int kTileWarps = 8;", "constexpr int kTileWarps = 16;")],
    "lb64": [("__global__ void __launch_bounds__(kTilePx * kTileWarps) fma_tile_kernel",
              "__global__ void __launch_bounds__(kTilePx * kTileWarps, 4) fma_tile_kernel")],
    "fmaf!": [("  return MODE == kFma32 ? fma32(a, b, c) : __fmaf_rn(a, b, c);", "  return __fmaf_rn(a, b, c);")],
}


def cases(torch, dev):
    """(name, (a, b, c) operands) of the main paths' forms at their sizes."""
    g = torch.Generator(device=dev)
    g.manual_seed(12)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)

    h, w = 1080, 1920
    x3 = r(32, h, w, 3)
    return [
        ("feedback-ghost row weight", (r(h, w, 4), r(h, 1, 1), r(h, w, 4))),
        ("feedback-ghost column weight", (r(h, w, 4), r(1, w, 1), r(h, w, 4))),
        ("feedback-ghost mix", (r(h, w, 4), r(4), r(w, h, 4).transpose(0, 1))),
        ("FramePipeline brightness (transposed, C=3)", (r(1440, h, 3).transpose(0, 1), 1.1, -0.5)),
        ("crt-mattias fma32(col, col, -col)", (x3, x3, -x3)),
        ("crt-mattias scan [32, H*W] (column, row)", (r(h, w), 1.5, r(32, 1, 1))),
        ("xbr-lv2 channel gather", (r(64, h, 320, 3)[..., 0], 0.3, r(64, h, 320))),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_fma_kernel_variants: needs an NVIDIA GPU")
    sys.path.insert(0, str(REPO))
    from retrocapture_tpu_torch.ops.cuda import _build
    from retrocapture_tpu_torch.ops.cuda import fma as fm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    source = (_build.CSRC / "fma.cu").read_text()
    out_dir = _build.BUILD_DIR / "fma_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in VARIANTS.items():
        text = source
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"variant {name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        src = out_dir / f"fma_{name.rstrip('!')}.cu"
        src.write_text(text)
        lib = out_dir / f"libfma_{name.rstrip('!')}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.EXTRA_FLAGS["fma"], "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    entries = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed:\n{log}")
        regs = [line.split("Used ")[1].split(",")[0] for line in log.splitlines() if "Used " in line]
        print(f"{name}: registers of its kernels {regs}", flush=True)
        entry, argtypes = _build.KERNELS["fma"]
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[name] = fn

    dev = "cuda"
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn, tensors, values, out, plan):
        rc = fn(*(None if t is None else t.data_ptr() for t in tensors), *values, out.data_ptr(), plan.path,
                plan.geometry, 0, stream)
        if rc != 0:
            raise SystemExit(f"launch failed: cudaError {rc}")

    def timed_ms(fn):
        pairs = []
        for _ in range(ITERS):
            torch.cuda._sleep(SPIN_CYCLES)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            pairs.append((start, stop))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / ITERS

    result = {"card": card, "cases": []}
    for name, ops in cases(torch, dev):
        tensors = [x if isinstance(x, torch.Tensor) else None for x in ops]
        values = [0.0 if isinstance(x, torch.Tensor) else float(x) for x in ops]
        plan = fm._plan(tensors)
        want = fm.fma_plain(*ops, 0)
        outs = {vname: torch.empty(plan.shape, device=dev) for vname in entries}
        times = {}
        for _ in range(2):
            for vname, fn in entries.items():
                times[vname] = timed_ms(lambda: launch(fn, tensors, values, outs[vname], plan))
        for vname, out in outs.items():
            if not vname.endswith("!") and not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise SystemExit(f"variant {vname}: not bit-equal to plain on {name}")
        ta, tb, tc = (x if isinstance(x, torch.Tensor) else torch.tensor(x, device=dev) for x in ops)
        lib = timed_ms(lambda: torch.addcmul(tc, ta, tb))
        lib = timed_ms(lambda: torch.addcmul(tc, ta, tb))
        views = {(t.data_ptr(), tuple(t.shape), t.stride()): t for t in tensors if t is not None}
        own = sum(4 * int(torch.tensor([s for s, st in zip(t.shape, t.stride()) if st]).prod())
                  if any(t.stride()) else 4 for t in views.values())
        bound = (own + 4 * want.numel()) / PEAK_BYTES_S * 1e3
        row = {"case": name, "path": plan.path, "geometry": list(plan.geometry), "bound_ms": bound,
               "addcmul_ms": lib, "ms": times}
        result["cases"].append(row)
        print(f"{name} (path {plan.path}): bound {bound:.4f} ms, addcmul {lib:.4f} ms; " + ", ".join(
            f"{k} {v:.4f} ({100 * bound / v:.1f}%)" for k, v in times.items()) + f"  ({card})", flush=True)
        del ops, tensors, want, outs, ta, tb, tc
        torch.cuda.empty_cache()
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fma_kernel_variants.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
