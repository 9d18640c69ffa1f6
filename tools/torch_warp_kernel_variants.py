#!/usr/bin/env python3
"""Where the warp kernel's time goes, by variants of its source.

    python3 tools/torch_warp_kernel_variants.py        (needs an NVIDIA GPU and nvcc)

Builds variants of ``retrocapture_tpu_torch/csrc/warp_sample.cu`` by
textual patches (each patch names a line of the source and fails loudly if
the source no longer has it), launches each with the arguments the wrapper
gives the real kernel (LINEAR, clamp_to_border, RGBA, the float4 path) on
a 1080p curvature grid, and prints the device time per launch (CUDA events
around 50 launches; two rounds in turns, the first of which holds each
variant's first launches, so read the second) at [8, 240, 320, 4] (the
main path's batched launch) and [1, 240, 320, 4]. Every variant but
``nostore`` must write the kernel's bytes. Beside them, what the card
does with the same output without any sampling: ``fill_`` of the output
tensor (its bytes written) and ``copy_`` of a tensor of its size (read
and written).

Variants: ``base`` (the source as it is); ``unroll1`` and ``unroll4``
(the frame loop's unroll depth, 2 in the source); ``t128`` and ``t512``
(threads a block, 256 in the source); ``lb8`` (``__launch_bounds__(256,
8)``: at most 32 registers); ``stnorm`` (plain stores for ``__stcs``);
``nostore`` (no output stores: the taps and lerps alone). PERF.md quotes
its output.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BATCHES = (8, 1)
LB = "__global__ void __launch_bounds__(kThreads)"
VARIANTS = {
    "base": [],
    "unroll1": [("#pragma unroll 2", "#pragma unroll 1")],
    "unroll4": [("#pragma unroll 2", "#pragma unroll 4")],
    "t128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "t512": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "lb8": [(LB, "__global__ void __launch_bounds__(kThreads, 8)")],
    "stnorm": [("      __stcs(dst + b * static_cast<size_t>(P), r);", "      dst[b * static_cast<size_t>(P)] = r;")],
    "nostore": [("      __stcs(dst + b * static_cast<size_t>(P), r);",
                 "      if (r.x == 12345.0f && r.y == -1.0f) dst[b * static_cast<size_t>(P)] = r;")],
}


def patched(src: str, patches) -> str:
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"variant patch no longer matches warp_sample.cu: {old!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch

    sys.path.insert(0, str(REPO))
    from retrocapture_tpu_torch.ops.cuda import _build
    from retrocapture_tpu_torch.ops.cuda import warp_sample as ws

    if not torch.cuda.is_available():
        raise SystemExit("torch_warp_kernel_variants: needs an NVIDIA GPU")
    src = (_build.CSRC / "warp_sample.cu").read_text()
    out_dir = _build.BUILD_DIR / "warp_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(patched(src, patches))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines() if "registers" in line]
        print(f"{name}: {regs[-1] if regs else ''}", flush=True)
        fn = getattr(ctypes.CDLL(str(out_dir / f"{name}.so")), _build.KERNELS["warp_sample"][0])
        fn.argtypes = _build.KERNELS["warp_sample"][1]
        fns[name] = fn

    def event_ms(fn, iters=50):
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    ho, wo = 1080, 1920
    y = (torch.arange(ho, device=dev, dtype=torch.float32) + 0.5) / ho
    x = (torch.arange(wo, device=dev, dtype=torch.float32) + 0.5) / wo
    cy, cx = torch.meshgrid(y - 0.5, x - 0.5, indexing="ij")
    k = 1.0 + 0.25 * (cx * cx + cy * cy)
    u, v = (0.5 + cx * k).contiguous(), (0.5 + cy * k).contiguous()
    print(torch.cuda.get_device_name(0), flush=True)
    for b in BATCHES:
        tex = torch.rand((b, 240, 320, 4), generator=gen, device=dev)
        out = torch.empty((b, ho, wo, 4), device=dev)
        other = torch.rand(out.shape, generator=gen, device=dev)
        want = ws.warp_sample_plain(tex, u, v, filter_linear=True, wrap_mode="clamp_to_border")
        args = [tex.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), b, 240, 320, 4, ho * wo, 1, 1, 1,
                torch.cuda.current_stream().cuda_stream]
        for rnd in range(2):
            order = list(fns) if rnd == 0 else list(fns)[::-1]
            times = {}
            for name in order:
                out.zero_()
                times[name] = event_ms(lambda: fns[name](*args))
                if name != "nostore" and not torch.equal(out, want):
                    raise SystemExit(f"variant {name} wrote other bytes than the plain gather")
            times["fill_"] = event_ms(lambda: out.fill_(0.5))
            times["copy_"] = event_ms(lambda: out.copy_(other))
            print(f"[{b},240,320,4] -> {ho}x{wo} round {rnd}: "
                  + "; ".join(f"{n} {t:.4f} ms" for n, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
