#!/usr/bin/env python3
"""Where the mirror kernel's time goes, by variants of its source.

    python3 tools/torch_mirror_kernel_variants.py [--sites]    (needs an NVIDIA GPU and nvcc)

Builds variants of ``retrocapture_tpu_torch/csrc/mirrors.cu`` by textual
patches (each names text of the source and fails loudly if the source no
longer has it), and for each:

* times it at the main paths' two largest calls, crt-mattias's output
  gamma (pow 0.45 over [32, 1080, 1920, 3], values in [0, 1.2)) and
  nnedi3's exp (over [32, 64, 460800], values of N(0, 4^2)): device time
  per launch from CUDA events around 10 launches, two rounds in turns (the
  first holds each variant's first launches, so read the second); beside
  them ``copy_`` of a tensor of the pow's size (its bytes read and
  written);
* counts the conversions between f32 and f64 (``F2F``), the f64
  operations (``DADD``/``DMUL``/``DFMA``) and the f32 ones
  (``FADD``/``FMUL``/``FFMA``) in the SASS of the pow and exp kernels
  (``cuobjdump -sass``);
* for a variant that must keep the bits, counts its results that differ
  from the shipped kernel's over all 2^32 f32 bit patterns of each op it
  changes (bit-equal off the NaNs, NaN where the shipped one is) and over
  2^26 random patterns of the pow at each of the port's 7 exponents, and
  prints the first inputs that differ.

Variants: ``base`` (the source as it is: every multiply-add of log and exp
a single-rounding ``__fmaf_rn``); ``f64`` (every one of them
``policy.fma32``'s f64 formula, as the plain versions and csrc/fma.cu
compute it: the kernel before its redesign, which must give the bits of
``base`` at every input); ``f64_reinterp`` (``f64`` with the formula's
widenings and its narrowing replaced by bit reinterpretations: wrong bits,
for timing only: what the conversions cost); ``nostore`` (no output
stores: the arithmetic alone). With ``--sites``, also ``f64_L<k>`` and
``f64_E<k>``: only the k-th multiply-add of log or of exp in the f64
formula (checked, not timed). Writes ``chiprun_out/mirror_variants.json``;
PERF.md quotes it.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
POW_SHAPE = (32, 1080, 1920, 3)
EXP_SHAPE = (32, 64, 460800)
POW_EXPONENTS = (0.3, 2.2, 0.9, 0.45, 2.5, 2.0, 2.4)
OPS = {"sin": 0, "log": 1, "log2": 2, "exp": 3, "pow": 4}
CHUNK = 1 << 27
ITERS = 10

ANCHOR = "#include <stdint.h>\n"
INCLUDE = ANCHOR + """
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)), static_cast<double>(c)));
}
"""
REINTERP = INCLUDE + """
__device__ __forceinline__ float fma32_reinterp(float a, float b, float c) {
  const double s = __dadd_rn(__dmul_rn(__hiloint2double(__float_as_int(a), 0), __hiloint2double(__float_as_int(b), 0)),
                             __hiloint2double(__float_as_int(c), 0));
  return __int_as_float(__double2hiint(s));
}
#define fma32(a, b, c) fma32_reinterp(a, b, c)
"""
STORE = "      __stcs(o4 + j, v);"
NOSTORE = "      if (v.x == 12345.0f && v.y == -1.0f) __stcs(o4 + j, v);"
BODIES = {"L": "__device__ __forceinline__ float log_mirror(float x) {",
          "E": "__device__ __forceinline__ float exp_mirror(float x) {"}


def _body(src: str, fn: str):
    """(start, end) of the body of log_mirror ("L") or exp_mirror ("E")."""
    head = BODIES[fn]
    if src.count(head) != 1:
        raise SystemExit(f"variant patch no longer matches mirrors.cu: {head!r}")
    start = src.index(head)
    return start, src.index("\n}\n", start)


def f64_sites(src: str, fn: str, only=None) -> str:
    """Every __fmaf_rn call in fn's body (or only its k-th) as fma32, its
    definition added."""
    start, end = _body(src, fn)
    body = src[start:end]
    hits = [m.start() for m in re.finditer(r"__fmaf_rn\(", body)]
    if not hits or (only is not None and only >= len(hits)):
        raise SystemExit(f"variant patch no longer matches mirrors.cu: __fmaf_rn call {only} of {fn}")
    for k in reversed(range(len(hits))):
        if only is None or k == only:
            body = body[:hits[k]] + "fma32(" + body[hits[k] + len("__fmaf_rn("):]
    out = src[:start] + body + src[end:]
    return out if INCLUDE in out else replaced(out, ANCHOR, INCLUDE)


def replaced(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"variant patch no longer matches mirrors.cu: {old!r}")
    return src.replace(old, new)


def site_count(src: str, fn: str) -> int:
    start, end = _body(src, fn)
    return len(re.findall(r"__fmaf_rn\(", src[start:end]))


def variants(src: str, sites: bool):
    """name -> (source, ops whose bits it must keep, timed)."""
    f64 = f64_sites(f64_sites(src, "L"), "E")
    out = {
        "base": (src, (), True),
        "f64": (f64, ("log", "exp", "pow"), True),
        "f64_reinterp": (replaced(f64, INCLUDE, REINTERP), None, True),
        "nostore": (replaced(src, STORE, NOSTORE), None, True),
    }
    if sites:
        for fn, op in (("L", "log"), ("E", "exp")):
            for k in range(site_count(src, fn)):
                out[f"f64_{fn}{k}"] = (f64_sites(src, fn, k), (op,), False)
    return out


def sass_counts(so: Path):
    """{kernel: {instruction class: count}} of the vectorized pow and exp
    kernels, from cuobjdump's SASS; None without cuobjdump."""
    from retrocapture_tpu_torch.ops.cuda import _build

    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    if not Path(tool).is_file():
        return None
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            name = {"ILi4ELb1E": "pow", "ILi3ELb1E": "exp"}.get(next((k for k in ("ILi4ELb1E", "ILi3ELb1E") if k in fn), ""))
            if name:
                out[name] = dict.fromkeys(("F2F", "DADD", "DMUL", "DFMA", "FADD", "FMUL", "FFMA", "instructions"), 0)
            continue
        if name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            out[name]["instructions"] += 1
            for k in ("F2F", "DADD", "DMUL", "DFMA", "FADD", "FMUL", "FFMA"):
                if re.search(rf"\b{k}\b", line):
                    out[name][k] += 1
    return out


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from retrocapture_tpu_torch.ops.cuda import _build

    if not torch.cuda.is_available():
        raise SystemExit("torch_mirror_kernel_variants: needs an NVIDIA GPU")
    sites = "--sites" in sys.argv[1:]
    src = (_build.CSRC / "mirrors.cu").read_text()
    out_dir = _build.BUILD_DIR / "mirror_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = variants(src, sites)
    procs = {}
    t0 = time.perf_counter()
    for name, (text, _, _) in todo.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.EXTRA_FLAGS["mirrors"], "-o",
               str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, record = {}, {"card": torch.cuda.get_device_name(0), "variants": {}}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(out_dir / f"{name}.so")), _build.KERNELS["mirrors"][0])
        fn.argtypes = _build.KERNELS["mirrors"][1]
        fns[name] = fn
        record["variants"][name] = {"sass": sass_counts(out_dir / f"{name}.so")}
        print(f"{name}: SASS {record['variants'][name]['sass']}", flush=True)
    print(f"built {len(fns)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    record["nvidia_smi"] = smi
    print(smi, flush=True)

    dev = "cuda"
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, x, op, c=0.0, out=None):
        out = torch.empty_like(x) if out is None else out
        rc = fns[name](x.data_ptr(), out.data_ptr(), x.numel(), OPS[op], c, stream)
        if rc:
            raise SystemExit(f"variant {name}: cudaError {rc}")
        return out

    def same_bits(got, want):
        wn = torch.isnan(want)
        bad = (torch.isnan(got) != wn) | ((got.view(torch.int32) != want.view(torch.int32)) & ~wn)
        return bad

    def pow_c(p):
        return float(np.float32(np.float32(np.float32(p) * np.float32(1.0 / np.log(2.0))) * np.float32(np.log(2.0))))

    # Bits: every pattern of each op a variant changes, against base.
    gen = torch.Generator(device=dev)
    for name, (_, keeps, _) in todo.items():
        if not keeps:
            continue
        diffs = {}
        for op in keeps:
            if op == "pow":
                n_bad, first = 0, []
                for p in POW_EXPONENTS:
                    gen.manual_seed(int(p * 100))
                    x = torch.randint(-2**31, 2**31 - 1, (1 << 26,), generator=gen, device=dev, dtype=torch.int32)
                    x = x.view(torch.float32)
                    bad = same_bits(run(name, x, "pow", pow_c(p)), run("base", x, "pow", pow_c(p)))
                    n_bad += int(bad.sum())
                    first += [f"{p}:{v:#010x}" for v in x.view(torch.int32)[bad][:4].tolist()]
                diffs["pow"] = {"patterns": len(POW_EXPONENTS) << 26, "differ": n_bad, "first": first[:8]}
                continue
            n_bad, first = 0, []
            for s in range(0, 1 << 32, CHUNK):
                x = torch.arange(s - 2**31, s - 2**31 + CHUNK, dtype=torch.int64, device=dev).to(torch.int32)
                x = x.view(torch.float32)
                bad = same_bits(run(name, x, op), run("base", x, op))
                k = int(bad.sum())
                if k:
                    n_bad += k
                    first += [f"{v & 0xffffffff:#010x}" for v in x.view(torch.int32)[bad][:4].tolist()]
            diffs[op] = {"patterns": 1 << 32, "differ": n_bad, "first": first[:8]}
        record["variants"][name]["differ_from_base"] = diffs
        print(f"{name}: results that differ from base: "
              + "; ".join(f"{op} {d['differ']} of {d['patterns']} {d['first']}" for op, d in diffs.items()), flush=True)
    del x
    torch.cuda.empty_cache()

    # Time: the two main calls, two rounds in turns.
    gen.manual_seed(5)
    calls = {
        "pow 0.45": (torch.rand(POW_SHAPE, generator=gen, device=dev) * 1.2, "pow", pow_c(0.45)),
        "exp": (torch.randn(EXP_SHAPE, generator=gen, device=dev) * 4.0, "exp", 0.0),
    }

    def event_ms(fn):
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / ITERS

    timed = [n for n, (_, _, t) in todo.items() if t]
    for call, (x, op, c) in calls.items():
        out = torch.empty_like(x)
        want = run("base", x, op, c)
        for rnd in range(2):
            times = {}
            for name in (timed if rnd == 0 else timed[::-1]):
                times[name] = event_ms(lambda: run(name, x, op, c, out))
                if name in ("base", "f64") and not torch.equal(out, want):
                    raise SystemExit(f"variant {name} wrote other bytes than base at {call}")
            if call == "pow 0.45":
                times["copy_"] = event_ms(lambda: out.copy_(x))
            record.setdefault("ms", {})[f"{call} {list(x.shape)} round {rnd}"] = times
            print(f"{call} {list(x.shape)} round {rnd}: " + "; ".join(f"{n} {t:.4f} ms" for n, t in times.items()),
                  flush=True)
        del out, want
    out_path = REPO / "chiprun_out" / "mirror_variants.json"
    out_path.parent.mkdir(exist_ok=True)
    out_path.write_text(json.dumps(record, indent=1))
    print(f"wrote {out_path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
