"""Run one cell of BENCHMARK.json once, on one NVIDIA card.

    python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared`` (each number compared with the plain
reference, beside its limit); the compared numbers are also the last
lines of standard error. Exits non-zero, printing no result, where
``torch.cuda`` finds no card or fewer than the cell asks for.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        since = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        since = 0.0
    return time.perf_counter() - since


PROC_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Every cache of a run stays inside the checkout, at a fixed path: the
# kernels' build (build/kernels, fixed by the program) and CUDA's own.
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda-cache")
sys.path.insert(0, str(BENCH))


def _power_limit() -> str:
    """The card's power limit as nvidia-smi reads it ("" where it cannot)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.spec import resolve

    cell = resolve(args.workload)

    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {chips} CUDA device(s), torch.cuda finds {n}", file=sys.stderr)
        return 3

    from harness.cell import run_cell

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda", proc_start=PROC_START)
    out["device"]["power_limit"] = _power_limit()
    out["compared"] = out.pop("compared")  # the compared numbers come last
    for name, row in out["compared"].items():
        print(f"compared {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
