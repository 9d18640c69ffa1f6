"""Rehearse every cell of BENCHMARK.json on the CPU, at a tiny size.

    python3 bench_torch/rehearse.py [--seconds S] [workload ...]

Each cell runs its own control flow (the engine, the frame queue or the
open loop, the warm-up, the window, the sample and its comparison with
the plain reference) on the CPU, where the program takes its kernels'
plain versions, at the size its configuration names under ``rehearse``.
It prints each cell's verdict and compared numbers and never a device
metric: a time or a rate of a CPU run says nothing of the card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness.cell import run_cell  # noqa: E402
from harness.spec import load_benchmark, resolve  # noqa: E402


def rehearse(name: str, seconds: float, seed: int = 1) -> dict:
    tiny = resolve(name).config["rehearse"]
    cell = resolve(name, config=tiny, traffic={"sample_every": 2})
    out = run_cell(cell, seed, seconds, False, device="cpu")
    return {"workload": name, "correct": out["correct"], "attempted": out["attempted"], "compared": out["compared"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("workloads", nargs="*")
    args = ap.parse_args(argv)
    names = args.workloads or [w["name"] for w in load_benchmark()["workloads"]]
    ok = True
    for name in names:
        r = rehearse(name, args.seconds)
        ok &= r["correct"]
        print(r, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
