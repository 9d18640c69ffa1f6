"""The two readings that each compared number's limit is set between.

    python3 bench_torch/calibrate.py --workload <name> [--seeds 1 2 ...] [--control-seeds ...] [--seconds S] [--frames N]

* The program's readings: the cell run once a seed (``run_cell``, the
  benchmark's own code path, a short window at the cell's own load), each
  compared number of each run.
* The control's: the plain reference computed in the precision below the
  one the configuration states (bfloat16 for float32), put in the
  program's place (``compare.rendered``, so a stateful reference replays
  from frame 0 here too): its answers for the frames a run of that seed samples,
  held to the float32 reference by the same numbers (over the frames
  that a run spanning ``--frames`` frames samples, or as many as the
  first program run of this call delivered).

Every run of one cell in one process; the readings go to standard output
as JSON lines and to ``chiprun_out/calibrate-<workload>.json``. The
benchmark's runs never run this. ``--cpu`` runs it at the configuration's
``rehearse`` size on the CPU (the tests do).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import compare  # noqa: E402
from harness.cell import run_cell  # noqa: E402
from harness.frames import FrameSource  # noqa: E402
from harness.spec import ROOT, resolve  # noqa: E402

LOWER = {"float64": torch.float32, "float32": torch.bfloat16}  # the precision the control computes in


def control_numbers(cell, seed: int, frames, device) -> dict:
    """The control's compared numbers over ``frames`` of seed ``seed``."""
    src = FrameSource(cell.traffic, cell.src_hw, seed)
    low = LOWER[cell.config["precision"]]
    kept = {g: want.cpu() for g, want in compare.rendered(cell, src, frames, low, device)}
    return compare.compare(cell, src, kept, device)


def sampled_frames(cell, seed: int, first: int, count: int) -> list:
    """The frames among ``first .. first + count - 1`` that seed ``seed`` samples."""
    src = FrameSource(cell.traffic, cell.src_hw, seed)
    return [g for g in range(first, first + count) if src.is_sampled(g)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    cell = resolve(args.workload)
    if args.cpu:
        cell = resolve(args.workload, config=cell.config["rehearse"], traffic={"sample_every": 2})
    rows = []
    for seed in args.seeds:
        out = run_cell(cell, seed, args.seconds, False, device=device)
        row = {"kind": "program", "seed": seed, "correct": out["correct"], "attempted": out["attempted"],
               **{k: v["value"] for k, v in out["compared"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    for seed in args.control_seeds:
        n = args.frames or (rows[0]["attempted"] if rows else 64)
        frames = sampled_frames(cell, seed, int(cell.traffic["warm"]) * cell.batch, n)
        row = {"kind": "control", "seed": seed, **control_numbers(cell, seed, frames, device)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"calibrate-{args.workload}.json").write_text(json.dumps(rows, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
