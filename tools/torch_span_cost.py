#!/usr/bin/env python3
"""Host cost of one of the port's named spans (``utils/trace.span``).

    python3 tools/torch_span_cost.py [--calls N]

Times, in microseconds a span (enter and exit, host clock, best of 5
rounds of N calls):

* ``off``: ``span`` with no profiler recording (the flag test and the
  shared no-op), what every untraced run pays;
* ``bare_off``: ``torch.profiler.record_function`` with no profiler
  recording, what an ungated span would cost;
* ``on``: ``span`` while ``torch.profiler`` records (CPU activity, and
  CUDA's where there is a card), what a traced run pays.

Prints one JSON object, with the card's name and power limit where there
is a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from retrocapture_tpu_torch.utils.trace import span  # noqa: E402


def _per_call_us(make, calls: int) -> float:
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(calls):
            with make("rctpu.cost"):
                pass
        best = min(best, time.perf_counter() - t)
    return best / calls * 1e6


def _card() -> dict:
    if not torch.cuda.is_available():
        return {"device": "cpu"}
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        limit = r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        limit = ""
    return {"device": torch.cuda.get_device_name(0), "power_limit": limit}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20_000)
    args = ap.parse_args(argv)
    out = {"calls": args.calls, "torch": torch.__version__, **_card()}
    out["off_us"] = _per_call_us(span, args.calls)
    out["bare_off_us"] = _per_call_us(record_function, args.calls)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities):
        out["on_us"] = _per_call_us(span, args.calls)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
