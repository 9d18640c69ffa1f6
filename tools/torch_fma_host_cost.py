#!/usr/bin/env python3
"""Host cost of the multiply-add operator ``rctpu::fma`` on the card.

    python3 tools/torch_fma_host_cost.py    (needs an NVIDIA GPU and nvcc)

The kernel saves device time and bytes, but each call costs host time,
where ``policy.fma32`` enqueues a few eager torch passes. This measures
both sides:

* host microseconds a call, with no synchronize in the loop, of
  ``fma.fma32`` (the public wrapper: its direct route on a plain call),
  ``fma._fma_op`` (the operator, through ``torch.library``'s dispatcher)
  and ``fma._launch`` (the launch alone), against ``policy.fma32``, on a
  small operand ([120, 160, 3]: the device is not the limit) and on the
  FramePipeline blit's ([1080, 1440, 3]);
* the split of one call at [120, 160, 3] into its parts, each timed alone
  over many calls: the ``_operand`` checks, the route predicate, the
  launch plan's cache lookup, what a miss costs (``torch.broadcast_shapes``,
  ``_geometry``, ``_classify``), ``torch.empty``, the stream query (the raw
  query the wrapper uses, and ``torch.cuda.current_stream(dev).cuda_stream``),
  the ctypes call of the kernel's entry (its launch included) and the
  dispatcher (the operator less ``_launch``); and the same dispatcher cost
  of the mirror operator ``rctpu::mirror`` (``mirrors._mirror_op`` less
  ``mirrors._launch``, at the same shape);
* ``FramePipeline.process`` of 32 frames, as the card test of the front
  door's stream builds it (feedback-ghost at 160x120, brightness 1.1, contrast 0.9,
  flip-Y, a pillarboxed 1920x1080 window), with a synchronize, in turns:
  as shipped, and with ``policy.fma32``/``fmaf32`` put back into the four
  modules that call the operator; each with its device busy time
  (torch.profiler) and its ten costliest host operations.

Prints one JSON object and writes it to ``chiprun_out/fma_host_cost.json``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from retrocapture_tpu_torch import Engine, policy  # noqa: E402
from retrocapture_tpu_torch.frontend import builtins  # noqa: E402
from retrocapture_tpu_torch.graph import kernels  # noqa: E402
from retrocapture_tpu_torch.io.testpattern import TestPatternSource  # noqa: E402
from retrocapture_tpu_torch.ops import sampling  # noqa: E402
from retrocapture_tpu_torch.ops.cuda import fma as fm  # noqa: E402
from retrocapture_tpu_torch.runtime import pipeline  # noqa: E402

DEV = "cuda"
CALLS = 2000
ROUNDS = 3
PROCESS_RUNS = 5
CALLERS = (builtins, sampling, kernels, pipeline)


def host_us(fn, calls=CALLS):
    """Host microseconds a call over ``calls`` calls, the device drained
    before and not waited for inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def split_table():
    """Host microseconds of each part of one ``fma.fma32(x, 1.1, -0.5)`` call
    at [120, 160, 3], each timed alone (median of ROUNDS)."""
    from retrocapture_tpu_torch.ops.cuda import _build
    from retrocapture_tpu_torch.ops.cuda import mirrors as mr

    x = torch.rand((120, 160, 3), device=DEV)
    ops = (x, None, None)
    shape = tuple(x.shape)
    plan = fm._plan(ops)
    sizes, strides = fm._geometry(shape, ops)
    fn = _build.load("fma")
    out = torch.empty(plan.shape, device=DEV)
    dev = x.device
    raw = torch._C._cuda_getCurrentRawStream
    stream = raw(dev.index)
    parts = {
        "_operand checks": lambda: (fm._operand(x, "a"), fm._operand(1.1, "b"), fm._operand(-0.5, "c")),
        "route predicate": lambda: fm._direct(ops),
        "plan cache lookup": lambda: fm._plan(ops),
        "torch.broadcast_shapes (a plan miss)": lambda: torch.broadcast_shapes(x.shape),
        "_geometry (a plan miss)": lambda: fm._geometry(shape, ops),
        "_classify (a plan miss)": lambda: fm._classify(sizes, strides, [True, False, False]),
        "torch.empty": lambda: torch.empty(plan.shape, dtype=torch.float32, device=dev),
        "stream, raw query": lambda: raw(dev.index),
        "stream, torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ctypes call and launch": lambda: fn(x.data_ptr(), None, None, 0.0, 1.1, -0.5, out.data_ptr(), plan.path,
                                             plan.geometry, 0, stream),
        "fma._launch": lambda: fm._launch(x, None, None, 0.0, 1.1, -0.5, 0),
        "fma._fma_op": lambda: fm._fma_op(x, None, None, 0.0, 1.1, -0.5, 0),
        "fma.fma32": lambda: fm.fma32(x, 1.1, -0.5),
        "mirrors._launch": lambda: mr._launch(x, "sin", 0.0),
        "mirrors._mirror_op": lambda: mr._mirror_op(x, "sin", 0.0),
    }
    rounds = {k: [] for k in parts}
    for _ in range(ROUNDS):
        for k, f in parts.items():
            rounds[k].append(host_us(f))
    out_us = {k: sorted(v)[len(v) // 2] for k, v in rounds.items()}
    out_us["dispatcher (fma._fma_op less fma._launch)"] = out_us["fma._fma_op"] - out_us["fma._launch"]
    out_us["mirror dispatcher (mirrors._mirror_op less mirrors._launch)"] = (
        out_us["mirrors._mirror_op"] - out_us["mirrors._launch"])
    return out_us


def calls_table():
    out = {}
    for shape in ((120, 160, 3), (1080, 1440, 3)):
        x = torch.rand(shape, device=DEV)
        n = CALLS if shape[0] < 1000 else CALLS // 10
        sides = {
            "fma.fma32": lambda: fm.fma32(x, 1.1, -0.5),
            "fma._fma_op": lambda: fm._fma_op(x, None, None, 0.0, 1.1, -0.5, 0),
            "fma._launch": lambda: fm._launch(x, None, None, 0.0, 1.1, -0.5, 0),
            "policy.fma32": lambda: policy.fma32(x, 1.1, -0.5),
        }
        rounds = {k: [] for k in sides}
        for _ in range(ROUNDS):
            for k, fn in sides.items():
                rounds[k].append(host_us(fn, n))
        out[str(list(shape))] = {k: sorted(v)[len(v) // 2] for k, v in rounds.items()}
    return out


class plain_routing:
    """policy's fma32 / fmaf32 in the operator's callers for a block."""

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m in CALLERS for n in ("fma32", "fmaf32") if hasattr(m, n)]
        for m, n, _ in self.saved:
            setattr(m, n, getattr(policy, n))

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def process_table():
    e = Engine(device=DEV)
    assert e.load_preset(str(REPO / "assets" / "presets" / "feedback-ghost.glslp")), e.last_error
    p = pipeline.FramePipeline(
        e, logical_resolution=(160, 120), overscan_percent=(2.0, 2.0), window=(1920, 1080),
        image=pipeline.ImageSettings(brightness=1.1, contrast=0.9, flip_y=True, maintain_aspect=True),
    )
    src = TestPatternSource(320, 240)
    batch = torch.from_numpy(np.stack([src.capture_frame() for _ in range(32)])).to(DEV)
    sides = {"operator": contextlib.nullcontext, "policy": plain_routing}
    walls = {k: [] for k in sides}
    for _ in range(PROCESS_RUNS + 1):
        for k, ctx in sides.items():
            with ctx():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p.process(batch)
                torch.cuda.synchronize()
                walls[k].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for k, ctx in sides.items():
        with ctx():
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                p.process(batch)
                torch.cuda.synchronize()
        events = prof.key_averages()
        busy = sum(ev.self_device_time_total for ev in events) / 1e3
        top = sorted(events, key=lambda ev: ev.self_cpu_time_total, reverse=True)[:10]
        w = sorted(walls[k][1:])
        out[k] = {"wall_ms": w, "median_wall_ms": w[len(w) // 2], "device_busy_ms": busy,
                  "top_host_ops": [{"name": ev.key, "calls": ev.count, "self_cpu_ms": ev.self_cpu_time_total / 1e3}
                                   for ev in top]}
    return out


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    result = {"card": card, "host_us_a_call": calls_table(), "split_us_120x160x3": split_table(),
              "framepipeline_process_32": process_table()}
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fma_host_cost.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
