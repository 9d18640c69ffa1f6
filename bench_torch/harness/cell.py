"""One run of one cell: set-up, the measured window, the comparison, and
the result line's contents.

``run_cell`` does everything but the check for a card, so that the CPU
rehearsal and the tests drive the same code at a tiny size (``device``
"cpu", the kernels' plain versions); ``wrap`` lets a test break the
timed path underneath.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from harness import compare, loops, peaks, system
from harness.frames import FrameSource
from harness.spec import Cell
from harness.trace import PROFILE_TRIES, DeviceTrace, Profiler


@dataclass
class Readings:
    """What a metric's reader reads (``metrics/<name>.py``: ``read(r)``,
    a number, or None where it finds nothing to read)."""

    cell: Cell
    window: loops.Window
    setup_s: float
    peak_bytes: int  # the window's device memory peak
    counters: dict  # Engine.replay_stats()
    trace: Optional[DeviceTrace]  # the traced window's device records

    @property
    def closed_loop(self) -> bool:
        return self.cell.traffic["loop"] == "closed"

    def bound_ms(self, kernel: str) -> float:
        """The least time of ``kernel``'s work over one apply of the
        cell's batch at its shapes (``work/<kernel>.py``)."""
        vw, vh = self.cell.viewport
        return peaks.bound(*self.cell.work(kernel).work(self.cell.batch, self.cell.src_hw, (vh, vw)))[0]


class _Hooks(loops.Hooks):
    def __init__(self, device: str, traced: bool):
        self.card = torch.device(device).type == "cuda"
        self.traced = traced
        self.profiler = Profiler() if traced else None
        self.warm_peak = 0

    def prepare(self) -> None:
        if self.profiler:
            self.profiler.start()

    def open(self) -> None:
        if self.card:
            torch.cuda.synchronize()
            self.warm_peak = max(self.warm_peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        if self.profiler:
            self.profiler.open()

    def close(self) -> None:
        if self.profiler:
            self.profiler.close()


def _window(cell: Cell, e, src, seconds: float, g0: int, hooks, device: str, wrap):
    traffic = cell.traffic
    warm = int(traffic["warm"])
    if traffic["loop"] == "closed":
        process = lambda b: e.apply(b, output="u8")  # noqa: E731
        process = wrap(process, e) if wrap else process
        stream = lambda frames, proc, batch: system.stream(frames, proc, batch, device)  # noqa: E731
        return loops.closed(stream, process, src, cell.batch, seconds, g0, warm, hooks)
    call = e.apply_u8
    call = wrap(call, e) if wrap else call
    return loops.open_loop(call, src, seconds, g0, warm, hooks)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             proc_start: float = 0.0, wrap: Optional[Callable] = None) -> dict:
    """Run the cell once; the result line's contents (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with ``trace``
    ``breakdown``, and last ``compared``)."""
    card = torch.device(device).type == "cuda"
    t_start = loops.clock()
    src = FrameSource(cell.traffic, cell.src_hw, seed)
    e = system.engine(cell, device)
    t_engine = loops.clock()
    hooks = _Hooks(device, trace)
    win = _window(cell, e, src, seconds, 0, hooks, device, wrap)
    setup_s = win.t0 - proc_start
    warm_peak = hooks.warm_peak
    dtrace = hooks.profiler.trace() if trace else None
    for _ in range(PROFILE_TRIES - 1):
        if not trace or dtrace is not None:
            break
        hooks = _Hooks(device, trace)
        win = _window(cell, e, src, seconds, win.next_frame, hooks, device, wrap)
        dtrace = hooks.profiler.trace()
    if card:
        torch.cuda.synchronize()
        window_peak = torch.cuda.max_memory_allocated()
        process_peak = max(warm_peak, hooks.warm_peak, window_peak)
    else:
        window_peak = process_peak = 0
    counters = e.replay_stats()
    if compare.is_stateful(cell.reference()) and counters.get("frames") != win.next_frame:
        # A stateful reference replays frames 0 .. g; the engine has to have
        # run exactly those, in one unbroken sequence.
        raise RuntimeError(f"the engine ran {counters.get('frames')} frames, the loops handed it "
                           f"{win.next_frame}: no unbroken sequence to replay")
    del e
    gc.collect()
    if card:
        torch.cuda.empty_cache()

    t = loops.clock()
    numbers = compare.compare(cell, src, win.kept, device)
    reference_s = loops.clock() - t
    correct, rows = compare.verdict(numbers, cell.config["compare"])
    if trace and dtrace is None:
        raise RuntimeError(f"torch.profiler recorded no device work in {PROFILE_TRIES} windows")

    r = Readings(cell, win, setup_s, window_peak, counters, dtrace)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cell.reader(m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {
        "platform": "gpu" if card else "cpu",
        "kind": torch.cuda.get_device_name(0) if card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(process_peak),
    }
    out = {"correct": correct, "attempted": win.frames, "failed": 0, "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy_s()
        dev["window_s"] = dtrace.window_s
        out["breakdown"] = {"device_ops": dtrace.top_ops(), "idle_gaps": dtrace.idle_gaps()}
    # Read by no metric, kept for PERF.md: the reference's time, how late
    # the open loop's generator called, and where set-up went.
    out["reference_s"] = reference_s
    if win.late_s:
        out["late_ms"] = {"p50": percentile(win.late_s, 50) * 1e3, "p99": percentile(win.late_s, 99) * 1e3}
    out["setup_parts_s"] = {"before_cell": t_start - proc_start, "engine": t_engine - t_start,
                            "warm": win.t0 - t_engine if not trace else None}
    out["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return out


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values`` (numpy's linear rule)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
