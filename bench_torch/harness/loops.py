"""The two loops that drive the system: a closed loop of batches through
the frame queue, and an open loop of single frames on a schedule.

Both count frames from the first one the engine sees (warm-up included),
so that frame ``g`` is ``FrameSource.frames(g)`` with FrameCount ``g``;
both keep a copy of every answer the seed samples inside the window, for
the comparison after it. ``hooks`` (``Hooks``) is told when the window is
about to open, opens and closes: the peak-memory reset and the profiler
hang there. All times are the host's clock (``time.perf_counter``).
"""

from __future__ import annotations

import itertools
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from harness.trace import host_range

clock = time.perf_counter


class Hooks:
    """What happens as the window opens and closes (nothing, by default)."""

    traced = False

    def prepare(self) -> None:
        pass

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass


@dataclass
class Window:
    """What one measured window saw."""

    t0: float  # host clock as it opened
    seconds: float  # its length
    frames: int  # frames delivered (closed loop) or due (open loop) in it
    batches: int  # applies in it
    next_frame: int  # the first frame the engine has not seen
    kept: dict = field(default_factory=dict)  # frame -> its u8 answer
    spans: dict = field(default_factory=lambda: defaultdict(list))  # name -> seconds, each time in the window
    latency_s: list = field(default_factory=list)  # open loop: due -> answer on the host
    late_s: list = field(default_factory=list)  # open loop: due -> call


def closed(stream, process, src, batch: int, seconds: float, g0: int, warm: int, hooks: Hooks) -> Window:
    """``warm`` batches, then a window of ``seconds``: batches of ``batch``
    frames from ``src`` through ``stream(frames, process, batch)``, the
    next taken as the queue asks for it. The window opens as batch
    ``warm`` comes back and closes at the first batch back after
    ``seconds``; it holds the batches that came back in between, so its
    rate is frames over time with no partial batch. The batches still in
    flight are then drained."""
    stop = False
    win = Window(0.0, 0.0, 0, 0, g0)
    opened = closed_at = None

    def source():
        g = g0
        while not stop:
            t = clock()
            with host_range("bench.producer", hooks.traced):
                frames = src.frames(g, batch)
            if opened is not None and closed_at is None:
                win.spans["producer"].append(clock() - t)
            g += batch
            yield from frames

    def timed(b):
        t = clock()
        with host_range("bench.process", hooks.traced):
            out = process(b)
        if opened is not None and closed_at is None:
            win.spans["process"].append(clock() - t)
        return out

    first = g0 + warm * batch
    frames = iter(stream(source(), timed, batch))
    for g in itertools.count(g0):
        with host_range("bench.queue", hooks.traced):
            frame = next(frames, None)
        if frame is None:
            break
        if (g - g0) % batch == 0:
            now = clock()
            k = (g - g0) // batch
            if k == warm - 1:
                hooks.prepare()
            elif k == warm:
                hooks.open()
                opened = win.t0 = clock()
            elif opened is not None and closed_at is None and now - opened >= seconds:
                closed_at = now
                hooks.close()
                win.seconds = now - opened
                win.frames = g - first
                win.batches = win.frames // batch
                stop = True
        if opened is not None and closed_at is None and src.is_sampled(g):
            win.kept[g] = np.array(frame)
        win.next_frame = g + 1
    return win


def open_loop(call, src, seconds: float, g0: int, warm: int, hooks: Hooks) -> Window:
    """``warm`` frames, then frame ``i`` of the window due at ``i /
    src.rate_hz`` after it opens, through ``call(frame)`` one at a time.
    A frame's latency runs from its due time to its answer on the host, so
    a stall makes every frame behind it late as well; ``late_s`` keeps how
    late each call started."""
    for g in range(g0, g0 + warm):
        call(src.frame(g))
    first = g0 + warm
    n = int(round(seconds * src.rate_hz))
    win = Window(0.0, 0.0, n, n, first + n)
    frame = src.frame(first)
    hooks.prepare()
    hooks.open()
    t0 = win.t0 = clock()
    for i in range(n):
        due = t0 + src.due(i)
        # The generator spins to the due time: a sleep's wake-up, late by
        # milliseconds on a busy host, would count against the system.
        with host_range("bench.wait", hooks.traced):
            while clock() < due:
                pass
        start = clock()
        with host_range("bench.call", hooks.traced):
            out = call(frame)
        done = clock()
        win.latency_s.append(done - due)
        win.late_s.append(start - due)
        win.spans["call"].append(done - start)
        g = first + i
        if src.is_sampled(g):
            win.kept[g] = out
        frame = src.frame(g + 1)
    win.seconds = clock() - t0
    hooks.close()
    return win
