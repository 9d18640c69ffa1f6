"""Reading the device's work from ``torch.profiler`` over a traced window.

The profiler runs over the whole measured window of a ``--trace 1`` run.
Its device records (kernels, copies, fills) give the device's busy time
(the union of their intervals inside the window), each kernel's time by
name, and the idle gaps; its host records (the benchmark's own spans and
the program's operators) name what the host was doing in each gap.

A window on the card was seen to come back with no device record at
all, and to lose its last record when the profiler stops. A short spin
kernel stands last and is left out, and a window with no device record is
run again, ``PROFILE_TRIES`` in all.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

PROFILE_TRIES = 4
_SPIN = "spin_kernel"  # the kernel of torch.cuda._sleep
_SPIN_CYCLES = 1_000_000  # about 0.5 ms at the H100's SM clock
WINDOW = "bench.window"
NAME_CHARS = 200  # a device operation's name as the breakdown gives it


@dataclass
class DeviceTrace:
    """The device records of one traced window, in seconds from its start."""

    window_s: float
    records: list  # (name, start_s, duration_s), clipped to the window
    host: list = field(default_factory=list)  # (name, start_s, end_s) host ranges in the window

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in self.busy_intervals())

    def busy_intervals(self):
        spans = sorted((s, s + d) for _, s, d in self.records)
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def kernel_s(self, part: str) -> list:
        """Durations of the records whose name holds ``part``."""
        return [d for n, _, d in self.records if part in n]

    def top_ops(self, n: int = 10):
        """The ``n`` operations that took the most device time, by name
        (the name cut to ``NAME_CHARS``)."""
        totals: dict = {}
        for name, _, d in self.records:
            totals[name] = totals.get(name, 0.0) + d
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:NAME_CHARS], v] for k, v in top]

    def idle_gaps(self, n: int = 10):
        """The longest stretches with nothing on the device, each named by
        the innermost host range open at its middle."""
        busy = self.busy_intervals()
        edges = [0.0] + [x for ab in busy for x in ab] + [self.window_s]
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
        gaps.sort(key=lambda ab: ab[0] - ab[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            inside = [(e - s, name) for name, s, e in self.host if s <= mid < e]
            out.append([min(inside)[1] if inside else "host outside any range", b - a])
        return out


class Profiler:
    """``torch.profiler`` over a window: ``start`` before it opens,
    ``open`` as it opens, ``close`` as it closes; ``trace()`` then."""

    def __init__(self):
        self._prof = None
        self._range = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()

    def open(self) -> None:
        import torch

        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def close(self) -> None:
        import torch

        self._range.__exit__(None, None, None)
        torch.cuda.synchronize()
        torch.cuda._sleep(_SPIN_CYCLES)
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)

    def trace(self):
        """The window's DeviceTrace, or None where the profiler recorded
        no device work in it."""
        from torch.autograd import DeviceType

        events = self._prof.events()
        win = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
        if not win:
            return None
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        ranges = {e.name for e in events if getattr(e, "is_user_annotation", False)} | {WINDOW}
        records, host = [], []
        for e in events:
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t <= s:
                continue
            if e.device_type != DeviceType.CUDA:
                if e.name != WINDOW:
                    host.append((e.name, (s - w0) * 1e-6, (t - w0) * 1e-6))
            elif not (getattr(e, "is_user_annotation", False) or e.name in ranges or _SPIN in e.name):
                # A host range is mirrored on the device's timeline as a user
                # annotation: it is no work of the device.
                records.append((e.name, (s - w0) * 1e-6, (t - s) * 1e-6))
        if not records:
            return None
        return DeviceTrace((w1 - w0) * 1e-6, records, host)


@contextlib.contextmanager
def host_range(name: str, traced: bool):
    """A named host range in the trace (nothing when untraced)."""
    if not traced:
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield
