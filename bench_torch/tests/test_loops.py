"""The generator and the two loops, with fakes in place of the program."""

import numpy as np
import pytest

from harness import loops
from harness.frames import FrameSource
from harness.spec import resolve


@pytest.mark.parametrize("mix", ["offline", "live"])
def test_one_seed_gives_the_same_frames_and_due_times(mix):
    traffic = resolve(f"crt-mattias-1080p.{mix}").traffic
    a, b = FrameSource(traffic, (24, 32), 2**31 + 12345), FrameSource(traffic, (24, 32), 2**31 + 12345)
    other = FrameSource(traffic, (24, 32), 2**31 + 12346)
    assert np.array_equal(a.frames(0, 300), b.frames(0, 300))
    assert not np.array_equal(a.frames(0, 300), other.frames(0, 300))
    assert np.array_equal(a.sampled, b.sampled) and not np.array_equal(a.sampled, other.sampled)
    if traffic["loop"] == "open":
        assert [a.due(i) for i in range(100)] == [b.due(i) for i in range(100)] == [i / 60 for i in range(100)]


def test_no_two_frames_of_a_run_alike():
    src = FrameSource(resolve("crt-mattias-1080p.offline").traffic, (24, 32), 7)
    frames = src.frames(0, 4000).reshape(4000, -1)
    assert len({f.tobytes() for f in frames}) == 4000


def test_open_loop_times_from_the_due_time():
    """A fake engine that stalls once makes every later frame late by the
    stall, until the schedule is caught up."""
    src = FrameSource(dict(resolve("crt-mattias-1080p.live").traffic, rate_hz=100), (8, 8), 3)
    calls = []

    def call(frame):
        calls.append(frame)
        if len(calls) == 3 + 11:  # the window's frame 10 (after 3 warm frames)
            loops.time.sleep(0.055)
        return frame

    win = loops.open_loop(call, src, 0.4, 0, 3, loops.Hooks())
    lat = np.array(win.latency_s)
    assert len(lat) == 40 and win.frames == 40
    assert np.all(lat[:10] < 0.02)
    # The stall (55 ms) spans five 10 ms periods: frames 11-15 start late by
    # what is left of it, in steps of one period.
    for k in range(1, 5):
        assert lat[10 + k] == pytest.approx(0.055 - 0.01 * k, abs=0.008)
    assert np.all(lat[16:] < 0.02)


def test_closed_loop_counts_whole_batches():
    src = FrameSource(resolve("crt-mattias-1080p.offline").traffic, (8, 8), 5)

    def stream(frames, process, batch):
        buf = []
        for f in frames:
            buf.append(f)
            if len(buf) == batch:
                loops.time.sleep(0.002)
                yield from process(np.stack(buf))
                buf.clear()

    win = loops.closed(stream, lambda b: b, src, 4, 0.1, 0, 3, loops.Hooks())
    assert win.frames % 4 == 0 and win.frames == 4 * win.batches > 0
    assert win.seconds >= 0.1
    assert all(np.array_equal(v, src.frame(g)) for g, v in win.kept.items())
