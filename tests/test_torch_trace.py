"""The port's named spans (utils/trace.py): which ``rctpu.*`` ranges a
``torch.profiler`` trace of the frame queue and the engine holds, how they
nest, how many there are, and that ``span`` costs nothing but a flag test
when no profiler records.

The file imports neither jax nor the JAX package; its ``cuda``-marked case
runs on the card with

    python -m pytest --noconftest tests/test_torch_trace.py -q
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import retrocapture_tpu_torch as torch_pkg
from _host_readback import HostReadback
from retrocapture_tpu_torch.io import queue
from retrocapture_tpu_torch.io.queue import stream
from retrocapture_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEEDBACK = os.path.join(REPO, "assets", "presets", "feedback-ghost.glslp")
CALLER = "test.caller"

PASS_GLSLP = """shaders = 1
shader0 = pass.glsl
filter_linear0 = false
scale_type0 = viewport
scale0 = 1.0
"""

PASS_GLSL = """#if defined(VERTEX)

attribute vec4 VertexCoord;
attribute vec4 TexCoord;
varying vec2 vTexCoord;
uniform mat4 MVPMatrix;

void main()
{
    gl_Position = MVPMatrix * VertexCoord;
    vTexCoord = TexCoord.xy;
}

#elif defined(FRAGMENT)

varying vec2 vTexCoord;
uniform sampler2D Texture;

void main()
{
    gl_FragColor = texture2D(Texture, vTexCoord) * 0.75;
}

#endif
"""


def _traced(fn):
    """``fn()`` under a CPU profiler, inside a range named ``CALLER``; its
    result and the trace's ranges ``(name, start, end)`` of ``rctpu.*`` and
    ``CALLER``, in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            out = fn()
    ranges = [
        (e.name, e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.name.startswith("rctpu.") or e.name == CALLER
    ]
    return out, sorted(ranges, key=lambda r: r[1])


def _count(ranges, name):
    return sum(1 for n, _, _ in ranges if n == name)


def _inside(ranges, inner, outer):
    """Every ``inner`` range lies within some ``outer`` range."""
    outers = [(s, e) for n, s, e in ranges if n == outer]
    return all(any(s <= a and b <= e for s, e in outers) for n, a, b in ranges if n == inner)


def _nothing_inside(ranges, outer):
    """No other ``rctpu.*`` range lies within an ``outer`` range."""
    outers = [(s, e) for n, s, e in ranges if n == outer]
    return not any(
        n.startswith("rctpu.") and n != outer and s <= a and b <= e
        for n, a, b in ranges
        for s, e in outers
    )


def _engine(tmp_path, preset=None, viewport=(32, 24)):
    if preset is None:
        (tmp_path / "pass.glsl").write_text(PASS_GLSL)
        (tmp_path / "pass.glslp").write_text(PASS_GLSLP)
        preset = str(tmp_path / "pass.glslp")
    e = torch_pkg.Engine(viewport=viewport, device="cpu")
    assert e.load_preset(preset), e.last_error
    return e


def _frames(n, hw=(12, 16), seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n,) + hw + (3,), dtype=np.uint8)


# -- the gate ---------------------------------------------------------------
def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with no profiler recording")

    monkeypatch.setattr(trace, "record_function", refuse)
    first, second = trace.span("rctpu.a"), trace.span("rctpu.b")
    assert first is second is trace._OFF
    with first:
        pass


def test_span_under_a_profiler_records_its_name():
    _, ranges = _traced(lambda: _enter_exit("rctpu.test"))
    assert _count(ranges, "rctpu.test") == 1
    assert _inside(ranges, "rctpu.test", CALLER)
    assert trace.span("rctpu.test") is trace._OFF  # the profiler has stopped


def _enter_exit(name):
    with trace.span(name):
        pass


# -- the frame queue ----------------------------------------------------------
@pytest.mark.parametrize("n,batch", [(12, 4), (10, 4)], ids=["whole", "tail"])
def test_queue_spans_on_the_cpu(n, batch):
    frames = [f for f in _frames(n)]
    out, ranges = _traced(lambda: list(stream(iter(frames), lambda b: b + 1, batch=batch, device="cpu")))
    assert len(out) == n
    batches = -(-n // batch)
    assert _count(ranges, "rctpu.queue.stack") == batches
    assert _count(ranges, "rctpu.queue.upload") == batches
    assert _count(ranges, "rctpu.queue.readback") == batches + 1  # every submission and the flush
    assert _count(ranges, "rctpu.queue.copy_out") == batches  # one a batch returned
    # On the CPU nothing waits for a device.
    assert _count(ranges, "rctpu.queue.upload_wait") == _count(ranges, "rctpu.queue.readback_wait") == 0
    for name in ("rctpu.queue.stack", "rctpu.queue.upload", "rctpu.queue.readback"):
        assert _inside(ranges, name, CALLER), name
    assert _inside(ranges, "rctpu.queue.copy_out", "rctpu.queue.readback")


def test_handout_spans_inside_copy_out(monkeypatch):
    """The lent readback path (CPU tensors through tests/_host_readback.py),
    the caller keeping every frame: each batch handed out opens one
    ``copy_out`` and inside it one ``handout`` (lent) or ``copy_held``
    (copied at the cap)."""
    monkeypatch.setattr(queue, "DeviceReadback", HostReadback)
    frames = [f for f in _frames(4 * (queue.HELD + 2))]
    out, ranges = _traced(lambda: list(stream(iter(frames), lambda b: b + 1, batch=4, device="cpu")))
    np.testing.assert_array_equal(np.stack(out), np.stack(frames) + 1)
    batches = queue.HELD + 2
    assert _count(ranges, "rctpu.queue.copy_out") == batches
    assert _count(ranges, "rctpu.queue.handout") == queue.HELD - 1  # the first two and the flush's
    assert _count(ranges, "rctpu.queue.copy_held") == batches - (queue.HELD - 1)
    for name in ("rctpu.queue.handout", "rctpu.queue.copy_held"):
        assert _inside(ranges, name, "rctpu.queue.copy_out"), name
        assert _nothing_inside(ranges, name), name


# -- the engine ---------------------------------------------------------------
def test_engine_apply_u8_spans(tmp_path):
    e = _engine(tmp_path)
    frames = _frames(2)
    (first, second), ranges = _traced(lambda: (e.apply_u8(frames), e.apply_u8(frames)))
    np.testing.assert_array_equal(first, second)
    assert first.dtype == np.uint8 and first.shape == (2, 24, 32, 3)
    for name in ("rctpu.engine.apply_u8", "rctpu.engine.upload", "rctpu.engine.prepare",
                 "rctpu.engine.blit", "rctpu.engine.readback"):
        assert _count(ranges, name) == 2, name
    # The first apply walks and captures; the second replays.
    assert _count(ranges, "rctpu.replay.capture") == 1
    assert _count(ranges, "rctpu.replay.launch") == 1
    assert _count(ranges, "rctpu.engine.apply") == 0
    for name in ("rctpu.engine.upload", "rctpu.engine.prepare", "rctpu.replay.capture",
                 "rctpu.replay.launch", "rctpu.engine.blit", "rctpu.engine.readback"):
        assert _inside(ranges, name, "rctpu.engine.apply_u8"), name
    for name in ("rctpu.replay.capture", "rctpu.replay.launch", "rctpu.engine.readback"):
        assert _nothing_inside(ranges, name), name


def test_engine_apply_u8_output_spans(tmp_path):
    e = _engine(tmp_path)
    frames = _frames(2)
    e.apply(frames, output="u8")
    out, ranges = _traced(lambda: e.apply(torch.from_numpy(frames), output="u8"))
    assert out.dtype == torch.uint8
    assert _count(ranges, "rctpu.engine.apply") == 1
    assert _count(ranges, "rctpu.engine.upload") == 0  # a tensor on the engine's device
    assert _count(ranges, "rctpu.replay.capture") == 0
    for name in ("rctpu.engine.prepare", "rctpu.replay.launch", "rctpu.engine.blit"):
        assert _count(ranges, name) == 1, name
        assert _inside(ranges, name, "rctpu.engine.apply"), name
    assert _count(ranges, "rctpu.engine.readback") == 0
    assert _inside(ranges, "rctpu.engine.apply", CALLER)


def test_engine_spans_once_a_batch_of_a_temporal_chain():
    """feedback-ghost steps frame by frame: one launch span around the
    batch's frame loop, not one a frame."""
    e = torch_pkg.Engine(viewport=(40, 30), device="cpu")
    assert e.load_preset(FEEDBACK), e.last_error
    frames = _frames(3)
    e.apply_u8(frames)
    _, ranges = _traced(lambda: e.apply_u8(frames))
    for name in ("rctpu.engine.apply_u8", "rctpu.engine.prepare", "rctpu.replay.launch",
                 "rctpu.engine.blit", "rctpu.engine.readback"):
        assert _count(ranges, name) == 1, name
    assert _nothing_inside(ranges, "rctpu.replay.launch")


def test_engine_lowering_retry_opens_one_apply_span(tmp_path, monkeypatch):
    """A traced-mode retry runs again inside the first ``apply`` span."""
    e = _engine(tmp_path)
    e.set_param_mode("traced")
    calls = []
    real = e._run_batch

    def fail_once(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("needs a concrete parameter")
        return real(*args, **kwargs)

    monkeypatch.setattr(e, "_run_batch", fail_once)
    out, ranges = _traced(lambda: e.apply(_frames(2), output="u8"))
    assert len(calls) == 2 and out.shape == (2, 24, 32, 3)
    assert _count(ranges, "rctpu.engine.apply") == 1
    assert _count(ranges, "rctpu.engine.upload") == 2  # the retry takes the frames again


# -- the card -----------------------------------------------------------------
@pytest.mark.cuda
def test_queue_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pinned upload and readback wait on its events)")
    frames = [f for f in _frames(20, hw=(64, 64))]
    out, ranges = _traced(lambda: list(stream(iter(frames), lambda b: b + 1, batch=4, device="cuda")))
    np.testing.assert_array_equal(np.stack(out), np.stack(frames) + 1)
    assert _count(ranges, "rctpu.queue.upload") == 5
    # The stacking thread's ranges (stack, upload_wait in it) are not in a
    # trace of the caller's thread.
    assert _count(ranges, "rctpu.queue.stack") == _count(ranges, "rctpu.queue.upload_wait") == 0
    assert _count(ranges, "rctpu.queue.readback_wait") == 5  # one a batch returned
    assert _count(ranges, "rctpu.queue.copy_out") == 5
    # The caller keeps every frame: batches 0, 1 and the flush's are lent, 2 and 3 copied at the cap.
    assert _count(ranges, "rctpu.queue.handout") == 3 and _count(ranges, "rctpu.queue.copy_held") == 2
    for name in ("rctpu.queue.readback_wait", "rctpu.queue.copy_out"):
        assert _inside(ranges, name, "rctpu.queue.readback"), name
    for name in ("rctpu.queue.handout", "rctpu.queue.copy_held"):
        assert _inside(ranges, name, "rctpu.queue.copy_out"), name


@pytest.mark.cuda
def test_feeder_put_spans_on_the_card():
    """``put`` on the caller's thread: one ``upload`` a batch, and inside it
    the wait for a pinned buffer's last upload once the buffers come round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pinned upload waits on its events)")
    feeder = queue.DeviceFeeder("cuda")
    frames = _frames(20, hw=(64, 64))
    _, ranges = _traced(lambda: [feeder.put(frames[i:i + 4]) for i in range(0, 20, 4)])
    torch.cuda.synchronize()
    assert _count(ranges, "rctpu.queue.upload") == 5
    assert _count(ranges, "rctpu.queue.upload_wait") == 5 - queue.UPLOADS  # from the fourth put, a buffer is reused
    assert _inside(ranges, "rctpu.queue.upload_wait", "rctpu.queue.upload")
