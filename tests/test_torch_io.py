"""The io layer of the port (io/queue.py, io/testpattern.py, io/native.py)
and utils/metrics.py, runtime/config.py: the six cases of
tests/test_io_native.py and the config and FrameStats cases of
tests/test_utils_config.py, mirrored case for case on the CPU
(``device="cpu"``), plus the order and latency of the feeder and readback,
the readback's lent pinned buffers driven with CPU tensors
(tests/_host_readback.py), and the reading and stacking threads that
``stream`` runs on the card, driven with the CPU feeder.

Tolerance: bit-equal everywhere (copies, pure Python and numpy; the
queue's CPU path is a tensor conversion). The native converter against
the port's device converter keeps the original's 0.01 (fixed-point
rounding).
"""

import threading
import time

import numpy as np
import pytest
import torch

from _host_readback import HostReadback
from retrocapture_tpu.io import testpattern as jtp
from retrocapture_tpu_torch.io import queue
from retrocapture_tpu_torch.io.queue import HELD, UPLOADS, DeviceFeeder, DeviceReadback, FrameQueue, stream
from retrocapture_tpu_torch.io.testpattern import BAR_COLORS, TestPatternSource


def test_frame_queue_drop_oldest():
    q = FrameQueue(maxlen=3)
    for i in range(5):
        q.push(np.full((2, 2), i, np.uint8))
    assert len(q) == 3
    assert q.dropped == 2
    assert q.pop()[0, 0] == 2  # oldest two dropped


def test_frame_queue_batch():
    q = FrameQueue(maxlen=10)
    for i in range(4):
        q.push(np.full((2, 2), i, np.uint8))
    b = q.pop_batch(4, timeout=0.1)
    assert b.shape == (4, 2, 2)
    assert list(b[:, 0, 0]) == [0, 1, 2, 3]
    assert q.pop_batch(1, timeout=0.01) is None
    q.close()
    assert q.pop() is None


def test_device_readback_one_frame_latency():
    rb = DeviceReadback()
    assert rb.submit(torch.ones((2, 2))) is None  # PBOManager.cpp:137
    out = rb.submit(torch.zeros((2, 2)))
    assert isinstance(out, np.ndarray) and out[0, 0] == 1.0
    tail = rb.flush()
    assert tail[0, 0] == 0.0
    assert rb.flush() is None


def test_device_readback_on_the_cpu_hands_out_the_tensor_itself():
    """A CPU tensor takes no buffer: the array handed out is the tensor's
    own memory, as before the lent buffers."""
    rb = DeviceReadback()
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert rb.submit(t) is None
    out = rb.flush()
    assert np.shares_memory(out, t.numpy()) and out.tolist() == t.tolist()
    assert rb._lender._slots == []


def _lent(shape=(3, 2, 2), fill=0):
    lender = queue._Lender(torch.empty)
    slot = lender.take(shape, torch.uint8)
    slot.buf.fill_(fill)
    return lender, slot


def test_lent_buffer_is_not_reused_while_a_frame_of_it_lives():
    lender, slot = _lent(fill=7)
    batch = lender.hand_out(slot)
    assert np.shares_memory(batch, slot.buf.numpy())
    frame = batch[1]
    del batch
    other = lender.take((3, 2, 2), torch.uint8)
    assert other is not slot and len(lender._slots) == 2
    other.buf.fill_(9)
    assert (frame == 7).all()


def test_lent_buffer_is_reused_once_its_batch_is_dropped():
    lender, slot = _lent()
    batch = lender.hand_out(slot)
    frames = list(batch)
    del batch
    assert not slot.free
    del frames
    assert slot.free
    assert lender.take((3, 2, 2), torch.uint8) is slot and len(lender._slots) == 1
    # Another shape: the same slot, a buffer made anew.
    slot.free = True
    assert lender.take((5, 2, 2), torch.uint8) is slot and tuple(slot.buf.shape) == (5, 2, 2)


def test_at_the_cap_the_batch_is_copied_out_and_its_buffer_freed():
    lender = queue._Lender(torch.empty)
    held = []
    for n in range(HELD - 1):  # lent while one buffer stays for the next download
        slot = lender.take((2, 2), torch.uint8)
        slot.buf.fill_(n)
        held.append(lender.hand_out(slot))
        assert np.shares_memory(held[-1], slot.buf.numpy())
    last = lender.take((2, 2), torch.uint8)
    last.buf.fill_(HELD - 1)
    out = lender.hand_out(last)
    assert not np.shares_memory(out, last.buf.numpy()) and last.free and (out == HELD - 1).all()
    assert len(lender._slots) == HELD
    assert lender.take((2, 2), torch.uint8) is last
    with pytest.raises(RuntimeError, match="readback buffers"):
        lender.take((2, 2), torch.uint8)
    assert [int(a[0, 0]) for a in held] == list(range(HELD - 1))


@pytest.mark.parametrize("keep", ["every frame", "nothing"])
def test_stream_through_lent_buffers(monkeypatch, keep):
    """Over more batches than the cap: every frame intact and in order.
    A caller that keeps every frame gets its first batches lent and
    copies once the cap is near, HELD buffers in all; one that keeps
    nothing gets every batch lent from two buffers, since the generator
    holds no batch through the next submission."""
    monkeypatch.setattr(queue, "DeviceReadback", HostReadback)
    frames = [np.full((2, 3), i, np.uint8) for i in range(4 * (HELD + 6) + 2)]
    lent = []
    real = queue._Lender.hand_out

    def hand_out(self, slot):
        out = real(self, slot)
        lent.append(np.shares_memory(out, slot.buf.numpy()))
        return out

    monkeypatch.setattr(queue._Lender, "hand_out", hand_out)
    it = stream(iter(frames), lambda b: b.to(torch.float32) + 0.5, batch=4, device="cpu")
    expect = [i + 0.5 for i in range(len(frames))]
    if keep == "every frame":
        outs = list(it)
        assert [float(o[0, 0]) for o in outs] == expect
        np.testing.assert_array_equal(np.stack(outs), np.stack(frames).astype(np.float32) + 0.5)
        assert lent[:HELD - 2] == [True] * (HELD - 2) and not any(lent[HELD - 2:-1]) and lent[-1]
        assert len(HostReadback.last._lender._slots) == HELD
    else:
        assert list(map(lambda f: float(f[0, 0]), it)) == expect  # each frame dropped before the next
        assert all(lent) and len(HostReadback.last._lender._slots) == 2
    assert len(lent) == -(-len(frames) // 4)


def test_stream_pipeline():
    frames = [np.full((2, 2), i, np.uint8) for i in range(10)]
    seen = []

    def process(b):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu" and b.dtype == torch.uint8
        seen.append(b.shape[0])
        return b.to(torch.float32)

    outs = list(stream(iter(frames), process, batch=4, device="cpu"))
    assert len(outs) == 10 and seen == [4, 4, 2]
    assert outs[0][0, 0] == 0.0 and outs[9][0, 0] == 9.0
    assert [float(o[0, 0]) for o in outs] == [float(i) for i in range(10)]


def test_stream_is_one_batch_late():
    """The readback hands out batch n-1 when batch n is submitted."""
    frames = (np.full((2, 2), i, np.uint8) for i in range(12))
    processed = []
    it = stream(frames, lambda b: processed.append(int(b[0, 0, 0])) or b, batch=4, device="cpu")
    first = next(it)
    assert processed == [0, 4] and first[0, 0] == 0  # batch 0 comes out once batch 1 is in
    rest = list(it)
    assert processed == [0, 4, 8] and len(rest) == 11


def test_feeder_and_stream_default_to_the_card(monkeypatch):
    """No card and no device="cpu": the feeder raises, nothing runs on
    the CPU in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceFeeder()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        list(stream(iter([np.zeros((2, 2), np.uint8)]), lambda b: b, batch=1))


def test_feeder_canonicalises_like_device_put():
    f = DeviceFeeder("cpu")
    assert f.put(np.zeros((2, 3), np.float64)).dtype == torch.float32
    assert f.put(np.zeros((2, 3), np.uint8)).dtype == torch.uint8
    batch = np.arange(6, dtype=np.uint8).reshape(2, 3)
    t = f.put(batch)
    batch[:] = 0  # the fed tensor does not alias the caller's buffer
    assert t.tolist() == [[0, 1, 2], [3, 4, 5]]


def _counted(n, pulled, fail_at=None):
    """Frames 0..n-1 (forever where n is None), each noted in ``pulled``
    as the source hands it out; frame ``fail_at`` raises instead."""
    i = 0
    while n is None or i < n:
        if i == fail_at:
            raise ValueError(f"frame {i}")
        pulled.append(i)
        yield np.full((2, 3), i, np.uint8)
        i += 1


def _settled(pulled, want, timeout=10.0):
    """Wait for the reading thread to have pulled ``want`` frames; then
    check it pulls no more."""
    deadline = time.monotonic() + timeout
    while len(pulled) < want and time.monotonic() < deadline:
        time.sleep(0.005)
    time.sleep(0.1)
    return len(pulled)


def test_stacking_thread_keeps_order_and_stays_at_most_uploads_ahead():
    """The threads stage batches in the source's order, the last one
    short, and the reading one blocks once ``UPLOADS`` batches are staged
    that the caller has not finished with: it has then taken one batch
    more of frames."""
    pulled = []
    ahead = queue._Ahead(_counted(4 * (UPLOADS + 3) + 2, pulled), 4, DeviceFeeder("cpu"))
    it = iter(ahead)
    first = next(it)
    assert _settled(pulled, 4 * (UPLOADS + 1)) == 4 * (UPLOADS + 1)
    rest = list(it)
    got = np.concatenate([first] + rest)
    assert [b.shape[0] for b in [first] + rest] == [4] * (UPLOADS + 3) + [2]
    np.testing.assert_array_equal(got[:, 0, 0], np.arange(4 * (UPLOADS + 3) + 2))
    ahead._thread.join(5.0)
    assert not ahead._thread.is_alive()


def test_stacking_thread_hands_the_source_error_to_the_caller():
    pulled = []
    it = iter(queue._Ahead(_counted(None, pulled, fail_at=6), 4, DeviceFeeder("cpu")))
    assert next(it)[:, 0, 0].tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="frame 6"):
        next(it)


def test_stacking_thread_stops_on_close():
    """A caller that leaves early stops the threads, also while the
    reading one waits for room; no thread is left behind by a stream that
    is closed."""
    pulled = []
    ahead = queue._Ahead(_counted(None, pulled), 4, DeviceFeeder("cpu"))
    it = iter(ahead)
    next(it)
    _settled(pulled, 4 * (UPLOADS + 1))
    ahead.close()
    ahead._thread.join(5.0)
    ahead._stager.shutdown(wait=True)
    assert not ahead._thread.is_alive()
    before = threading.active_count()
    s = stream(_counted(None, []), lambda b: b, batch=4, device="cpu")
    next(s)
    s.close()
    assert threading.active_count() == before


def test_testpattern_content():
    """The smoke-test content assertions (tools/smoke-test.sh:168-215),
    and the same frames as the JAX package's source."""
    src = TestPatternSource(320, 240)
    ref = jtp.TestPatternSource(320, 240)
    f0 = src.capture_frame().astype(np.float32)
    f1 = src.capture_frame().astype(np.float32)
    assert f0.max() >= 180  # brightness
    assert f0.std() >= 20  # spatial structure
    colors = {tuple(f0[10, x].astype(int)) for x in range(0, 320, 40)}
    assert len(colors) >= 5  # >= 5 distinct bar colors
    assert np.abs(f1 - f0).mean() > 0.0  # temporal change (moving marker)
    np.testing.assert_array_equal(f0, ref.capture_frame())
    np.testing.assert_array_equal(f1, ref.capture_frame())
    np.testing.assert_array_equal(src.capture_batch(3), ref.capture_batch(3))
    np.testing.assert_array_equal(BAR_COLORS, jtp.BAR_COLORS)


def test_native_framehost():
    from retrocapture_tpu_torch.io import native
    from retrocapture_tpu_torch.ops.colorspace import yuyv_to_rgb

    if not native.native_available():
        pytest.skip("libframehost.so not built")
    r = native.NativeRing(4, (2, 2, 3))
    for i in range(6):
        r.push(np.full((2, 2, 3), i, np.uint8))
    f, discarded = r.pop_latest()
    assert f[0, 0, 0] == 5 and discarded == 3
    assert r.stats["dropped"] == 2
    assert r.pop_latest() is None

    tp = native.testpattern(64, 48, 0)
    assert tp.shape == (48, 64, 3)
    assert tp[0, 0].tolist() == [255, 255, 255]

    # BT.601 parity with the device converter (fixed-point rounding only)
    raw = np.random.default_rng(0).integers(0, 256, (16, 64), np.uint8)
    a = native.yuyv_to_rgb24(raw, 32, 16).astype(np.float32) / 255.0
    b = yuyv_to_rgb(torch.from_numpy(raw), 32, 16).numpy()
    assert np.abs(a - b).max() < 0.01


# -- tests/test_utils_config.py's config and FrameStats cases ---------------


def test_config_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    from retrocapture_tpu_torch.runtime.config import CoreConfig

    cfg = CoreConfig(preset="x.glslp", parameters={"A": 1.5}, brightness=1.2)
    cfg.save()
    loaded = CoreConfig.load()
    assert loaded.preset == "x.glslp"
    assert loaded.parameters == {"A": 1.5}
    assert loaded.brightness == 1.2
    # corrupt file degrades to defaults
    CoreConfig.path().write_text("{not json")
    assert CoreConfig.load().preset == ""


def test_profile_manager(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path))
    from retrocapture_tpu_torch.runtime.config import CoreConfig, ProfileManager

    pm = ProfileManager()
    pm.save("crt", CoreConfig(preset="crt.glslp"))
    pm.save("ntsc", CoreConfig(preset="ntsc.glslp"))
    assert pm.list() == ["crt", "ntsc"]
    assert pm.load("crt").preset == "crt.glslp"
    assert pm.load("nope") is None
    assert pm.delete("crt")
    assert pm.list() == ["ntsc"]


def test_config_applies_to_engine(tmp_path, monkeypatch):
    """The original's case on feedback-ghost (ships in assets/presets)."""
    import os

    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    from retrocapture_tpu_torch import Engine
    from retrocapture_tpu_torch.runtime.config import CoreConfig
    from retrocapture_tpu_torch.runtime.pipeline import FramePipeline

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = CoreConfig(
        preset=os.path.join(repo, "assets", "presets", "feedback-ghost.glslp"),
        parameters={"GHOST": 0.25},
        viewport=[64, 48],
        brightness=1.1,
    )
    e = Engine(device="cpu")
    cfg.apply_to(e)
    assert e.shader_active
    assert e.get_parameter("GHOST") == 0.25
    out = e.apply(np.zeros((24, 32, 3), np.uint8))
    assert tuple(out.shape) == (48, 64, 3)
    p = cfg.build_pipeline(e)
    assert isinstance(p, FramePipeline) and p.image.brightness == 1.1
    assert tuple(p.process(np.zeros((24, 32, 3), np.uint8)).shape) == (48, 64, 3)


def test_frame_stats():
    from retrocapture_tpu_torch.utils.metrics import FrameStats, Timer

    s = FrameStats()
    with Timer(s, n_frames=4):
        time.sleep(0.01)
    s.tick(4, latency_s=0.02)
    snap = s.snapshot()
    assert snap["frames"] == 8
    assert snap["batches"] == 2
    assert snap["latency_p50_ms"] >= 10.0
    assert snap["fps_ema"] > 0


def test_scanner_env_override(tmp_path, monkeypatch):
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "a.glslp").write_text("shaders = 0\n")
    monkeypatch.setenv("RETROCAPTURE_SHADER_PATH", str(tmp_path))
    from retrocapture_tpu_torch.utils.scanner import default_shader_root, scan_presets

    assert default_shader_root() == tmp_path
    assert [p.name for p in scan_presets()] == ["a.glslp"]
    assert [p.name for p in scan_presets(tmp_path, include_glsl=True)] == ["a.glslp"]
