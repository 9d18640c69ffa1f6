"""FramePipeline and the max-resolution clamp of the port
(runtime/pipeline.py, runtime/engine.py) against the JAX package's, on the
same numpy frames (made from a seed), both on the CPU.

The five cases of tests/test_pipeline.py that need no shader corpus are
mirrored case for case (the clamp case runs feedback-ghost, which ships
in assets/presets, where the original runs crt-mattias), each asserting
what the original asserts and that the port equals the reference.

Tolerances.
* ``_prepare`` (logical-resolution downscale, overscan): NEAREST taps of a
  numpy grid copied from the reference letter for letter: bit-equal.
* ``_blit`` and the passthrough resize: a LINEAR tap through the separable
  f32 matmul, within 1 ulp of XLA's dot (1.2e-7 on [0, 1]); the image
  controls after it are contracted as the reference's jitted blit contracts
  them and add nothing. Stated: <= 2.4e-7 (brightness up to 1.5 scales the
  ulp).
* Through a loaded chain: u8 within 1 step in <= 0.1% of values, f32 within
  1e-6 (the gate of tests/test_torch_engine.py).
"""

import os

import numpy as np
import pytest
import torch

import retrocapture_tpu as jax_pkg
import retrocapture_tpu_torch as torch_pkg
from retrocapture_tpu.io.testpattern import TestPatternSource
from retrocapture_tpu.runtime import pipeline as jp
from retrocapture_tpu_torch.runtime import pipeline as tp
from test_torch_engine import _close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEEDBACK = os.path.join(REPO, "assets", "presets", "feedback-ghost.glslp")
LINEAR_TOL = 2.4e-7


def frame(h=48, w=64, value=128):
    return np.full((h, w, 3), value, np.uint8)


def noise(seed, b=None, h=48, w=64):
    shape = (h, w, 3) if b is None else (b, h, w, 3)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def both(frames, preset=None, viewport=None, image=None, **kw):
    """The same pipeline over both engines; (reference, port) outputs."""
    je = jax_pkg.Engine(viewport=viewport)
    te = torch_pkg.Engine(viewport=viewport, device="cpu")
    if preset:
        assert je.load_preset(preset) and te.load_preset(preset)
    pj = jp.FramePipeline(je, image=jp.ImageSettings(**(image or {})), **kw)
    pt = tp.FramePipeline(te, image=tp.ImageSettings(**(image or {})), **kw)
    a = np.asarray(pj.process(frames))
    out = pt.process(frames)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    b = out.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    assert pt.stats.frames == pj.stats.frames == (1 if frames.ndim == 3 else len(frames))
    return a, b


def test_logical_resolution_downscale():
    a, b = both(noise(1), logical_resolution=(32, 24))
    assert b.shape == (24, 32, 3)  # passthrough engine keeps logical size
    np.testing.assert_array_equal(b, a)


def test_overscan_crops_border():
    f = noise(2) // 2
    f[:4, :, :] = 255  # bright top border
    a, b = both(f, overscan_percent=(10.0, 10.0))
    assert b.shape == (48, 64, 3)
    assert b.max() < 0.99  # top border cropped away: no 255s remain
    np.testing.assert_array_equal(b, a)


def test_brightness_contrast_flip():
    f = frame(value=100)
    f[0, :, :] = 200  # marker row at top
    a, b = both(f, image=dict(brightness=1.5, contrast=1.0, flip_y=True))
    base = 100 / 255 * 1.5
    assert abs(float(b[5, 5, 0]) - base) < 0.02
    assert b[-1].mean() > b[0].mean()  # flipped: the marker row is now at the bottom
    assert np.abs(b.astype(np.float64) - a).max() <= LINEAR_TOL


def test_maintain_aspect_letterbox():
    a, b = both(frame(value=200), window=(128, 48), image=dict(maintain_aspect=True))
    assert b.shape == (48, 128, 3)
    assert b[:, 0].max() == 0.0 and b[:, -1].max() == 0.0  # black bars left and right
    assert b[:, 64].mean() > 0.5  # content in the middle
    np.testing.assert_array_equal(b == 0.0, a == 0.0)
    assert np.abs(b.astype(np.float64) - a).max() <= LINEAR_TOL


@pytest.mark.parametrize("output", ["u8", "f32"])
def test_max_shader_resolution_clamp(output):
    src = TestPatternSource(128, 96).capture_batch(2)
    outs = {}
    for clamp in (True, False):
        je = jax_pkg.Engine(viewport=(64, 48))
        te = torch_pkg.Engine(viewport=(64, 48), device="cpu")
        for e in (je, te):
            assert e.load_preset(FEEDBACK), e.last_error
            if clamp:
                e.set_max_shader_resolution(32, 24)
            assert e._clamped_source(128, 96) == ((32, 24) if clamp else (128, 96))
        for i in range(2):  # the feedback texture is kept at the clamped size
            a = np.asarray(je.apply(src, output=output))
            b = te.apply(torch.from_numpy(src), output=output).numpy()
            assert b.shape == (2, 48, 64, 3) and np.isfinite(b).all()
            _close(a, b, output)
        key = (96, 128, 64, 48)
        assert tuple(te._states[key].feedback[0].shape) == tuple(je._states[key].feedback[0].shape)
        outs[clamp] = b.astype(np.float32)
    # and produces a different (lower-res-sourced) image than unclamped
    assert np.abs(outs[True] - outs[False]).mean() > 1e-5


def test_clamped_source_matches_reference():
    je = jax_pkg.Engine()
    te = torch_pkg.Engine(device="cpu")
    for mw, mh in ((640, 480), (32, 24), (0, 0), (100, 1000), (1000, 100), (3, 3)):
        je.set_max_shader_resolution(mw, mh)
        te.set_max_shader_resolution(mw, mh)
        for w, h in ((1280, 960), (320, 240), (1920, 1080), (641, 480), (7, 1000)):
            assert te._clamped_source(w, h) == je._clamped_source(w, h), (mw, mh, w, h)


def test_set_max_shader_resolution_drops_states():
    te = torch_pkg.Engine(viewport=(64, 48), device="cpu")
    assert te.load_preset(FEEDBACK)
    te.apply(torch.from_numpy(noise(3, b=1)))
    assert te._states
    te.set_max_shader_resolution(32, 24)
    assert not te._states


# -- the blit's image controls ----------------------------------------------


@pytest.mark.parametrize("flip", [False, True], ids=["upright", "flipped"])
@pytest.mark.parametrize("bc", [(1.0, 1.0), (1.2, 1.0), (1.0, 0.8), (1.2, 0.8)], ids=str)
def test_blit_controls_match_reference(bc, flip):
    """XLA drops a control left at 1.0 and contracts the others: the
    pattern differs by setting. The window forces the blit at (1, 1)."""
    frames = noise(4, b=2)
    a, b = both(frames, window=(160, 120), image=dict(brightness=bc[0], contrast=bc[1], flip_y=flip))
    assert b.shape == (2, 120, 160, 3)
    assert b.min() >= 0.0 and b.max() <= 1.0
    assert np.abs(b.astype(np.float64) - a).max() <= LINEAR_TOL


@pytest.mark.parametrize("bc", [(1.0, 1.0), (1.2, 1.0), (1.0, 0.8), (1.2, 0.8), (0.7, 1.6)], ids=str)
def test_blit_controls_bit_equal_without_a_resize(bc):
    """No window: the blit's LINEAR tap is the identity, so only the image
    controls act, and those are bit-equal."""
    frames = noise(5, b=2)
    a, b = both(frames, image=dict(brightness=bc[0], contrast=bc[1], flip_y=True))
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("window,src_hw", [((128, 48), (48, 64)), ((64, 128), (48, 64)), ((100, 75), (48, 64)), ((97, 31), (30, 41))])
def test_letterbox_placement_matches_reference(window, src_hw):
    frames = noise(6, b=1, h=src_hw[0], w=src_hw[1]) // 2 + 64  # no black pixels in the content
    a, b = both(frames, window=window, image=dict(maintain_aspect=True))
    assert b.shape == (1, window[1], window[0], 3)
    np.testing.assert_array_equal(b == 0.0, a == 0.0)
    assert np.abs(b.astype(np.float64) - a).max() <= LINEAR_TOL


def test_pipeline_over_a_loaded_chain_matches_reference():
    """The stream phase's settings at a small size: logical resolution,
    overscan, brightness, contrast, flip-Y and a letterboxed window over
    feedback-ghost, three batches (the feedback texture carries)."""
    kw = dict(
        preset=FEEDBACK, viewport=(160, 120), logical_resolution=(32, 24), overscan_percent=(2.0, 2.0),
        window=(256, 144), image=dict(brightness=1.1, contrast=0.9, flip_y=True, maintain_aspect=True),
    )
    je = jax_pkg.Engine(viewport=kw["viewport"])
    te = torch_pkg.Engine(viewport=kw["viewport"], device="cpu")
    assert je.load_preset(FEEDBACK) and te.load_preset(FEEDBACK)
    pj = jp.FramePipeline(je, logical_resolution=(32, 24), overscan_percent=(2.0, 2.0), window=(256, 144),
                          image=jp.ImageSettings(**kw["image"]))
    pt = tp.FramePipeline(te, logical_resolution=(32, 24), overscan_percent=(2.0, 2.0), window=(256, 144),
                          image=tp.ImageSettings(**kw["image"]))
    for i in range(3):
        frames = noise(10 + i, b=2)
        a = np.asarray(pj.process(frames))
        b = pt.process(frames).numpy()
        assert b.shape == (2, 144, 256, 3)
        _close(a, b, "f32")
    assert pt.stats.frames == 6 and pt.stats.batches == 3
    assert te.shader_active and je.shader_active
    # pillarboxed: 160x120 into 256x144 leaves bars left and right
    assert b[:, :, 0].max() == 0.0 and b[:, :, -1].max() == 0.0 and b[:, :, 128].mean() > 0.0


def test_process_takes_one_frame_and_float_input():
    te = torch_pkg.Engine(device="cpu")
    je = jax_pkg.Engine()
    f = noise(7).astype(np.float32) / np.float32(255.0)
    a = np.asarray(jp.FramePipeline(je, logical_resolution=(32, 24)).process(f))
    b = tp.FramePipeline(te, logical_resolution=(32, 24)).process(f).numpy()
    assert b.shape == (24, 32, 3)
    np.testing.assert_array_equal(b, a)


def test_prepare_grids_are_kept_per_key():
    te = torch_pkg.Engine(device="cpu")
    p = tp.FramePipeline(te, logical_resolution=(32, 24), window=(80, 60))
    p.process(noise(8, b=2))
    p.process(noise(9, b=2))
    assert len(p._prep_grids) == 1 and len(p._blit_plans) == 1
    p.process(noise(9, b=2, h=60, w=80))
    assert len(p._prep_grids) == 2
