"""``apply_streams`` across streams on the CPU: the reference's vmap over S
streams (its runtime/engine.py:427-510), against S engines of their own
and against retrocapture_tpu.Engine.apply_streams (JAX on the CPU).

A temporal chain steps frame t of every stream in one walk
(``torch.func.vmap`` of the frame's step over the stream axis, each stream
with its own ring, feedback, FrameCount and Time); a stateless chain runs
the S·T frames as one batched walk, stream s from its own FrameCount.
Every test here turns vmap's per-example fallback warning into an error.

Tolerance: stream s bit-equal to an engine of its own fed that stream
alone; against the JAX engine, feedback-ghost and the FrameCount shader
bit-equal (as tests/test_torch_engine.py and tests/test_torch_batch.py
hold them one stream at a time).
"""

import numpy as np
import pytest
import torch

import retrocapture_tpu as jax_pkg
import retrocapture_tpu_torch as torch_pkg
from _xbr_standin import write_standin as write_xbr
from retrocapture_tpu_torch.runtime import engine as engine_module
from test_torch_batch import FC_VIEWPORT, no_vmap_fallback, one_thread, tmp, write_fc  # noqa: F401 - fixtures
from test_torch_engine import FEEDBACK
from test_torch_replay import _HostArrays, _HostWork

SRC_HW = (48, 64)
S, T = 3, 4

# name -> (preset writer, viewport, temporal)
CHAINS = {
    "feedback-ghost": (lambda d: FEEDBACK, (160, 120), True),
    "frame-count": (write_fc, FC_VIEWPORT, False),
    "xbr": (write_xbr, (192, 144), False),
}


def _streams(seed, s=S, t=T):
    return np.random.default_rng(seed).integers(0, 256, (s, t) + SRC_HW + (3,), dtype=np.uint8)


def _engine(path, viewport):
    e = torch_pkg.Engine(viewport=viewport, device="cpu")
    assert e.load_preset(path), e.last_error
    return e


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_streams_equal_engines_of_their_own(tmp, name):  # noqa: F811
    """Two calls of apply_streams (the per-stream state carried between
    them): stream s equals an engine of its own fed that stream alone."""
    write, viewport, _ = CHAINS[name]
    path = write(tmp)
    e = _engine(path, viewport)
    calls = [_streams(1), _streams(2)]
    got = [e.apply_streams(torch.from_numpy(c)) for c in calls]
    for si in range(S):
        own = _engine(path, viewport)
        for c, g in zip(calls, got):
            np.testing.assert_array_equal(g[si].numpy(), own.apply(torch.from_numpy(c[si])).numpy(), err_msg=f"stream {si}")
    st = e._states[SRC_HW + viewport + (S, "const")]
    assert st.frame_count.tolist() == [2 * T] * S


@pytest.mark.parametrize("name", ["feedback-ghost", "frame-count"])
def test_streams_match_jax_engine(tmp, name):  # noqa: F811
    write, viewport, _ = CHAINS[name]
    path = write(tmp)
    je = jax_pkg.Engine(viewport=viewport)
    assert je.load_preset(path)
    e = _engine(path, viewport)
    for seed in (3, 4):
        c = _streams(seed)
        np.testing.assert_array_equal(e.apply_streams(torch.from_numpy(c)).numpy(), np.asarray(je.apply_streams(c)))


@pytest.mark.parametrize("name", ["feedback-ghost", "frame-count"])
def test_streams_walk_once_a_step(tmp, monkeypatch, name):  # noqa: F811
    """A temporal chain walks once a time step for all S streams (T walks a
    call); a stateless chain walks once a call."""
    write, viewport, temporal = CHAINS[name]
    e = _engine(write(tmp), viewport)
    walks = []
    real = engine_module._run_chain_impl
    monkeypatch.setattr(engine_module, "_run_chain_impl", lambda *a, **k: (walks.append(a[3].shape), real(*a, **k))[1])
    for seed in (5, 6):
        e.apply_streams(torch.from_numpy(_streams(seed)))
    assert len(walks) == (2 * T if temporal else 2)
    assert all(tuple(s) == SRC_HW + (4,) for s in walks)  # a frame's source, batched by vmap
    keys = [k for k in e._programs if "streams" in k]
    assert len(keys) == 1 and keys[0][7] == S


@pytest.mark.parametrize("name", ["feedback-ghost", "frame-count"])
def test_streams_walks_do_no_host_work(tmp, name):  # noqa: F811
    """The dispatch-mode guards of tests/test_torch_replay.py over the
    streams' replayed walk."""
    write, viewport, temporal = CHAINS[name]
    e = _engine(write(tmp), viewport)
    frames = torch.from_numpy(_streams(7))
    e.apply_streams(frames)
    key = SRC_HW + viewport
    state = e._states[key + (S, "const")]
    sync = _HostWork()
    with sync, _HostArrays(sync.hits):
        e._run_batch(key, frames.reshape((S * T,) + tuple(frames.shape[2:])), state, streams=S)
    assert not sync.hits, "\n".join(f"{f} x{n}\n{s}" for (f, s), n in sync.hits.items())


def test_streams_and_the_single_stream_keep_their_own_state(tmp):  # noqa: F811
    """apply and apply_streams of one size keep apart programs and states:
    the single stream continues where it was after a call of the streams."""
    e, own = _engine(FEEDBACK, (160, 120)), _engine(FEEDBACK, (160, 120))
    a, b = _streams(8, s=1)[0], _streams(9, s=1)[0]
    np.testing.assert_array_equal(e.apply(torch.from_numpy(a)).numpy(), own.apply(torch.from_numpy(a)).numpy())
    e.apply_streams(torch.from_numpy(_streams(10)))
    np.testing.assert_array_equal(e.apply(torch.from_numpy(b)).numpy(), own.apply(torch.from_numpy(b)).numpy())
    assert int(e._states[SRC_HW + (160, 120)].frame_count) == 2 * T
