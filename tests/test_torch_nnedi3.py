"""The nnedi3 entries of the port's kernel library (graph/kernels.py)
against the JAX package's, on the CPU: the weight parser, every registry
name as one pass and in a 2-pass chain, and a declined scale. The JAX
engine runs under ``RCTPU_KERNELS=interpret`` (its entries jitted, as the
engine compiles them); the shaders are the stand-ins of
tests/_nnedi3_standin.py (a passthrough body, the net in a comment).

Also here: ``policy.logf32`` and ``policy.expf32`` (XLA's inline ``log``
and ``exp``, which the entry's mix and every GLSL pow of the kernels
take), bit-equal to the jitted ``jnp.log`` and ``jnp.exp``.

Tolerances.
* ``_nnedi3_weights``: equal arrays; ``None`` for the same malformed texts.
* One pass, float framebuffer: the even (source) rows or columns
  bit-equal. The predicted ones go through two [32, nns] contractions,
  a matmul on both sides whose summation order differs from XLA's dot,
  and then through ``exp`` and the softsign mix: measured f32 within
  2.2e-6, 8-32% of values off by ulps. Budget: f32 within 1e-5.
* The 2-pass chain, through the RGBA8 store: u8 at most 1 step in 1e-3
  of values (measured: the nns64 -rgb chain 1 step in 5.4e-5).
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import retrocapture_tpu as jax_pkg
import retrocapture_tpu_torch as torch_pkg
from _nnedi3_standin import NAMES, write_4x_chain, write_chain, write_one_pass, write_shader
from retrocapture_tpu.graph import kernels as jk
from retrocapture_tpu_torch.graph import kernels as tk
from retrocapture_tpu_torch.policy import expf32, logf32

f32 = np.float32
SRC = (24, 32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: torch's CPU thread pool only adds its start-up cost
    per operation (tens of milliseconds a call under a parallel test run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tmp():
    with tempfile.TemporaryDirectory() as td:
        yield td


def _frames(seed, n=2, hw=SRC):
    return np.random.default_rng(seed).integers(0, 256, (n,) + hw + (3,), dtype=np.uint8)


def _spy(registry, monkeypatch):
    calls = []
    for n in NAMES:
        fn = registry[n]

        def w(ctx, sh, fn=fn):
            out = fn(ctx, sh)
            calls.append(out is not None)
            return out

        monkeypatch.setitem(registry, n, w)
    return calls


def _run(pkg, path, viewport, frames, output, monkeypatch, kernels="on"):
    if pkg is jax_pkg:
        monkeypatch.setenv("RCTPU_KERNELS", "interpret" if kernels == "on" else kernels)
        calls = _spy(jk._REGISTRY, monkeypatch)
        e = jax_pkg.Engine(viewport=viewport)
    else:
        monkeypatch.setenv("RCTPU_KERNELS", kernels)
        calls = _spy(tk._REGISTRY, monkeypatch)
        e = torch_pkg.Engine(viewport=viewport, device="cpu")
    assert e.load_preset(path), e.last_error
    out = e.apply(frames if pkg is jax_pkg else _t(frames), output=output)
    assert e.shader_active is True and e.last_error is None
    monkeypatch.delenv("RCTPU_KERNELS")
    return (np.asarray(out) if pkg is jax_pkg else out.numpy()), calls


def _viewport(name):
    h, w = SRC
    return (w, 2 * h) if "-pass1-" in name else (2 * w, h)


# -- the weights --------------------------------------------------------------


@pytest.mark.parametrize("nns", [16, 32, 64])
def test_weights_equal_reference(tmp, nns):
    path = write_shader(tmp, f"nnedi3-nns{nns}-win8x4-pass1-rgb.glsl", seed=nns)
    got, want = tk._nnedi3_weights(path), jk._nnedi3_weights(path)
    assert got is not None and want is not None
    for g, w, shape in zip(got, want, [(32, nns), (32, nns), (nns,), (nns,)]):
        assert g.shape == w.shape == shape and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


MALFORMED = {
    "seven-terms": dict(terms=7),
    "repeated-sample": dict(repeat_sample=True),
    "inf-weight": dict(bad_weight=True),
}


@pytest.mark.parametrize("case", sorted(MALFORMED) + ["missing-file"])
def test_malformed_weights_give_none(tmp, case):
    if case == "missing-file":
        path = os.path.join(tmp, "no-such-dir", "nnedi3-nns16-win8x4-pass1-rgb.glsl")
    else:
        d = os.path.join(tmp, case)
        os.makedirs(d, exist_ok=True)
        path = write_shader(d, "nnedi3-nns16-win8x4-pass1-rgb.glsl", **MALFORMED[case])
    assert jk._nnedi3_weights(path) is None
    assert tk._nnedi3_weights(path) is None


# -- every name, one pass and in a chain ----------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_one_pass_matches_jax_engine(tmp, monkeypatch, name):
    d = os.path.join(tmp, "one-" + name[:-5])
    os.makedirs(d, exist_ok=True)
    vp = _viewport(name)
    frames = _frames(1)
    path = write_one_pass(d, name, seed=7, float_framebuffer=True)
    want, jcalls = _run(jax_pkg, path, vp, frames, "f32", monkeypatch)
    got, tcalls = _run(torch_pkg, path, vp, frames, "f32", monkeypatch)
    assert jcalls and all(jcalls) and tcalls == [True]  # one walk of the batch
    assert got.shape == want.shape == (2, vp[1], vp[0], 3)
    src = got[:, 0::2] if "-pass1-" in name else got[:, :, 0::2]
    np.testing.assert_array_equal(src, want[:, 0::2] if "-pass1-" in name else want[:, :, 0::2])
    assert np.abs(got.astype(np.float64) - want).max() <= 1e-5
    if "-luma" in name:  # channel 0 only; the others are the entry's ones
        assert (got[..., 1:] == 1.0).all()
    # Not the passthrough: the predicted rows/cols are the net's.
    pred = got[:, 1::2] if "-pass1-" in name else got[:, :, 1::2]
    assert not np.array_equal(pred[..., 0], src[..., 0])


@pytest.mark.parametrize("name", NAMES)
def test_chain_matches_jax_engine(tmp, monkeypatch, name):
    """The 2-pass chain (pass1 1x2, pass2 2x1) of ``name`` and its
    partner pass: 24x32 -> 48x32 -> 48x64, u8."""
    nns, kind = int(name.split("-")[1][3:]), name.rsplit("-", 1)[1][:-5]
    d = os.path.join(tmp, "chain-" + name[:-5])
    os.makedirs(d, exist_ok=True)
    path = write_chain(d, nns, kind, seed=nns)
    frames = _frames(2)
    want, jcalls = _run(jax_pkg, path, (64, 48), frames, "u8", monkeypatch)
    got, tcalls = _run(torch_pkg, path, (64, 48), frames, "u8", monkeypatch)
    assert jcalls and all(jcalls) and tcalls == [True] * 2  # one walk of the batch, two passes
    dd = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert dd.max() <= 1 and (dd != 0).mean() <= 1e-3, (dd.max(), (dd != 0).mean())


def test_wrong_scale_declines(tmp, monkeypatch):
    """A pass1 stand-in at 1x1: both entries decline; the passthrough body
    renders, as with the library off."""
    name = NAMES[1]
    path = write_one_pass(tmp, name, scale=(1.0, 1.0))
    frames = _frames(3)
    got, tcalls = _run(torch_pkg, path, (SRC[1], SRC[0]), frames, "u8", monkeypatch)
    want, jcalls = _run(jax_pkg, path, (SRC[1], SRC[0]), frames, "u8", monkeypatch)
    off, _ = _run(torch_pkg, path, (SRC[1], SRC[0]), frames, "u8", monkeypatch, kernels="off")
    assert tcalls == [False] and jcalls and not any(jcalls)  # one walk of the batch
    np.testing.assert_array_equal(got, off)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, frames)


def test_4x_chain_matches_jax_engine(tmp, monkeypatch):
    """The benchmark's four passes (nnedi3-nns64-2x-nns32-4x-rgb: the nns64
    net doubles y then x, the nns32 net again), 24x32 -> 96x128, u8 at a
    viewport the blit stretches it to; every pass through the entry."""
    d = os.path.join(tmp, "chain-4x")
    os.makedirs(d, exist_ok=True)
    path = write_4x_chain(d, height=4 * SRC[0])
    frames = _frames(5)
    want, jcalls = _run(jax_pkg, path, (160, 120), frames, "u8", monkeypatch)
    got, tcalls = _run(torch_pkg, path, (160, 120), frames, "u8", monkeypatch)
    assert jcalls and all(jcalls) and tcalls == [True] * 4  # one walk of the batch, four passes
    dd = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert dd.max() <= 1 and (dd != 0).mean() <= 1e-3, (dd.max(), (dd != 0).mean())


@pytest.mark.parametrize("concrete", [False, True], ids=["replayed", "concrete-fc"])
@pytest.mark.parametrize("case", ["computed", "declined"])
def test_replay_stats_count_the_entrys_passes(tmp, monkeypatch, case, concrete):
    """``Engine.replay_stats`` counts, over the frames, the passes the entry
    computed and the values it predicted (one a source texel and channel),
    and the passes it declined: the 2-pass -rgb chain at 24x32 ends at 48x64,
    or, its last pass at source y 1.0, at the viewport's height, where the
    pass-2 entry declines. Both branches of a batch: the program's walk
    (its counts taken at every apply) and concrete FrameCount's plain walks."""
    from retrocapture_tpu_torch.runtime import engine as engine_module

    monkeypatch.setattr(engine_module, "_CONCRETE_FC", concrete)
    d = os.path.join(tmp, f"count-{case}")
    os.makedirs(d, exist_ok=True)
    path = write_chain(d, 16, "rgb", seed=3, height=48 if case == "computed" else None)
    e = torch_pkg.Engine(viewport=(64, 48 if case == "computed" else 60), device="cpu")
    assert e.load_preset(path), e.last_error
    for n in (2, 3, 2):
        e.apply(_t(_frames(n, n)), output="u8")
    stats = e.replay_stats()
    h, w = SRC
    if case == "computed":
        assert stats["nnedi3_passes"] == 2 * 7 and stats["nnedi3_declined"] == 0
        assert stats["nnedi3_values"] == 7 * 3 * (h * w + 2 * h * w)
    else:
        assert stats["nnedi3_passes"] == 7 and stats["nnedi3_declined"] == 7
        assert stats["nnedi3_values"] == 7 * 3 * h * w
    assert e.replay_stats(reset=True)["frames"] == 7 and e.replay_stats()["nnedi3_passes"] == 0


# -- XLA's log and exp ----------------------------------------------------------


@pytest.mark.parametrize("fn", ["exp", "log"])
def test_xla_log_and_exp_bit_equal(fn):
    """Random values over the whole f32 range and near the clamps, where
    the result is subnormal (flushed to zero), zeros, infinities, NaN."""
    rng = np.random.default_rng(11)
    x = np.concatenate([
        rng.integers(-0x7F800000, 0x7F800000, 1 << 18).astype(np.int32).view(f32),
        rng.uniform(-100, 100, 1 << 18).astype(f32),
        rng.uniform(-88.5, -87.0, 1 << 14).astype(f32),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -87.8, 88.8, 89.0, 1e-40, -1e-40], f32),
    ])
    want = np.asarray(jax.jit(getattr(jnp, fn))(x))
    got = (expf32 if fn == "exp" else logf32)(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
