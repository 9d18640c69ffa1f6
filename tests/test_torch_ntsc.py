"""The ntsc 2-phase entries of the port's kernel library (graph/kernels.py)
against the JAX package's, piece by piece and through both engines, on the
CPU. The JAX engine runs under ``RCTPU_KERNELS=interpret`` (its entries on
the CPU, jitted, as the engine compiles them); the shaders are the
passthrough stand-ins of tests/_ntsc_standin.py under the registry's
basenames.

Tolerances.
* ``_ntsc_phase_rows`` and the band matrix: bit-equal (numpy on both
  sides; the reference builds the matrix on the device, equal to the numpy
  columns).
* ``_dot3``: bit-equal to the jitted ``v * mat`` einsum. XLA's CPU dot
  for a [rows, 3] x [3, 3] operand rounds output columns 0 and 1 per step
  and fuses column 2 into two FMAs (measured over shapes from 48x256 to
  8x240x1280 rows).
* Pass 1: bit-equal in f32 (float framebuffer), FrameCount on the device
  and as a host constant (``RCTPU_CONCRETE_FC=1``), parity 0, 1, 0.
* Pass 2: the band product is a matmul on both sides, whose summation
  order differs from XLA's dot: measured f32 within 2.9e-6 (a few ulps,
  ``pow`` of the gamma variants included), 22-78% of values off by ulps,
  NaN exactly where the reference has it; u8 at most 1 step in 1.1e-4 of
  values. Budget: f32 within 1e-5, u8 at most 1 step in 1e-3 of values.
* The chain: u8 at most 1 step in 1e-3 of values (measured: bit-equal on
  these frames, the band product's ulps vanish at the RGBA8 store); f32
  output (the blit of the stored last pass) within 1/255 in 1e-3 of
  values.
* A preset an entry declines renders as under ``RCTPU_KERNELS=off``:
  bit-equal.
"""

import tempfile

import jax
import numpy as np
import pytest
import torch

import retrocapture_tpu as jax_pkg
import retrocapture_tpu_torch as torch_pkg
from _ntsc_standin import PASS1, PASS2, write_chain, write_pass1, write_pass2
from retrocapture_tpu.graph import kernels as jk
from retrocapture_tpu.runtime import engine as jeng
from retrocapture_tpu_torch.graph import kernels as tk
from retrocapture_tpu_torch.runtime import engine as teng

f32 = np.float32
SRC = (48, 64)


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


def _spy(registry, names):
    """Wrap registry[name] for each name: record whether each call engaged."""
    calls = []
    wrapped = {}
    for n in names:
        fn = registry[n]

        def w(ctx, sh, fn=fn):
            out = fn(ctx, sh)
            calls.append(out is not None)
            return out

        wrapped[n] = w
    return wrapped, calls


def _run(pkg, path, viewport, batches, output, monkeypatch):
    """Apply each batch in turn on a fresh engine of ``pkg`` (the JAX
    engine under RCTPU_KERNELS=interpret); the outputs and the entries'
    engagement record."""
    names = list(PASS1.values()) + list(PASS2.values())
    if pkg is jax_pkg:
        monkeypatch.setenv("RCTPU_KERNELS", "interpret")
        wrapped, calls = _spy(jk._REGISTRY, names)
        for n, w in wrapped.items():
            monkeypatch.setitem(jk._REGISTRY, n, w)
        e = jax_pkg.Engine(viewport=viewport)
    else:
        wrapped, calls = _spy(tk._REGISTRY, names)
        for n, w in wrapped.items():
            monkeypatch.setitem(tk._REGISTRY, n, w)
        e = torch_pkg.Engine(viewport=viewport, device="cpu")
    assert e.load_preset(path), e.last_error
    outs = []
    for b in batches:
        o = e.apply(b if pkg is jax_pkg else _t(b), output=output)
        outs.append(np.asarray(o) if pkg is jax_pkg else o.numpy())
    assert e.shader_active is True and e.last_error is None
    monkeypatch.delenv("RCTPU_KERNELS", raising=False)
    return np.concatenate(outs), calls


def _both(path, viewport, batches, output, monkeypatch):
    want, jcalls = _run(jax_pkg, path, viewport, batches, output, monkeypatch)
    got, tcalls = _run(torch_pkg, path, viewport, batches, output, monkeypatch)
    assert got.shape == want.shape and got.dtype == want.dtype
    return got, want, jcalls, tcalls


def _u8_frames(seed, n, hw=SRC):
    return np.random.default_rng(seed).integers(0, 256, (n,) + hw + (3,), dtype=np.uint8)


def _assert_u8_budget(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d != 0).mean() <= 1e-3, (d != 0).mean()


# -- the host tables ----------------------------------------------------------


@pytest.mark.parametrize("w_out", [64, 256])
def test_phase_rows_bit_equal(w_out):
    for got, want in zip(tk._ntsc_phase_rows(w_out), jk._ntsc_phase_rows(w_out)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("in_w,out_w", [(256, 128), (100, 50)])
@pytest.mark.parametrize("weights", ["luma", "chroma"])
def test_band_matrix_bit_equal(weights, in_w, out_w):
    wts = jk._NTSC2_LUMA if weights == "luma" else jk._NTSC2_CHROMA
    want = np.asarray(jax.jit(lambda: jk._ntsc_band_matrix(wts, in_w, out_w))())
    got = tk._ntsc_band_matrix(wts, in_w, out_w)
    assert got.shape == (in_w, out_w) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["yiq", "composite", "svideo"])
def test_dot3_bit_equal_to_jitted_einsum(which):
    """The reference's ``jnp.einsum("...r,cr->...c", v, mat)`` (kernels.py:
    833, :840) jitted, on pixel values and on modulated YIQ values."""
    rng = np.random.default_rng(3)
    v = np.concatenate([
        (rng.integers(0, 256, (2, 48, 256, 3)) / 255).astype(f32),
        (rng.random((2, 48, 256, 3), f32) * 2 - 1).astype(f32),
    ])
    cols = tk._NTSC_YIQ_COLS if which == "yiq" else tk._NTSC_MIX_COLS[which == "svideo"]
    mat = np.array(cols, f32)
    want = np.asarray(jax.jit(lambda a: jax.numpy.einsum("...r,cr->...c", a, mat))(v))
    tv = _t(v)
    got = torch.stack(tk._dot3(tv[..., 0], tv[..., 1], tv[..., 2], cols), dim=-1).numpy()
    np.testing.assert_array_equal(got, want)


# -- pass 1 -------------------------------------------------------------------


@pytest.mark.parametrize("fc_mode", ["device", "concrete"])
@pytest.mark.parametrize("kind", ["composite", "svideo"])
def test_pass1_bit_equal_over_three_applies(tmp, monkeypatch, kind, fc_mode):
    """Pass 1 alone, 64 -> 256 wide (ratio 4): three applies of one frame
    each see FrameCount 0, 1, 2 (parity 0, 1, 0)."""
    if fc_mode == "concrete":
        monkeypatch.setattr(jeng, "_CONCRETE_FC", True)
        monkeypatch.setattr(teng, "_CONCRETE_FC", True)
    path = write_pass1(tmp, 256, kind)
    frames = _u8_frames(1, 3)
    batches = [frames[i : i + 1] for i in range(3)]
    got, want, jcalls, tcalls = _both(path, (256, SRC[0]), batches, "f32", monkeypatch)
    assert jcalls and all(jcalls) and tcalls == [True] * 3
    np.testing.assert_array_equal(got, want)
    # The two parities modulate differently: frame 0 and 1 see other rows.
    assert not np.array_equal(got[0], got[1])


def test_pass1_odd_height(tmp, monkeypatch):
    """An odd source height: the parity rows are tiled, then cut."""
    path = write_pass1(tmp, 192)
    frames = _u8_frames(2, 2, (47, 64))
    got, want, _, tcalls = _both(path, (192, 47), [frames], "f32", monkeypatch)
    assert tcalls == [True, True]
    np.testing.assert_array_equal(got, want)


# -- pass 2 -------------------------------------------------------------------


@pytest.mark.parametrize("h,vh", [(48, 48), (47, 96)], ids=["rows-kept", "rows-expanded"])
@pytest.mark.parametrize("kind", ["plain", "gamma", "linear"])
def test_pass2_within_the_band_product_budget(tmp, monkeypatch, kind, h, vh):
    """Pass 2 alone on f32 frames in [-0.1, 1.1] (so that the FIR goes
    negative and the gamma's pow gives NaN), float framebuffer."""
    path = write_pass2(tmp, kind, float_framebuffer=True)
    frames = (np.random.default_rng(4).random((2, h, 64, 3), f32) * 1.2 - 0.1).astype(f32)
    got, want, jcalls, tcalls = _both(path, (32, vh), [frames], "f32", monkeypatch)
    assert jcalls and all(jcalls) and tcalls == [True, True]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    assert np.abs(got[fin].astype(np.float64) - want[fin]).max() <= 1e-5
    u8 = [np.round(np.clip(np.nan_to_num(a), 0.0, 1.0) * 255.0) for a in (got, want)]
    _assert_u8_budget(*u8)


def test_pass2_nan_rows_stay_local(tmp, monkeypatch):
    """A negative FIR under pow is NaN (llvmpipe's semantics); the row
    expansion is a gather, so the NaN of a source row lands in the output
    rows that copy it and nowhere else."""
    path = write_pass2(tmp, "gamma", float_framebuffer=True)
    frame = np.full((1, 47, 64, 3), 0.5, f32)
    frame[0, 10, 20:28] = 0.0  # a dark dash in one row: the luma FIR rings negative beside it
    frame[0, 10, 28:36] = 1.0
    got, want, _, tcalls = _both(path, (32, 96), [frame], "f32", monkeypatch)
    assert tcalls == [True]
    nan_rows = np.isnan(got[0]).any(axis=(1, 2))
    assert nan_rows.any() and not nan_rows.all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    src_rows = tk._ntsc_row_index(32, 96, 47)
    np.testing.assert_array_equal(nan_rows, src_rows == 10)


# -- the chain ----------------------------------------------------------------


@pytest.mark.parametrize("output", ["u8", "f32"])
@pytest.mark.parametrize("viewport", [(128, 48), (128, 96)])
def test_chain_matches_jax_engine(tmp, monkeypatch, viewport, output):
    """The ntsc-320px form at 256 wide: composite + gamma, two applies of
    2 frames (FrameCount 0..3); (128, 96) expands the last pass's rows."""
    path = write_chain(tmp, 256)
    frames = _u8_frames(5, 4)
    got, want, jcalls, tcalls = _both(path, viewport, [frames[:2], frames[2:]], output, monkeypatch)
    assert jcalls and all(jcalls) and tcalls == [True] * 8
    if output == "u8":
        _assert_u8_budget(got, want)
    else:
        d = np.abs(got.astype(np.float64) - want)
        assert d.max() <= 1.0 / 255.0 + 1e-6 and (d != 0).mean() <= 1e-3, (d.max(), (d != 0).mean())
    assert got.std() > 0.05  # not the stand-ins' passthrough


@pytest.mark.parametrize("pass1,pass2", [("svideo", "plain"), ("composite", "linear")])
def test_chain_variants_match_jax_engine(tmp, monkeypatch, pass1, pass2):
    path = write_chain(tmp, 256, pass1, pass2)
    got, want, _, tcalls = _both(path, (128, 96), [_u8_frames(6, 2)], "u8", monkeypatch)
    assert tcalls == [True] * 4
    _assert_u8_budget(got, want)


# -- declines -----------------------------------------------------------------

DECLINES = {
    "pass1-filter-linear": lambda d: (write_pass1(d, 256, filter_linear=True), (256, SRC[0])),
    "pass1-no-frame-count-mod": lambda d: (write_pass1(d, 256, frame_count_mod=0), (256, SRC[0])),
    "pass1-non-integer-ratio": lambda d: (write_pass1(d, 100), (100, SRC[0])),
    "pass2-filter-linear": lambda d: (write_pass2(d, filter_linear=True), (32, SRC[0])),
    "pass2-ratio": lambda d: (write_pass2(d, ratio=0.4), (26, SRC[0])),
}


@pytest.mark.parametrize("case", sorted(DECLINES))
def test_declined_preset_renders_as_with_kernels_off(tmp, monkeypatch, case):
    path, viewport = DECLINES[case](tmp)
    frames = _u8_frames(7, 2)
    got, calls = _run(torch_pkg, path, viewport, [frames], "u8", monkeypatch)
    assert calls == [False, False]
    monkeypatch.setenv("RCTPU_KERNELS", "off")
    e = torch_pkg.Engine(viewport=viewport, device="cpu")
    assert e.load_preset(path)
    np.testing.assert_array_equal(got, e.apply(_t(frames), output="u8").numpy())
    want, jcalls = _run(jax_pkg, path, viewport, [frames], "u8", monkeypatch)
    assert jcalls and not any(jcalls)  # the reference declines it too
    np.testing.assert_array_equal(got, want)


def test_registry_holds_every_reference_entry():
    assert set(tk._REGISTRY) == set(jk._REGISTRY)
    assert len(tk._REGISTRY) == 19
    for name in list(PASS1.values()) + list(PASS2.values()):
        assert tk.find_kernel(f"/any/dir/{name}") is tk._REGISTRY[name]
