"""The numerics mirrors' wrappers (retrocapture_tpu_torch/ops/cuda/mirrors.py)
on the CPU: the operator ``rctpu::mirror`` and its public functions
``sinf32``, ``logf32``, ``log2f32``, ``expf32`` and ``powf32``.

On a CPU tensor each wrapper runs its plain version (``policy.sinf32``,
``logf32``, ``log2f32``, ``expf32``), so it is held bit for bit to that
function and to the jitted JAX function the plain version mirrors, NaN
included, over random bit patterns of the whole f32 range and the edges:
+-0, +-inf, NaN, subnormals, +-120 (sin's two reductions), the exp clamps
and the inputs whose exp is subnormal (flushed to zero). The pow is held to
the reference's ``_glsl_pow`` under ``jax.jit`` at every exponent the port
uses. Under ``torch.func.vmap`` a wrapper makes one call for the batch and
gives the bits of the call on the stacked batch. ``torch.library.opcheck``
passes. Every call site of the kernel library and the mip LOD reaches the
operator: no plain function runs outside it. The kernel itself is held to
the plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import retrocapture_tpu_torch as torch_pkg
from _mattias_standin import write_standin as write_mattias
from _nnedi3_standin import write_chain as write_nnedi3
from _ntsc_standin import write_chain as write_ntsc
from retrocapture_tpu.graph import kernels as jk
from retrocapture_tpu_torch import policy
from retrocapture_tpu_torch.graph import kernels as tk
from retrocapture_tpu_torch.ops import sampling as ts
from retrocapture_tpu_torch.ops.cuda import mirrors as mr

f32 = np.float32
OPS = ["sin", "log", "log2", "exp"]
PLAIN = {"sin": policy.sinf32, "log": policy.logf32, "log2": policy.log2f32, "exp": policy.expf32}
WRAPPER = {"sin": mr.sinf32, "log": mr.logf32, "log2": mr.log2f32, "exp": mr.expf32}
JAX = {"sin": jnp.sin, "log": jnp.log, "log2": jnp.log2, "exp": jnp.exp}
# The pow exponents of the kernel library: crt-mattias's 0.3, 2.2, 0.9 and
# 0.45, and the ntsc gammas (2.5 and 2.0 of -gamma, 2.4 of -linear).
POWS = [0.3, 2.2, 0.9, 0.45, 2.5, 2.0, 2.4]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sweep(seed):
    """Random bit patterns over the whole f32 range (NaN payloads among
    them), the magnitudes each function cares about, and the edges."""
    rng = np.random.default_rng(seed)
    edges = np.array([
        0.0, -0.0, np.inf, -np.inf, np.nan, 120.0, -120.0, 119.99999, -119.99999, 120.00001,
        1e-40, -1e-40, 1e-45, -1e-45, 1.1754942e-38, 1.1754944e-38, -1.1754944e-38,
        -87.8, -87.80001, 88.8, 88.80001, 89.0, -88.0, 1e30, -3e38, 3.4028235e38,
    ], f32)
    return np.concatenate([
        rng.integers(-2**31, 2**31 - 1, 1 << 17, dtype=np.int64).astype(np.int32).view(f32),
        rng.uniform(-4000, 4000, 1 << 14).astype(f32),
        rng.uniform(-100, 100, 1 << 14).astype(f32),
        rng.uniform(-88.5, -87.0, 1 << 12).astype(f32),
        rng.uniform(0, 2, 1 << 12).astype(f32),
        edges,
    ])


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("op", OPS)
def test_wrapper_bit_equal_to_plain_and_jitted_reference(op):
    x = _sweep(20 + OPS.index(op))
    before = mr.LAUNCHES
    got = WRAPPER[op](_t(x))
    assert mr.LAUNCHES == before, "a CPU tensor launched the kernel"
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(PLAIN[op](_t(x))))
    want = np.asarray(jax.jit(JAX[op])(x))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got.numpy()[ok].view(np.int32), want[ok].view(np.int32))


@pytest.mark.parametrize("p", POWS)
def test_pow_bit_equal_to_plain_and_jitted_reference(p):
    """``powf32`` at the constant ``_glsl_pow`` computes, over [0, 2),
    negatives, random bit patterns and the edges."""
    x = _sweep(int(p * 100))
    c = float(f32(f32(f32(p) * f32(1.0 / np.log(2.0))) * f32(np.log(2.0))))
    got = mr.powf32(_t(x), c)
    assert torch.equal(_bits(got), _bits(policy.expf32(policy.logf32(_t(x)) * c)))
    assert torch.equal(_bits(tk._glsl_pow(_t(x), p)), _bits(got))
    want = np.asarray(jax.jit(lambda a: jk._glsl_pow(a, p))(x))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got.numpy()), ~ok)
    np.testing.assert_array_equal(got.numpy()[ok].view(np.int32), want[ok].view(np.int32))


def _counting_plain(monkeypatch):
    """Count the operator's CPU kernel calls (one per launch it stands for),
    by op, and the shapes it was given."""
    calls = []
    plain = mr.mirror_plain

    def rec(x, op, c=0.0):
        calls.append((op, tuple(x.shape)))
        return plain(x, op, c)

    monkeypatch.setattr(mr, "mirror_plain", rec)
    return calls


@pytest.mark.parametrize("op", OPS + ["pow"])
def test_vmap_is_one_call_of_the_stacked_batch(monkeypatch, op):
    """The operator is elementwise: under ``torch.func.vmap`` it runs once
    on the batch's tensor, whatever the batch dimension, nested too, with
    the bits of the call on the stacked batch."""
    fn = (lambda t: mr.powf32(t, 0.45)) if op == "pow" else WRAPPER[op]
    x = _t(_sweep(40)[: 6 * 5 * 7 * 64].reshape(6, 5, 7, 64))
    want = fn(x)
    calls = _counting_plain(monkeypatch)
    got = torch.func.vmap(fn)(x)
    assert calls == [(op, (6, 5, 7, 64))]
    assert torch.equal(_bits(got), _bits(want))
    got = torch.func.vmap(fn, in_dims=2, out_dims=2)(x)
    assert torch.equal(_bits(got), _bits(want))
    calls.clear()
    got = torch.func.vmap(torch.func.vmap(fn), in_dims=1)(x)
    assert len(calls) == 1
    assert torch.equal(_bits(got), _bits(want.movedim(1, 0)))


@pytest.mark.parametrize("op", OPS + ["pow"])
def test_opcheck(op):
    """Schema, fake tensor and dispatch checks of ``rctpu::mirror``, on
    inputs whose outputs are finite (the check compares with NaN unequal)."""
    x = _t(np.random.default_rng(41).uniform(0.01, 80.0, (3, 257)).astype(f32))
    torch.library.opcheck(mr._mirror_op, (x, op, 0.45 if op == "pow" else 0.0))


def test_cuda_path_raises_without_a_card():
    """A CUDA tensor goes to the kernel and nowhere else: the operator has
    its own CUDA kernel, and that path raises on a machine with no card
    (no toolkit to build it, no device to launch it) instead of computing
    on the CPU. Other devices and dtypes raise in the wrapper."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the kernel")
    assert torch._C._dispatch_has_kernel_for_dispatch_key("rctpu::mirror", "CUDA")
    before = mr.LAUNCHES
    with pytest.raises(RuntimeError):
        mr._launch(torch.zeros(8), "sin", 0.0)
    assert mr.LAUNCHES == before
    with pytest.raises(RuntimeError, match="no kernel for device"):
        mr.sinf32(torch.zeros(8, device="meta"))
    with pytest.raises(TypeError):
        mr.expf32(torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        mr._mirror(torch.zeros(8), "tan")


@pytest.fixture
def plain_outside(monkeypatch):
    """Counts the calls of the plain functions that do not come from the
    operator's CPU kernel: a call site that bypasses the operator."""
    inside = [0]
    outside = []
    plain = mr.mirror_plain

    def through_op(x, op, c=0.0):
        inside[0] += 1
        try:
            return plain(x, op, c)
        finally:
            inside[0] -= 1

    monkeypatch.setattr(mr, "mirror_plain", through_op)
    for name in ("sinf32", "logf32", "log2f32", "expf32"):
        fn = getattr(policy, name)

        def counted(*a, _fn=fn, _name=name, **k):
            if not inside[0]:
                outside.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(policy, name, counted)
    return outside


def _apply(path, viewport, hw, monkeypatch, batch=2):
    calls = _counting_plain(monkeypatch)
    e = torch_pkg.Engine(viewport=viewport, device="cpu")
    assert e.load_preset(path), e.last_error
    frames = np.random.default_rng(42).integers(0, 256, (batch,) + hw + (3,), dtype=np.uint8)
    e.apply(_t(frames), output="u8")
    assert e.shader_active is True and e.last_error is None
    return sorted({op for op, _ in calls}), calls


def test_call_sites_reach_the_operator(plain_outside, monkeypatch):
    """crt-mattias (the pows and both sines), the ntsc gamma pow, nnedi3's
    exp and the per-pixel LOD's log2 go through the operator, once for a
    batched walk, and no plain function runs outside it."""
    with tempfile.TemporaryDirectory() as td:
        ops, calls = _apply(write_mattias(td), (256, 144), (48, 64), monkeypatch)
        assert ops == ["pow", "sin"]
        assert [op for op, _ in calls].count("pow") == 4 and len(calls) == 6, calls
        assert all(shape[0] == 2 for op, shape in calls if op == "sin"), calls
        ops, _ = _apply(write_ntsc(td, 256), (128, 48), (48, 64), monkeypatch)
        assert ops == ["pow"]
        ops, _ = _apply(write_nnedi3(td, 16, "rgb"), (64, 48), (24, 32), monkeypatch)
        assert ops == ["exp"]
    calls = _counting_plain(monkeypatch)
    rng = np.random.default_rng(43)
    u = _t((rng.random((40, 56)) * 3.0 - 1.0).astype(f32))
    v = _t((rng.random((40, 56)) * 3.0 - 1.0).astype(f32))
    ts.sample2d_warped_mip(_t(rng.random((24, 32, 4), f32)), u, v, filter_linear=True, wrap_mode="repeat")
    assert calls == [("log2", (40, 56))]
    assert plain_outside == []
