"""The contracted multiply-add operator (retrocapture_tpu_torch/ops/cuda/fma.py)
on the CPU: ``rctpu::fma`` and its public functions ``fma32`` and ``fmaf32``.

On a CPU tensor the operator runs its plain version (``policy.fma32``,
``policy.fmaf32``), so it is held bit for bit to that function, NaN
included, over random bit patterns of the whole f32 range and the edges
(+-0, +-inf, NaN, subnormals, sums past ``FLT_MAX``), and to independent
references: numpy's f64 formula for ``fma32``, the exact rational value
rounded once for ``fmaf32``, and the jitted JAX ``a*b + c`` (XLA's CPU
code contracts it into an FMA). On the tie triple a = b = 1 + 2^-12,
c = 2^-80 the two modes differ as they should. What the kernel needs from
the host is checked here too: the merged geometry addresses every operand
of every broadcast form the call sites use, and the batching rule lines the
batch up in front of the result's logical dimensions (against a Python
loop over the batch, with no vmap fallback). The routing test holds the
four modules that call it to the operator. The launch plan: its cache, the
kernel path and operand kinds it picks for every form the main paths
launch (a pure function of shapes and strides), and the addresses each
path reads and writes for them; and the route a call takes (a direct
launch on a plain call with CUDA tensors, the operator under a fake tensor
mode, vmap and opcheck), with fake CUDA tensors. The kernel itself is held
to the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import tempfile
import warnings
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import retrocapture_tpu_torch as torch_pkg
from _mattias_standin import write_standin as write_mattias
from retrocapture_tpu_torch import policy
from retrocapture_tpu_torch.ops.cuda import fma as fm

f32 = np.float32
MODES = {"fma32": (fm.fma32, policy.fma32), "fmaf32": (fm.fmaf32, policy.fmaf32)}
TIE = 1 + 2.0**-12  # TIE * TIE = 1 + 2^-11 + 2^-24: half an f32 ulp above 1 + 2^-11


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x):
    return np.ascontiguousarray(x, dtype=f32).view(np.int32)


def _same_bits(got, want):
    """Bit-equal where ``want`` is not NaN, NaN where it is."""
    got, want = np.asarray(got, f32), np.asarray(want, f32)
    wn = np.isnan(want)
    return bool(np.array_equal(np.isnan(got), wn) and np.array_equal(_bits(got)[~wn], _bits(want)[~wn]))


def _edges():
    """Triples at the edges: NaN, +-inf, +-0, subnormals, FLT_MAX products
    and sums that overflow, and exact cancellations."""
    big, tiny, sub = f32(3.4028235e38), f32(1.1754944e-38), f32(1e-45)
    vals = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, big, -big, tiny, -tiny, sub, -sub,
                     f32(2.5e-39), f32(0.5), f32(3.0)], f32)
    a, b, c = np.meshgrid(vals, vals, vals, indexing="ij")
    return a.ravel(), b.ravel(), c.ravel()


def _random_bits(seed, n=1 << 16):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32).view(f32) for _ in range(3))


def _fma_np(a, b, c):
    with np.errstate(all="ignore"):
        return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f32)


def _exact_fmaf(x, y, z):
    """a*b + c in rational arithmetic, rounded once to f32 (ties to even),
    for finite operands whose result is a normal f32 or zero; numpy's f64
    value where an operand is not finite."""
    x, y, z = float(x), float(y), float(z)
    if not all(np.isfinite(v) for v in (x, y, z)):
        with np.errstate(all="ignore"):
            return f32(x * y + z)
    f = Fraction(x) * Fraction(y) + Fraction(z)
    if f == 0:
        return f32(x * y + z)  # the sign of an exact zero as IEEE gives it
    e = -149  # the subnormal quantum; raised to the f32 ulp of f
    while Fraction(2) ** (e + 24) <= abs(f):
        e += 1
    q = abs(f) / Fraction(2) ** e
    k = q.numerator // q.denominator
    rem = q - k
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and k % 2):
        k += 1
    with np.errstate(over="ignore"):
        return f32(float(k * Fraction(2) ** e) * (1 if f > 0 else -1))


# -- the operator's CPU path against the plain versions and the references --


@pytest.mark.parametrize("mode", list(MODES))
def test_random_bit_patterns_equal_plain(mode):
    """Random bit patterns of the whole f32 range (NaN payloads, infinities
    and subnormals among them): bit-equal to the plain version, NaN where
    it gives NaN."""
    op, plain = MODES[mode]
    a, b, c = _random_bits(7 if mode == "fma32" else 8)
    got = op(_t(a), _t(b), _t(c))
    assert got.dtype == torch.float32 and got.shape == (a.size,)
    assert _same_bits(got.numpy(), plain(_t(a), _t(b), _t(c)).numpy())
    if mode == "fma32":
        assert _same_bits(got.numpy(), _fma_np(a, b, c))


@pytest.mark.parametrize("mode", list(MODES))
def test_edges_equal_plain_and_reference(mode):
    """Every triple of the edge values: bit-equal to the plain version and to
    the independent reference (numpy's f64 formula, or the exact value
    rounded once)."""
    op, plain = MODES[mode]
    a, b, c = _edges()
    got = op(_t(a), _t(b), _t(c)).numpy()
    assert _same_bits(got, plain(_t(a), _t(b), _t(c)).numpy())
    if mode == "fma32":
        want = _fma_np(a, b, c)
    else:
        want = np.array([_exact_fmaf(*t) for t in zip(a, b, c)], f32)
    assert _same_bits(got, want)
    # FLT_MAX * 2 + 0 and FLT_MAX + FLT_MAX overflow to +inf in both modes.
    big = f32(3.4028235e38)
    over = op(_t(np.array([big, big], f32)), _t(np.array([2.0, 1.0], f32)), _t(np.array([0.0, big], f32)))
    assert np.isposinf(over.numpy()).all()


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["plus", "minus"])
def test_tie_triple(sign):
    """a = b = 1 + 2^-12, c = +-2^-80. The exact a*b + c lies 2^-80 off the
    f32 tie 1 + 2^-11 + 2^-24, and the f64 sum drops the 2^-80: fma32 rounds
    the tie to even (1 + 2^-11), fmaf32 rounds the exact value (up for +,
    down for -). So the modes differ for + and agree for -. The jitted JAX
    a*b + c (XLA's CPU FMA) rounds the exact value: fmaf32's bits."""
    a = np.full(4, TIE, f32)
    c = np.full(4, sign * 2.0**-80, f32)
    g32 = fm.fma32(_t(a), _t(a), _t(c)).numpy()
    gf = fm.fmaf32(_t(a), _t(a), _t(c)).numpy()
    assert (g32 == f32(1 + 2.0**-11)).all()
    assert (gf == (f32(1 + 2.0**-11 + 2.0**-23) if sign > 0 else f32(1 + 2.0**-11))).all()
    assert (g32 != gf).all() == (sign > 0)
    assert np.array_equal(_bits(g32), _bits(policy.fma32(_t(a), _t(a), _t(c)).numpy()))
    assert np.array_equal(_bits(gf), _bits(policy.fmaf32(_t(a), _t(a), _t(c)).numpy()))
    assert np.array_equal(_bits(gf), _bits(np.array([_exact_fmaf(TIE, TIE, c[0])] * 4, f32)))
    jitted = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, a, c))
    assert np.array_equal(_bits(gf), _bits(jitted))
    # Scalars are rounded to f32 first: TIE as a Python float is exact.
    assert fm.fma32(_t(a), TIE, sign * 2.0**-80).numpy()[0] == g32[0]
    assert fm.fmaf32(TIE, _t(a), sign * 2.0**-80).numpy()[0] == gf[0]


@pytest.mark.parametrize("mode", list(MODES))
def test_jitted_reference(mode):
    """Standard-normal operands (no double-rounding tie among them): both
    modes give the jitted JAX a*b + c's bits, and eager f32 (two roundings)
    differs somewhere."""
    rng = np.random.default_rng(11)
    a, b, c = (rng.standard_normal(1 << 16).astype(f32) for _ in range(3))
    got = MODES[mode][0](_t(a), _t(b), _t(c)).numpy()
    assert np.array_equal(_bits(got), _bits(np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))))
    assert ((a * b + c) != got).any()


# -- broadcast forms: the operator's result, and the kernel's addressing ----


def _forms():
    """(name, a, b, c) of every operand form the call sites pass: a Python
    or numpy scalar in each position, a 0-d tensor (a traced parameter or
    FrameCount), a view at a storage offset, [H, W, 1] against [H, W, 3],
    an expanded view, a strided channel (x[..., 2]), a [B, 1, 1] column of
    per-frame values, and three different shapes."""
    g = torch.Generator().manual_seed(5)

    def r(*shape):
        return torch.randn(shape, generator=g)

    hw3, hw1 = r(6, 7, 3), r(6, 7, 1)
    zero_d = r(2)[1]  # a 0-d view at a storage offset
    return [
        ("scalar a", 0.92, hw3, r(6, 7, 3)),
        ("scalar b", hw3, 0.4, r(6, 7, 3)),
        ("scalar c", hw3, r(6, 7, 3), np.float32(-0.25)),
        ("two scalars", hw3, 12.9898, 1.0),
        ("int scalar", hw3, 320, -0.5),
        ("0-d a", zero_d, hw3, 1.0),
        ("0-d c", r(6, 7), 1620.0, torch.tensor(0.123)),
        ("hw1 vs hw3", hw1, r(6, 7, 3), hw3),
        ("expanded", r(1, 7, 3).expand(6, 7, 3), hw1.expand(6, 7, 3), hw3),
        ("strided channel", r(6, 7, 3)[..., 2], 0.299, r(6, 7, 3)[..., 0]),
        ("per-frame column", r(4, 6, 7), 0.5, r(4, 1, 1)),
        ("three shapes", r(5, 1, 3), r(4, 1), r(3)),
        ("transposed", r(7, 6).t(), r(6, 7), r(6, 1)),
        ("four dimensions", r(3, 5, 7, 2), r(3, 1, 7, 1), r(5, 1, 2)),
        ("five dimensions", r(2, 3, 5, 7, 2), r(2, 1, 5, 1, 2), r(3, 1, 7, 1)),
    ]


FORMS = {f[0]: f[1:] for f in _forms()}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("form", list(FORMS))
def test_broadcast_forms_equal_plain(form, mode):
    op, plain = MODES[mode]
    a, b, c = FORMS[form]
    got = op(a, b, c)
    want = plain(a, b, c)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("form", list(FORMS))
def test_geometry_addresses_every_operand(form):
    """The host side of the CUDA launch: the result's dimensions merged and
    each operand's strides over them. Reading each tensor operand through
    those strides (as the kernel does, from its storage offset) gives the
    operand broadcast to the result, element for element; the merge keeps
    the element count and drops size-1 dimensions."""
    ops = [x if isinstance(x, torch.Tensor) else None for x in FORMS[form]]
    shape = torch.broadcast_shapes(*(t.shape for t in ops if t is not None))
    sizes, strides = fm._geometry(tuple(shape), ops)
    assert int(np.prod(sizes)) == int(np.prod(shape)) and 1 not in sizes and len(sizes) <= len(shape)
    for t, st in zip(ops, strides):
        if t is None:
            assert st == [0] * len(sizes)
            continue
        read = torch.as_strided(t, sizes, st, t.storage_offset())
        assert torch.equal(read.reshape(shape), t.expand(shape)), form


def test_geometry_merges_dense_operands_to_one_dimension():
    """Operands laid out as the result merge into one dimension (the kernel's
    16-byte path); a 0-d tensor reads as all-zero strides (a device
    scalar)."""
    x = torch.zeros(4, 5, 3)
    assert fm._geometry((4, 5, 3), (x, x, None)) == ([60], [[1], [1], [0]])
    assert fm._geometry((4, 5, 3), (x, torch.tensor(1.0), None)) == ([60], [[1], [0], [0]])
    assert fm._geometry((), (torch.tensor(1.0), None, None)) == ([], [[], [], []])


# -- the batching rule ------------------------------------------------------


def _batched_cases():
    """(name, operands, in_dims): the batch on a, b or c alone and on all
    three, at differing in_dims and differing logical ranks."""
    g = torch.Generator().manual_seed(9)

    def r(*shape):
        return torch.randn(shape, generator=g)

    B = 5
    return [
        ("a alone [B,3] vs [H,W,3]", (r(B, 3), r(6, 7, 3), r(6, 7, 3)), (0, None, None)),
        ("b alone, in_dim 1", (r(6, 7, 3), r(3, B), 0.5), (None, 1, None)),
        ("c alone, per-frame scalar", (r(6, 7), 1620.0, r(B)), (None, None, 0)),
        ("all three, mixed dims", (r(6, B, 7, 3), r(7, 1, B), r(B)), (1, 2, 0)),
        ("a and c, last in_dim", (r(7, 3, B), -0.25, r(6, 1, 3, B)), (-1, None, -1)),
    ]


BATCHED = {c[0]: c[1:] for c in _batched_cases()}


@pytest.fixture
def no_vmap_fallback():
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*batching rule.*")
            yield
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(BATCHED))
def test_vmap_equals_a_loop_over_the_batch(case, mode, no_vmap_fallback, monkeypatch):
    """Under torch.func.vmap the operator is one call for the batch (no
    per-example fallback) and gives the bits of the plain version frame by
    frame."""
    op, plain = MODES[mode]
    operands, dims = BATCHED[case]
    calls = []
    real = fm.fma_plain

    def counted(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(fm, "fma_plain", counted)
    got = torch.func.vmap(op, in_dims=dims)(*operands)
    assert len(calls) == 1
    B = next(x.shape[d] for x, d in zip(operands, dims) if d is not None)
    want = torch.stack([
        plain(*(x if d is None else x.select(d, i) for x, d in zip(operands, dims))) for i in range(B)
    ])
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_nested_vmap_equals_a_double_loop(no_vmap_fallback):
    """Two batch levels (apply_streams' streams around a batch): the rule
    applies level by level."""
    g = torch.Generator().manual_seed(13)
    a, c = torch.randn(3, 4, 6, 2, generator=g), torch.randn(3, generator=g)
    got = torch.func.vmap(torch.func.vmap(fm.fma32, in_dims=(0, None, None)), in_dims=(0, None, 0))(a, 0.7, c)
    want = torch.stack([torch.stack([policy.fma32(a[s, t], 0.7, c[s]) for t in range(4)]) for s in range(3)])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# -- what the wrapper refuses, and the routing -------------------------------


@pytest.mark.parametrize("bad", ["f64 tensor", "i32 tensor", "list", "all scalars", "array"])
def test_wrapper_raises_type_error(bad):
    x = torch.zeros(4)
    args = {
        "f64 tensor": (x, torch.zeros(4, dtype=torch.float64), 1.0),
        "i32 tensor": (torch.zeros(4, dtype=torch.int32), x, 1.0),
        "list": (x, [1.0, 2.0], 1.0),
        "all scalars": (1.0, 2.0, 3.0),
        "array": (x, np.zeros(4, f32), 1.0),
    }[bad]
    with pytest.raises(TypeError):
        fm.fma32(*args)


def test_cuda_path_raises_without_a_card():
    """A CUDA tensor goes to the kernel and nowhere else: the operator has a
    CUDA kernel, and on a machine with no card that path raises instead of
    computing on the CPU. Other devices raise in the wrapper."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the kernel")
    assert torch._C._dispatch_has_kernel_for_dispatch_key("rctpu::fma", "CUDA")
    before = fm.LAUNCHES
    with pytest.raises(RuntimeError):
        fm._launch(torch.zeros(8), None, None, 0.0, 1.0, 2.0, 0)
    assert fm.LAUNCHES == before
    with pytest.raises(RuntimeError, match="no kernel for device"):
        fm.fma32(torch.zeros(8, device="meta"), 1.0, 2.0)


def test_opcheck():
    """Schema, fake tensor and dispatch checks of ``rctpu::fma``."""
    g = torch.Generator().manual_seed(17)
    a, b = torch.randn(3, 5, 4, generator=g), torch.randn(5, 1, generator=g)
    torch.library.opcheck(fm._fma_op, (a, b, None, 0.0, 0.0, 0.25, 0))
    torch.library.opcheck(fm._fma_op, (None, b, torch.tensor(1.5), 2.0, 0.0, 0.0, 1))


def test_call_sites_hold_the_operator():
    """The evaluator's contraction and mix, the sampler's taps and lerps, the
    hand kernels and the FramePipeline's blit call the operator's wrappers,
    not policy's plain functions (which stay the plain versions)."""
    from retrocapture_tpu_torch.frontend import builtins
    from retrocapture_tpu_torch.graph import kernels
    from retrocapture_tpu_torch.ops import sampling
    from retrocapture_tpu_torch.runtime import pipeline

    for mod in (builtins, sampling, kernels, pipeline):
        assert mod.fma32 is fm.fma32, mod.__name__
    for mod in (sampling, kernels):
        assert mod.fmaf32 is fm.fmaf32, mod.__name__


@pytest.mark.parametrize("linear", [False, True])
def test_warp_plain_version_is_plain_torch(monkeypatch, linear):
    """The warp kernel's plain version, which the card's checks hold the
    kernel to, computes its multiply-adds with ``policy.fmaf32`` and never
    reaches the operator; it gives the bits of the main path's gather."""
    from retrocapture_tpu_torch.ops import sampling
    from retrocapture_tpu_torch.ops.cuda import warp_sample as ws

    rng = np.random.default_rng(11)
    tex = _t(rng.random((2, 9, 13, 3), dtype=f32))
    u, v = (_t(rng.uniform(-0.2, 1.2, (7, 5)).astype(f32)) for _ in range(2))
    want = sampling.sample2d_gather(tex, u, v, filter_linear=linear, wrap_mode="repeat")
    calls = []
    monkeypatch.setattr(fm, "_fma_op", lambda *a: calls.append(a))
    got = ws.warp_sample_plain(tex, u, v, filter_linear=linear, wrap_mode="repeat")
    assert calls == []
    assert _same_bits(got, want)


def test_slices_call_no_plain_fma_outside_the_operator(monkeypatch):
    """A walked apply of feedback-ghost and of the crt-mattias stand-in on
    the CPU: every policy.fma32 / fmaf32 call comes from the operator's CPU
    kernel (or from a plain mirror inside the mirrors' operator), none from
    a call site, and the operator ran."""
    inside = [0]
    outside = []
    for name in ("fma32", "fmaf32"):
        fn = getattr(policy, name)

        def counted(*a, _fn=fn, _name=name):
            if not inside[0]:
                outside.append(_name)
            return _fn(*a)

        monkeypatch.setattr(policy, name, counted)
    ops = [0]

    def through_op(*args):
        ops[0] += 1
        inside[0] += 1
        try:
            return real_cpu(*args)
        finally:
            inside[0] -= 1

    from retrocapture_tpu_torch.ops.cuda import mirrors as mr

    real_cpu, real_mirror = fm.fma_plain, mr.mirror_plain

    def mirror_inside(*args):
        inside[0] += 1
        try:
            return real_mirror(*args)
        finally:
            inside[0] -= 1

    monkeypatch.setattr(fm, "fma_plain", through_op)
    monkeypatch.setattr(mr, "mirror_plain", mirror_inside)
    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as td:
        for path, hw in (("assets/presets/feedback-ghost.glslp", (24, 32)), (write_mattias(td), (48, 64))):
            e = torch_pkg.Engine(viewport=(128, 72), device="cpu")
            assert e.load_preset(str(path)), e.last_error
            before = ops[0]
            e.apply(_t(rng.integers(0, 256, (2,) + hw + (3,), dtype=np.uint8)), output="u8")
            assert e.shader_active is True and e.last_error is None
            assert ops[0] > before, path
    assert outside == []


# -- the launch plan: its cache, the kernel's paths, and the two routes -------


def _strided(shape, strides):
    """A CPU tensor of random values laid out with ``strides``."""
    g = torch.Generator().manual_seed(sum(shape) + sum(strides))
    size = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    return torch.as_strided(torch.randn(size, generator=g), shape, strides)


# The operand forms of the main paths' launches (tools/torch_fma_forms.py,
# walked on the CPU at 192x108 from 60x80 sources; PERF.md section 4):
# (name, operands as (shape, strides) or a scalar, the kernel's path, the
# operands' kinds).
K = fm
RECORDED = [
    ("feedback-ghost row weight", (((108, 192, 4), (768, 4, 1)), ((108, 1, 1), (1, 1, 1)), ((108, 192, 4), (768, 4, 1))),
     K.TILE, (K.LINE, K.ROW, K.LINE)),
    ("feedback-ghost column weight",
     (((108, 192, 4), (768, 4, 1)), ((1, 192, 1), (192, 1, 1)), ((108, 192, 4), (768, 4, 1))),
     K.TILE, (K.LINE, K.COL, K.LINE)),
    ("feedback-ghost mix", (((108, 192, 4), (768, 4, 1)), ((4,), (1,)), ((108, 192, 4), (4, 432, 1))),
     K.TILE, (K.LINE, K.COL, K.TILE_OP)),
    ("feedback-ghost mix, traced", (((108, 192, 4), (768, 4, 1)), ((4,), (0,)), ((108, 192, 4), (4, 432, 1))),
     K.TILE, (K.LINE, K.SCALAR, K.TILE_OP)),
    ("xbr-lv2 channel", (((2, 108, 84), (27216, 252, 3)), 0.5, ((2, 108, 84), (9072, 84, 1))),
     K.TILE, (K.GATHER, K.VALUE, K.LINE)),
    ("ntsc dense", (((1, 60, 320), (19200, 320, 1)), 0.5, ((1, 60, 320), (19200, 320, 1))),
     K.DENSE, (K.DENSE_OP, K.VALUE, K.DENSE_OP)),
    ("crt-mattias col, col, -col",
     (((2, 108, 192, 3), (62208, 576, 3, 1)),) * 3, K.DENSE, (K.DENSE_OP,) * 3),
    ("crt-mattias 0-d b", (((108, 192), (192, 1)), ((), ()), ((108, 192), (192, 1))),
     K.DENSE, (K.DENSE_OP, K.SCALAR, K.DENSE_OP)),
    ("crt-mattias scan", (((108, 192), (192, 1)), 0.5, ((2, 1, 1), (1, 1, 1))), K.TILE, (K.COL, K.VALUE, K.ROW)),
    ("crt-mattias padded rows", (((2, 108, 192), (20737, 192, 1)), 0.15, 0.35), K.TILE, (K.LINE, K.VALUE, K.VALUE)),
    ("crt-mattias strided pair", (((2,), (20737,)), 0.5, 0.25), K.TILE, (K.GATHER, K.VALUE, K.VALUE)),
    ("warp-curve pixel weight",
     (((108, 192, 4), (768, 4, 1)), ((108, 192, 1), (192, 1, 1)), ((108, 192, 4), (768, 4, 1))),
     K.TILE, (K.LINE, K.GATHER, K.LINE)),
    ("warp-curve coordinates", (((108, 192, 2), (384, 2, 1)), ((108, 192, 2), (192, 1, 0)), ((2,), (0,))),
     K.TILE, (K.LINE, K.GATHER, K.SCALAR)),
    ("warp-curve channel", (((108, 192), (384, 2)), 0.5, 0.25), K.TILE, (K.GATHER, K.VALUE, K.VALUE)),
    ("FramePipeline brightness", (((108, 144, 3), (3, 324, 1)), 1.1, -0.5), K.TILE, (K.TILE_OP, K.VALUE, K.VALUE)),
    ("FramePipeline ghost mix", (((60, 80, 4), (320, 4, 1)), ((4,), (1,)), ((60, 80, 4), (320, 4, 1))),
     K.TILE, (K.LINE, K.COL, K.LINE)),
    ("apply_streams ghost row weight",
     (((4, 108, 192, 4), (82944, 768, 4, 1)), ((108, 1, 1), (1, 1, 1)), ((4, 108, 192, 4), (82944, 768, 4, 1))),
     K.TILE, (K.LINE, K.ROW, K.LINE)),
    ("mip-glow batched pair, one transposed view",
     (((4, 72, 96, 4), (27648, 4, 288, 1)), 0.5, ((4, 72, 96, 4), (27648, 4, 288, 1))),
     K.TILE, (K.TILE_OP, K.VALUE, K.TILE_OP)),
    ("apply_streams ghost mix",
     (((4, 108, 192, 4), (82944, 768, 4, 1)), ((4,), (1,)), ((4, 108, 192, 4), (82944, 4, 432, 1))),
     K.TILE, (K.LINE, K.COL, K.TILE_OP)),
]
FORMS_RECORDED = {f[0]: f[1:] for f in RECORDED}


def _recorded_operands(form):
    ops = []
    for x in FORMS_RECORDED[form][0]:
        ops.append(_strided(*x) if isinstance(x, tuple) else x)
    return ops


@pytest.mark.parametrize("form", list(FORMS_RECORDED))
def test_classification_of_recorded_forms(form):
    """The path and operand kinds the host picks for each form the main
    paths launch, as a pure function of shapes and strides: every one takes
    the dense or the tile path, none the general one."""
    _, path, kinds = FORMS_RECORDED[form]
    ops = _recorded_operands(form)
    tensors = [x if isinstance(x, torch.Tensor) else None for x in ops]
    shape = torch.broadcast_shapes(*(t.shape for t in tensors if t is not None))
    sizes, strides = fm._geometry(tuple(shape), tensors)
    got_path, dims, got_kinds, _ = fm._classify(sizes, strides, [t is not None for t in tensors])
    assert (got_path, tuple(got_kinds)) == (path, kinds), form
    if path == fm.TILE:
        assert len(dims) == 4 and 1 <= dims[3] <= 4


def _addresses(plan, k):
    """The result's element indices and operand k's element offsets that the
    kernel's path reads for them, for every element it writes (csrc/fma.cu:
    the dense path reads a dense operand at the element's index; the
    general path at the sum of the element's coordinates times the
    strides; the tile path reads operand k at r * sr + q * sq + c * sc of pixel (r, q),
    channel c, where its kind allows, and writes element (r * Q + q) * C + c
    where that is below n)."""
    g = list(plan.geometry)
    n, nd = g[0], g[1]
    dims, kinds, st = g[2:2 + nd], g[2 + nd:5 + nd], g[5 + nd + nd * k:5 + nd + nd * (k + 1)]
    if plan.path == fm.DENSE:
        e = np.arange(n)
        return e, e * st[0]
    if plan.path == fm.GENERAL:
        coords = np.meshgrid(*(np.arange(d) for d in dims), indexing="ij")
        return np.arange(n), sum(x.ravel() * s for x, s in zip(coords, st)) if nd else np.zeros(1, np.int64)
    z, r, q, c = np.meshgrid(*(np.arange(d) for d in dims), indexing="ij")
    B, R, Q, C = dims
    e = z * (n // B) + (r * Q + q) * C + c
    keep = (r * Q + q) * C + c < n // B
    sb, sr, sq, sc = st
    kind = kinds[k]
    # What each kind's loads assume of its strides.
    if kind == fm.LINE:
        assert sq == C and (sc == 1 or C == 1)
    elif kind == fm.ROW:
        assert sq == 0 and (sc == 0 or C == 1)
    elif kind == fm.COL:
        assert sr == 0
    elif kind == fm.TILE_OP:
        assert sr == C and (sc == 1 or C == 1)
    return e[keep], (z * sb + r * sr + q * sq + c * sc)[keep]


@pytest.mark.parametrize("form", list(FORMS_RECORDED) + list(FORMS))
def test_plan_addresses_every_element_once(form):
    """For every recorded form and every broadcast form of the call sites:
    the launch plan's path (dense, tile or general) writes each element of
    the result once, and reads
    each tensor operand (from its storage offset, through the strides its
    kind uses) as the operand broadcast to the result."""
    ops = _recorded_operands(form) if form in FORMS_RECORDED else FORMS[form]
    tensors = [x if isinstance(x, torch.Tensor) else None for x in ops]
    plan = fm._plan(tensors)
    shape = torch.broadcast_shapes(*(t.shape for t in tensors if t is not None))
    for k, t in enumerate(tensors):
        e, addr = _addresses(plan, k)
        assert np.array_equal(np.sort(e), np.arange(plan.numel)), form
        if t is None:
            continue
        storage = torch.as_strided(t, (int(addr.max()) + 1,), (1,), t.storage_offset())
        want = t.expand(shape).reshape(-1)[torch.from_numpy(e)]
        assert torch.equal(storage[torch.from_numpy(addr)], want), (form, k)


def test_plan_cache_hits_and_keys():
    """A cached plan is what a fresh merge and classification give; a second
    call with operands of the same shapes and strides hits it; two views of
    one shape with different strides never share an entry."""
    x = torch.randn(6, 7, 4)
    t = torch.randn(7, 6, 4).transpose(0, 1)
    w = torch.randn(4)
    fm._PLANS.clear()
    plan = fm._plan((x, w, t))
    assert fm._plan((torch.randn(6, 7, 4), torch.randn(4), torch.randn(7, 6, 4).transpose(0, 1))) is plan
    sizes, strides = fm._geometry((6, 7, 4), (x, w, t))
    path, dims, kinds, st = fm._classify(sizes, strides, [True, True, True])
    assert (plan.path, list(plan.geometry)) == (path, [6 * 7 * 4, len(dims), *dims, *kinds, *st[0], *st[1], *st[2]])
    other = fm._plan((x, w, x))
    assert other is not plan and list(other.geometry) != list(plan.geometry)
    assert fm._plan((t, w, x)) is not fm._plan((x, w, t))
    assert fm._plan((x, None, t)) is not fm._plan((x, torch.tensor(1.0), t))
    assert len(fm._PLANS) == 5


def _fake_cuda(*shape):
    """A tensor that says it lies on a card, with no card: a fake tensor
    made under FakeTensorMode."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    with mode:
        return torch.empty(shape, device="cuda"), mode


def test_route_direct_on_a_plain_call(monkeypatch):
    """A plain call on CUDA tensors launches without the dispatcher; a CPU
    tensor takes the operator (its CPU kernel, the plain version)."""
    t, _ = _fake_cuda(5, 7, 4)
    assert fm._direct((t, None, None)) and fm._direct((None, t, t))
    assert not fm._direct((torch.zeros(3), None, None))
    launched, routed = [], []
    monkeypatch.setattr(fm, "_launch", lambda *a: launched.append(a) or "launched")
    real_op = fm._fma_op
    monkeypatch.setattr(fm, "_fma_op", lambda *a: routed.append(a) or real_op(*a))
    assert fm.fma32(t, 1.5, -0.25) == "launched" and len(launched) == 1 and routed == []
    fm.fma32(torch.zeros(3), 1.5, -0.25)
    assert len(routed) == 1 and len(launched) == 1


def test_route_is_the_operator_under_fake_tensors_and_vmap(monkeypatch, no_vmap_fallback):
    """Under FakeTensorMode (a dispatch mode) the call goes through the
    operator, whose fake kernel gives the result's shape without a launch;
    under torch.func.vmap the batched call does too, and its batching rule
    makes one call of the batch through ``_fma_call``."""
    t, mode = _fake_cuda(5, 7, 4)
    monkeypatch.setattr(fm, "_launch", lambda *a: pytest.fail("launched under a dispatch mode"))
    with mode:
        assert not fm._direct((t, None, None))
        out = fm.fma32(t, torch.empty(4, device="cuda"), 0.5)
    assert out.shape == (5, 7, 4) and out.device.type == "cuda"
    decisions = []
    real_direct = fm._direct
    monkeypatch.setattr(fm, "_direct", lambda ts: decisions.append(real_direct(ts)) or decisions[-1])
    calls = []
    real_call = fm._fma_call
    monkeypatch.setattr(fm, "_fma_call", lambda *a: calls.append(a) or real_call(*a))
    x = torch.randn(3, 5, 4)
    got = torch.func.vmap(fm.fma32, in_dims=(0, None, None))(x, 1.5, torch.randn(4))
    assert decisions[0] is False and len(calls) == 2 and got.shape == (3, 5, 4)
    assert not any(torch._C._functorch.is_batchedtensor(a) for a in calls[1] if isinstance(a, torch.Tensor))


def test_opcheck_on_the_kernel_paths():
    """Schema, fake tensor and dispatch checks of ``rctpu::fma`` on operands
    of the tile path's forms (a row weight, a transposed operand)."""
    g = torch.Generator().manual_seed(19)
    a, t = torch.randn(6, 8, 4, generator=g), torch.randn(8, 6, 4, generator=g).transpose(0, 1)
    torch.library.opcheck(fm._fma_op, (a, torch.randn(6, 1, 1, generator=g), a, 0.0, 0.0, 0.0, 0))
    torch.library.opcheck(fm._fma_op, (a, torch.randn(4, generator=g), t, 0.0, 0.0, 0.0, 1))
