"""crt-mattias's epilogue operator ``rctpu::mattias_epilogue``
(ops/cuda/mattias_epilogue.py) on the CPU: its CPU kernel and its batching
rule against ``graph.kernels._mattias_epilogue_plain`` frame by frame, bit
for bit, the wrapper's CPU route, argument checks and fake kernel, the
crt-mattias hand kernel reaching the wrapper, and the kernel's constants
and build against its source.
(``_mattias_epilogue_plain`` itself is held to the JAX engine in
tests/test_torch_mattias.py; the kernel to it in tests/test_torch_cuda.py.)"""

import re
import shutil

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import _mattias_epilogue_cases as cases
import retrocapture_tpu_torch as torch_pkg
from _mattias_standin import write_standin
from retrocapture_tpu_torch.graph import kernels as tk
from retrocapture_tpu_torch.ops.cuda import _build
from retrocapture_tpu_torch.ops.cuda import mattias_epilogue as me

OH, OW = 36, 52


def _scanspeed(mode):
    return np.float32(1.3) if mode == "const" else torch.tensor(1.3)


def _op(planes, maps, fcf, ss):
    """The operator on the wrapper's arguments."""
    traced = isinstance(ss, torch.Tensor)
    return me._mattias_epilogue_op(planes[0], planes[1], planes[2], *maps, fcf, ss if traced else None,
                                   0.0 if traced else float(ss))


def _frame(planes, maps, fcf, ss, i=None):
    """``_mattias_epilogue_plain`` on frame ``i`` (None: planes of one frame)."""
    one = planes if i is None else {c: p[i] for c, p in planes.items()}
    f = fcf if i is None or fcf.dim() == 0 else fcf[i]
    return tk._mattias_epilogue_plain(one, *maps, f, ss, *maps[0].shape)


@pytest.fixture
def plain_calls(monkeypatch):
    """The CPU kernel's calls of the plain version: the planes' shape of each."""
    calls = []
    orig = me.mattias_epilogue_plain

    def spy(p0, *args):
        calls.append(tuple(p0.shape))
        return orig(p0, *args)

    monkeypatch.setattr(me, "mattias_epilogue_plain", spy)
    return calls


@pytest.mark.parametrize("mode", ["const", "traced"])
@pytest.mark.parametrize("b,oh,ow", [(3, OH, OW), (2, 7, 9), (1, 1, 1)])
def test_operator_equals_the_plain_version(plain_calls, b, oh, ow, mode):
    """A plain call of the operator on a CPU batch: one call of its CPU
    kernel, each frame the bits of ``_mattias_epilogue_plain``, NaN and
    +-inf in the planes and FrameCounts up to 2^24 - 1; the wrapper's CPU
    route gives the same bits."""
    rng = np.random.default_rng(b * 100 + oh + ow)
    maps = cases.maps(oh, ow, "cpu")
    planes = cases.planes(rng, b, oh, ow, "cpu", specials=True)
    fcf = cases.frame_counts(b, "cpu", start=b)
    ss = _scanspeed(mode)
    got = _op(planes, maps, fcf, ss)
    assert plain_calls == [(b, oh, ow)]
    assert torch.equal(me.mattias_epilogue(planes, *maps, fcf, ss), got)
    assert got.shape == (b, oh, ow, 4) and got.dtype == torch.float32
    want = torch.stack([_frame(planes, maps, fcf, ss, i) for i in range(b)])
    assert torch.equal(got, want) and not bool(got.isnan().any())


@pytest.mark.parametrize("mode", ["const", "traced"])
def test_one_frame_and_one_frame_count(monkeypatch, mode):
    """[OH, OW] planes with a 0-d FrameCount are one frame; a batch with a
    0-d FrameCount gives every frame that FrameCount; the wrapper takes the
    plain version on the CPU and never the operator."""
    rng = np.random.default_rng(3)
    maps = cases.maps(OH, OW, "cpu")
    planes = cases.planes(rng, 2, OH, OW, "cpu")
    ss = _scanspeed(mode)
    fc = torch.tensor(59.0)
    one = {c: p[1] for c, p in planes.items()}
    assert torch.equal(_op(one, maps, fc, ss), _frame(one, maps, fc, ss))
    want = torch.stack([_frame(planes, maps, fc, ss, i) for i in range(2)])
    assert torch.equal(_op(planes, maps, fc, ss), want)
    monkeypatch.setattr(me, "_mattias_epilogue_op", lambda *a: pytest.fail("the operator ran on the CPU"))
    assert torch.equal(me.mattias_epilogue(one, *maps, fc, ss), _frame(one, maps, fc, ss))
    assert torch.equal(me.mattias_epilogue(planes, *maps, fc, ss), want)


@pytest.mark.parametrize("mode", ["const", "traced"])
def test_vmap_over_frames_is_one_call(plain_calls, mode):
    """``torch.func.vmap`` over frames that share the maps (what
    ``replay.stateless_batch`` does): the batching rule calls the kernel
    once with the whole batch, with a FrameCount a frame or one for the
    batch, and each frame gets its own RGBA."""
    rng = np.random.default_rng(4)
    b = 4
    maps = cases.maps(OH, OW, "cpu")
    planes = cases.planes(rng, b, OH, OW, "cpu")
    fcf = cases.frame_counts(b, "cpu")
    ss = _scanspeed(mode)

    def one(p0, p1, p2, f):
        return _op({0: p0, 1: p1, 2: p2}, maps, f, ss)

    got = torch.func.vmap(one)(planes[0], planes[1], planes[2], fcf)
    assert plain_calls == [(b, OH, OW)]
    assert torch.equal(got, torch.stack([_frame(planes, maps, fcf, ss, i) for i in range(b)]))
    got = torch.func.vmap(one, in_dims=(0, 0, 0, None))(planes[0], planes[1], planes[2], fcf[3])
    assert plain_calls == [(b, OH, OW)] * 2
    assert torch.equal(got, torch.stack([_frame(planes, maps, fcf[3], ss, i) for i in range(b)]))


@pytest.mark.parametrize("per_frame", [True, False], ids=["fc-a-frame", "fc-a-batch"])
def test_vmap_over_batches_of_frames(plain_calls, per_frame):
    """``torch.func.vmap`` over calls that already hold a batch of frames
    each ([B2, OH, OW] planes): one call of the kernel with every frame, a
    FrameCount a frame or one a batch broadcast over its frames."""
    rng = np.random.default_rng(9)
    n, b2 = 2, 3
    maps = cases.maps(OH, OW, "cpu")
    planes = {c: p.reshape(n, b2, OH, OW) for c, p in cases.planes(rng, n * b2, OH, OW, "cpu").items()}
    fcf = cases.frame_counts(n * b2, "cpu").reshape(n, b2) if per_frame else cases.frame_counts(n, "cpu")
    ss = torch.tensor(0.9)
    got = torch.func.vmap(lambda p0, p1, p2, f: _op({0: p0, 1: p1, 2: p2}, maps, f, ss))(
        planes[0], planes[1], planes[2], fcf)
    assert plain_calls == [(n * b2, OH, OW)] and got.shape == (n, b2, OH, OW, 4)
    for i in range(n):
        one = {c: p[i] for c, p in planes.items()}
        f = fcf[i] if per_frame else fcf[i].expand(b2)
        assert torch.equal(got[i], torch.stack([_frame(one, maps, f, ss, j) for j in range(b2)]))


def test_vmap_with_per_frame_maps(plain_calls):
    """Batched maps (a CURVATURE a frame): one call a frame, each with that
    frame's maps."""
    rng = np.random.default_rng(5)
    b = 3
    per = [cases.maps(OH, OW, "cpu", curvature=0.3 * i) for i in range(b)]
    planes = cases.planes(rng, b, OH, OW, "cpu")
    fcf = cases.frame_counts(b, "cpu")
    ss = torch.tensor(0.8)

    def own(p0, p1, p2, f, *m):
        return _op({0: p0, 1: p1, 2: p2}, m, f, ss)

    got = torch.func.vmap(own)(planes[0], planes[1], planes[2], fcf, *(torch.stack([m[k] for m in per])
                                                                       for k in range(6)))
    assert plain_calls == [(OH, OW)] * b
    assert torch.equal(got, torch.stack([_frame(planes, per[i], fcf, ss, i) for i in range(b)]))


def test_fake_kernel_gives_the_shape():
    rng = np.random.default_rng(6)
    maps = cases.maps(OH, OW, "cpu")
    planes = cases.planes(rng, 2, OH, OW, "cpu")
    fcf = cases.frame_counts(2, "cpu")
    with FakeTensorMode() as mode:
        fake = {c: mode.from_tensor(p) for c, p in planes.items()}
        fmaps = [mode.from_tensor(m) for m in maps]
        ff = mode.from_tensor(fcf)
        assert me.mattias_epilogue(fake, *fmaps, ff, np.float32(1.0)).shape == (2, OH, OW, 4)
        assert me.mattias_epilogue(fake, *fmaps, ff, mode.from_tensor(torch.tensor(1.0))).shape == (2, OH, OW, 4)
        assert me.mattias_epilogue({c: p[0] for c, p in fake.items()}, *fmaps, ff[0], np.float32(1.0)).shape == (
            OH, OW, 4)


def test_wrapper_raises():
    rng = np.random.default_rng(7)
    maps = cases.maps(OH, OW, "cpu")
    planes = cases.planes(rng, 2, OH, OW, "cpu")
    fcf = cases.frame_counts(2, "cpu")
    ss = np.float32(1.0)
    bad_maps = {
        "bv of another size": (maps[0][:-1],) + maps[1:],
        "vig without its channel": maps[:3] + (maps[3][..., 0],) + maps[4:],
        "inside as f32": maps[:5] + (maps[5].float(),),
        "uv_u as f64": (maps[0], maps[1].double()) + maps[2:],
        "comb on another device": maps[:4] + (maps[4].to("meta"),) + maps[5:],
    }
    with pytest.raises(TypeError):
        me.mattias_epilogue({c: p.double() for c, p in planes.items()}, *maps, fcf, ss)
    with pytest.raises(ValueError):
        me.mattias_epilogue({c: p[None] for c, p in planes.items()}, *maps, fcf, ss)  # [1, B, OH, OW]
    with pytest.raises(ValueError):
        me.mattias_epilogue({**planes, 1: planes[1][:, :, :-1]}, *maps, fcf, ss)  # planes of two sizes
    for name, bad in bad_maps.items():
        with pytest.raises(ValueError):
            me.mattias_epilogue(planes, *bad, fcf, ss)
            pytest.fail(name)
    with pytest.raises(ValueError):
        me.mattias_epilogue(planes, *maps, fcf[:1], ss)  # a FrameCount for some frames
    with pytest.raises(ValueError):
        me.mattias_epilogue(planes, *maps, fcf.double(), ss)
    with pytest.raises(ValueError):
        me.mattias_epilogue(planes, *maps, fcf, torch.tensor([1.0]))  # SCANSPEED not 0-d
    with pytest.raises(RuntimeError):
        me.mattias_epilogue({c: p.to("meta") for c, p in planes.items()}, *(m.to("meta") for m in maps),
                            fcf.to("meta"), ss)


def _physical(x):
    """The whole batch that ``x`` is a frame of under ``torch.func.vmap``,
    frames first."""
    while torch._C._functorch.is_batchedtensor(x):
        bdim = torch._C._functorch.maybe_get_bdim(x)
        x = torch._C._functorch.get_unwrapped(x).movedim(bdim, 0)
    return x


@pytest.mark.parametrize("mode", ["const", "traced"])
def test_hand_kernel_reaches_the_wrapper(tmp_path, monkeypatch, mode):
    """``_mattias_kernel`` computes its epilogue through ``mattias_epilogue``:
    in a batched apply on the CPU the wrapper is called once, inside the
    walk's vmap, with the planes the blur left; it takes the plain version
    there (the operator does not run) and gives each frame what
    ``_mattias_epilogue_plain`` gives it."""
    path = write_standin(str(tmp_path))
    calls = []
    orig = me.mattias_epilogue

    def spy(planes, *args):
        out = orig(planes, *args)
        calls.append(([_physical(planes[c]) for c in range(3)], args, _physical(out)))
        return out

    monkeypatch.setattr(me, "mattias_epilogue", spy)
    monkeypatch.setattr(me, "_mattias_epilogue_op", lambda *a: pytest.fail("the operator ran on the CPU"))
    frames = np.random.default_rng(8).integers(0, 256, (3, 24, 32, 3), dtype=np.uint8)
    e = torch_pkg.Engine(viewport=(128, 72), device="cpu")
    assert e.load_preset(path), e.last_error
    if mode == "traced":
        e.set_param_mode("traced")
    out = e.apply(torch.from_numpy(frames), output="u8")
    assert e.shader_active is True and e.last_error is None and out.shape == (3, 72, 128, 3)
    assert len(calls) == 1
    planes, args, rgba = calls[0]
    maps, fcf, ss = args[:6], _physical(args[6]), args[7]
    assert [tuple(p.shape) for p in planes] == [(3, 72, 128)] * 3 and tuple(fcf.shape) == (3,)
    assert isinstance(ss, torch.Tensor) == (mode == "traced")
    want = torch.stack([_frame(dict(enumerate(planes)), maps, fcf, ss, i) for i in range(3)])
    assert torch.equal(rgba, want)


def _struct_fields(source: str, name: str):
    """The number of scalars in ``struct <name> { ... }`` of a CUDA source,
    an array counting its length."""
    body = re.search(r"struct " + name + r" \{(.*?)\n\};", source, re.S).group(1)
    n = 0
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        for item in decl.split(" ", 1)[1].split(","):
            m = re.search(r"\[(\d+)\]", item)
            n += int(m.group(1)) if m else 1
    return n


@pytest.mark.parametrize("scanspeed", [None, 1.0, 0.37])
def test_constants_match_the_kernel_source(scanspeed):
    """The host's constants fill the kernel's ``Narrow`` (f32) and ``Wide``
    (f64) structs field for field, each an f32 value; the constant
    SCANSPEED's factor is the plain version's fold."""
    source = (_build.CSRC / "mattias_epilogue.cu").read_text()
    narrow, wide = me._constants(1080, scanspeed)
    assert narrow.dtype == np.float32 and wide.dtype == np.float64
    assert (narrow.size, wide.size) == (_struct_fields(source, "Narrow"), _struct_fields(source, "Wide"))
    assert np.array_equal(wide.astype(np.float32).astype(np.float64), wide)
    assert wide[2] == 1620.0  # f32(oh) * 1.5
    f32 = np.float32
    t60 = f32(1.0) / f32(60.0)
    assert narrow[12] == t60
    assert narrow[14] == (f32(0.0) if scanspeed is None else f32(f32(t60 * f32(scanspeed)) * f32(3.5)))


def test_the_build_hash_covers_the_headers(tmp_path, monkeypatch):
    """A kernel's library name carries the hash of its source and of the
    headers it includes: an edit of ``numerics.cuh`` renames the mirrors',
    fma's, the epilogue's and nnedi3's libraries and no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._library_path(n) for n in _build.KERNELS}
    (csrc / "numerics.cuh").write_text((csrc / "numerics.cuh").read_text() + "\n// edited\n")
    after = {n: _build._library_path(n) for n in _build.KERNELS}
    changed = sorted(n for n in _build.KERNELS if before[n] != after[n])
    assert changed == ["fma", "mattias_epilogue", "mirrors", "nnedi3"]
    assert all("-fmad=false" in _build.EXTRA_FLAGS[n] for n in changed)
