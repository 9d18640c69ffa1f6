"""nnedi3's operator ``rctpu::nnedi3`` (ops/cuda/nnedi3.py) on the CPU: its
CPU kernel and its batching rule against ``graph.kernels._nnedi3_plain``
frame by frame, bit for bit, the wrapper's CPU route, argument checks and
fake kernel, the nnedi3 entry reaching the wrapper, the plain version
against the entry's eager section as it was before the kernel, and the
kernel's net layout against the weight parse.
(``_nnedi3_plain`` itself is held to the JAX engine in
tests/test_torch_nnedi3.py; the kernel to it in tests/test_torch_cuda.py.)"""

import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import _nnedi3_cases as cases
import retrocapture_tpu_torch as torch_pkg
from _nnedi3_standin import PASSTHROUGH_GLSL, net_text, write_chain, write_one_pass, write_shader
from retrocapture_tpu_torch.graph import kernels as tk
from retrocapture_tpu_torch.ops.cuda import _build, mirrors
from retrocapture_tpu_torch.ops.cuda import nnedi3 as nn

H, W = 13, 17


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: torch's CPU thread pool only adds its start-up cost."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def plain_calls(monkeypatch):
    """The CPU kernel's calls of the plain version: the texture's shape of each."""
    calls = []
    orig = nn.nnedi3_plain

    def spy(tex, *args):
        calls.append(tuple(tex.shape))
        return orig(tex, *args)

    monkeypatch.setattr(nn, "nnedi3_plain", spy)
    return calls


def _frames(tex, wt, bias, axis, comps):
    """``_nnedi3_plain`` frame by frame over [B, h, w, 4]."""
    return torch.stack([tk._nnedi3_plain(t, wt, bias, axis, comps) for t in tex])


def _before(tex, w1, w2, b1, b2, axis: int, comps: int):
    """The nnedi3 entry's eager section as it stood before the kernel
    (graph/kernels.py), on one frame and the parsed weights."""
    h, w = int(tex.shape[0]), int(tex.shape[1])
    oh, ow = (2 * h, w) if axis == 0 else (h, 2 * w)
    dev = tex.device
    wt = torch.from_numpy(np.concatenate([w1, w2], axis=1).T.astype(np.float64))
    b1, b2 = torch.from_numpy(b1)[:, None], torch.from_numpy(b2)[:, None]
    nns = b1.shape[0]
    pad = ((1, 2), (3, 4)) if axis == 0 else ((3, 4), (1, 2))
    src = tex[..., :comps].to(torch.float32)
    rows = torch.arange(-pad[0][0], h + pad[0][1], device=dev).clamp(0, h - 1)
    cols = torch.arange(-pad[1][0], w + pad[1][1], device=dev).clamp(0, w - 1)
    padded = src.index_select(0, rows).index_select(1, cols)
    taps = []
    for s in range(8):
        for cw in range(4):
            du, dv = s // 2 - 1, (s % 2) * 4 + cw - 3
            dy, dx = (du, dv) if axis == 0 else (dv, du)
            oy, ox = dy + pad[0][0], dx + pad[1][0]
            taps.append(padded[oy : oy + h, ox : ox + w])
    S = torch.stack(taps).reshape(32, -1)
    S64 = S.to(torch.float64)
    ssum = S64.sum(dim=0).to(torch.float32)
    sumsq = (S64 * S64).sum(dim=0).to(torch.float32)
    mstd0 = ssum * float(np.float32(1.0 / 32.0))
    mstd1 = sumsq * float(np.float32(1.0 / 32.0)) - mstd0 * mstd0
    ok = mstd1 >= float(np.float32(1.192092896e-7))
    mstd2 = torch.where(ok, 1.0 / torch.sqrt(mstd1), 0.0)
    mstd1 = mstd1 * mstd2
    d = (wt @ S64).to(torch.float32)
    e1 = mirrors.expf32(d[:nns] * mstd2 + b1)
    s2 = d[nns:] * mstd2 + b2
    wsum = e1.to(torch.float64).sum(dim=0).to(torch.float32)
    vsum = (e1 * (s2 / (1.0 + torch.abs(s2)))).to(torch.float64).sum(dim=0).to(torch.float32)
    pred = torch.clamp(mstd0 + 5.0 * vsum / wsum * mstd1, 0.0, 1.0).reshape(h, w, comps)
    out = torch.stack([src, pred], dim=1 if axis == 0 else 2).reshape(oh, ow, comps)
    ones = torch.ones((oh, ow, 4 - comps), dtype=torch.float32, device=dev)
    return torch.cat([out, ones], dim=-1)


@pytest.mark.parametrize("form", cases.FORMS, ids=cases.form_id)
def test_plain_version_gives_the_entrys_bits(form):
    """``_nnedi3_plain`` on ``net``'s arrays gives the bits of the entry's
    eager section as it was before the kernel, on odd sizes, one row and
    one column, flat windows (variance under the threshold) and textures of
    all 0 and all 1."""
    nns, axis, comps = form
    rng = np.random.default_rng(nns + 10 * axis + comps)
    w1, w2, b1, b2 = cases.weights(nns, seed=nns + axis)
    wt, bias = (torch.from_numpy(a) for a in nn.net(w1, w2, b1, b2))
    texs = [cases.texture(rng, (H, W, 4), "cpu"), cases.texture(rng, (H, W, 4), "cpu", flat=True),
            cases.texture(rng, (1, 9, 4), "cpu"), cases.texture(rng, (9, 1, 4), "cpu"),
            torch.zeros((5, 6, 4)), torch.ones((5, 6, 4))]
    for tex in texs:
        got = tk._nnedi3_plain(tex, wt, bias, axis, comps)
        assert torch.equal(got, _before(tex, w1, w2, b1, b2, axis, comps)), tuple(tex.shape)
        assert torch.equal(nn.nnedi3(tex, wt, bias, axis=axis, comps=comps), got)


@pytest.mark.parametrize("b,h,w", [(3, H, W), (2, 1, 5), (1, 4, 1)])
@pytest.mark.parametrize("axis", [0, 1])
def test_operator_equals_the_plain_version(plain_calls, b, h, w, axis):
    """A plain call of the operator on a CPU batch: one call of its CPU
    kernel, each frame the bits of ``_nnedi3_plain``; the wrapper's CPU
    route gives the same bits; the even rows (pass 1) or columns (pass 2)
    are the source's channels, the rest of the channels 1."""
    rng = np.random.default_rng(b * 100 + h + w + axis)
    wt, bias = cases.net(16, 1, "cpu")
    tex = cases.texture(rng, (b, h, w, 4), "cpu")
    got = nn._nnedi3_op(tex, wt, bias, axis, 3)
    assert plain_calls == [(b, h, w, 4)]
    assert got.shape == ((b, 2 * h, w, 4) if axis == 0 else (b, h, 2 * w, 4)) and got.dtype == torch.float32
    assert torch.equal(got, _frames(tex, wt, bias, axis, 3))
    assert torch.equal(nn.nnedi3(tex, wt, bias, axis=axis, comps=3), got)
    even = got[:, 0::2] if axis == 0 else got[:, :, 0::2]
    assert torch.equal(even[..., :3], tex[..., :3]) and bool((got[..., 3] == 1.0).all())


def test_one_frame_and_the_wrapper_route(monkeypatch):
    """[h, w, 4] is one frame; the wrapper takes the plain version on the
    CPU and never the operator."""
    rng = np.random.default_rng(3)
    wt, bias = cases.net(32, 2, "cpu")
    tex = cases.texture(rng, (H, W, 4), "cpu")
    want = tk._nnedi3_plain(tex, wt, bias, 1, 1)
    assert torch.equal(nn._nnedi3_op(tex, wt, bias, 1, 1), want)
    monkeypatch.setattr(nn, "_nnedi3_op", lambda *a: pytest.fail("the operator ran on the CPU"))
    assert torch.equal(nn.nnedi3(tex, wt, bias, axis=1, comps=1), want)
    batch = torch.stack([tex, tex.flip(0)])
    assert torch.equal(nn.nnedi3(batch, wt, bias, axis=1, comps=1), _frames(batch, wt, bias, 1, 1))


@pytest.mark.parametrize("axis", [0, 1])
def test_vmap_over_frames_is_one_call(plain_calls, axis):
    """``torch.func.vmap`` over frames that share the net (what
    ``replay.stateless_batch`` does): the batching rule calls the kernel once
    with the whole batch, and each frame gets its own output."""
    rng = np.random.default_rng(4)
    wt, bias = cases.net(16, 3, "cpu")
    tex = cases.texture(rng, (4, H, W, 4), "cpu")
    got = torch.func.vmap(lambda t: nn._nnedi3_op(t, wt, bias, axis, 3))(tex)
    assert plain_calls == [(4, H, W, 4)]
    assert torch.equal(got, _frames(tex, wt, bias, axis, 3))
    # The frames on another dimension of the batched tensor.
    got = torch.func.vmap(lambda t: nn._nnedi3_op(t, wt, bias, axis, 3), in_dims=2)(tex.movedim(0, 2))
    assert plain_calls == [(4, H, W, 4)] * 2 and torch.equal(got, _frames(tex, wt, bias, axis, 3))


def test_vmap_over_batches_of_frames(plain_calls):
    """``torch.func.vmap`` over calls that already hold a batch of frames
    each ([B2, h, w, 4]): one call of the kernel with every frame."""
    rng = np.random.default_rng(9)
    n, b2 = 2, 3
    wt, bias = cases.net(16, 4, "cpu")
    tex = cases.texture(rng, (n, b2, H, W, 4), "cpu")
    got = torch.func.vmap(lambda t: nn._nnedi3_op(t, wt, bias, 0, 1))(tex)
    assert plain_calls == [(n, b2, H, W, 4)] and got.shape == (n, b2, 2 * H, W, 4)
    for i in range(n):
        assert torch.equal(got[i], _frames(tex[i], wt, bias, 0, 1))


def test_vmap_with_per_frame_nets(plain_calls):
    """A net a frame: one call a frame, each with its own net."""
    rng = np.random.default_rng(5)
    nets = [cases.net(16, 10 + i, "cpu") for i in range(3)]
    tex = cases.texture(rng, (3, H, W, 4), "cpu")
    wts, biases = torch.stack([n[0] for n in nets]), torch.stack([n[1] for n in nets])
    got = torch.func.vmap(lambda t, wt, bias: nn._nnedi3_op(t, wt, bias, 1, 3))(tex, wts, biases)
    assert plain_calls == [(H, W, 4)] * 3
    for i in range(3):
        assert torch.equal(got[i], tk._nnedi3_plain(tex[i], *nets[i], 1, 3))


def test_fake_kernel_gives_the_shape():
    rng = np.random.default_rng(6)
    wt, bias = cases.net(64, 5, "cpu")
    tex = cases.texture(rng, (2, H, W, 4), "cpu")
    with FakeTensorMode() as mode:
        ft, fw, fb = (mode.from_tensor(x) for x in (tex, wt, bias))
        assert nn._nnedi3_op(ft, fw, fb, 0, 3).shape == (2, 2 * H, W, 4)
        assert nn._nnedi3_op(ft, fw, fb, 1, 1).shape == (2, H, 2 * W, 4)
        assert nn._nnedi3_op(ft[0], fw, fb, 1, 3).shape == (H, 2 * W, 4)


def test_wrapper_raises():
    rng = np.random.default_rng(7)
    wt, bias = cases.net(32, 6, "cpu")
    tex = cases.texture(rng, (2, H, W, 4), "cpu")
    call = lambda t=tex, w=wt, b=bias, axis=0, comps=3: nn.nnedi3(t, w, b, axis=axis, comps=comps)  # noqa: E731
    with pytest.raises(TypeError):
        call(t=tex.double())
    bad = {
        "axis 2": dict(axis=2),
        "comps 2": dict(comps=2),
        "[1, B, h, w, 4]": dict(t=tex[None]),
        "two channels for -rgb": dict(t=tex[..., :2]),
        "a net of 8 neurons": dict(w=wt[:16], b=bias[:16]),
        "weights as f32": dict(w=wt.float()),
        "weights of another net's size": dict(w=wt[:, :16]),
        "biases as f64": dict(b=bias.double()),
        "the net on another device": dict(w=wt.to("meta"), b=bias.to("meta")),
    }
    for name, kw in bad.items():
        with pytest.raises(ValueError):
            call(**kw)
            pytest.fail(name)
    with pytest.raises(RuntimeError):
        call(t=tex.to("meta"), w=wt.to("meta"), b=bias.to("meta"))


def test_net_layout_matches_the_parse(tmp_path):
    """``net`` of the parsed weights: row j < nns neuron j's sum1 weights,
    row nns + j its sum2 weights, column 4 s + c component c of sample s,
    f64 C-contiguous; the biases b1 then b2 in f32. The kernel reads the
    same layout."""
    for nns in nn.NNS:
        path = write_shader(str(tmp_path), f"nnedi3-nns{nns}-win8x4-pass1-rgb.glsl", seed=nns)
        w1, w2, b1, b2 = tk._nnedi3_weights(path)
        wt, bias = nn.net(w1, w2, b1, b2)
        assert wt.dtype == np.float64 and wt.shape == (2 * nns, 32) and wt.flags.c_contiguous
        assert bias.dtype == np.float32 and bias.shape == (2 * nns,)
        for j in (0, nns // 2, nns - 1):
            assert np.array_equal(wt[j], w1[:, j].astype(np.float64))
            assert np.array_equal(wt[nns + j], w2[:, j].astype(np.float64))
        assert np.array_equal(bias, np.concatenate([b1, b2]))
    source = (_build.CSRC / "nnedi3.cu").read_text()
    assert "w + (j0 + g) * kTaps + k" in source and "w + (NNS + j0 + g) * kTaps + k" in source
    assert "bias[j0 + g], b2 = bias[NNS + j0 + g]" in source
    assert _build.KERNELS["nnedi3"][0] == "nnedi3_launch" and "-fmad=false" in _build.EXTRA_FLAGS["nnedi3"]


def _physical(x):
    """The whole batch that ``x`` is a frame of under ``torch.func.vmap``."""
    while torch._C._functorch.is_batchedtensor(x):
        bdim = torch._C._functorch.maybe_get_bdim(x)
        x = torch._C._functorch.get_unwrapped(x).movedim(bdim, 0)
    return x


def test_entry_reaches_the_wrapper(tmp_path, monkeypatch):
    """The nnedi3 entry computes each pass through ``nnedi3``: in a batched
    apply on the CPU the wrapper is called once a pass, inside the walk's
    vmap, with the kept net; it takes the plain version there (the operator
    does not run) and gives each frame what ``_nnedi3_plain`` gives it."""
    path = write_chain(str(tmp_path), 16, "rgb", seed=2, height=48)
    calls = []
    orig = nn.nnedi3

    def spy(tex, wt, bias, **kw):
        out = orig(tex, wt, bias, **kw)
        calls.append((_physical(tex), wt, bias, kw, _physical(out)))
        return out

    monkeypatch.setattr(nn, "nnedi3", spy)
    monkeypatch.setattr(nn, "_nnedi3_op", lambda *a: pytest.fail("the operator ran on the CPU"))
    frames = np.random.default_rng(8).integers(0, 256, (3, 24, 32, 3), dtype=np.uint8)
    e = torch_pkg.Engine(viewport=(64, 48), device="cpu")
    assert e.load_preset(path), e.last_error
    out = e.apply(torch.from_numpy(frames), output="u8")
    assert e.shader_active is True and e.last_error is None and out.shape == (3, 48, 64, 3)
    assert [(tuple(c[0].shape), c[3]) for c in calls] == [((3, 24, 32, 4), {"axis": 0, "comps": 3}),
                                                          ((3, 48, 32, 4), {"axis": 1, "comps": 3})]
    for tex, wt, bias, kw, got in calls:
        assert wt.dtype == torch.float64 and wt.shape == (32, 32) and bias.shape == (32,)
        assert torch.equal(got, _frames(tex, wt, bias, kw["axis"], kw["comps"]))


def test_entry_declines_a_net_without_a_kernel_form(tmp_path):
    """A shader whose text holds a neuron count the kernel has no form for
    (8 lines under an nns16 name) leaves the pass to the evaluator, which
    runs the stand-in's passthrough body."""
    name = "nnedi3-nns16-win8x4-pass1-luma.glsl"
    path = write_one_pass(str(tmp_path), name, float_framebuffer=True)
    with open(os.path.join(str(tmp_path), name), "w") as f:
        f.write(PASSTHROUGH_GLSL.replace("{net}", net_text(8, 0)))
    e = torch_pkg.Engine(viewport=(32, 48), device="cpu")
    assert e.load_preset(path), e.last_error
    frames = np.random.default_rng(11).integers(0, 256, (2, 24, 32, 3), dtype=np.uint8)
    e.apply(torch.from_numpy(frames), output="u8")
    stats = e.replay_stats()
    assert stats["nnedi3_declined"] == 2 and stats["nnedi3_passes"] == 0
