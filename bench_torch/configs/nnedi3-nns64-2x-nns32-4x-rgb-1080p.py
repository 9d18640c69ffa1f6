"""The plain reference of nnedi3-nns64-2x-nns32-4x-rgb's four nnedi3 passes
(libretro glsl-shaders nnedi3/nnedi3-nns64-2x-nns32-4x-rgb.glslp:
nnedi3-nns64-win8x4-pass1-rgb.glsl, -pass2-rgb.glsl, then the nns32 pair),
then the window's viewport blit, written out in plain PyTorch.

It imports nothing of the program. The nets are the ones the benchmark's
preset writer puts in the stand-in shaders (``presets/
nnedi3-nns64-2x-nns32-4x-rgb.py``, ``weights()``), not the program's
parse of them. Everything the shaders compute is computed in ``dtype``
(float32 as the shaders state; the control runs it in bfloat16), pixel by
pixel as the fragments compute it:

* Pass 1 of a pair doubles y (source 1 x 2, NEAREST, clamp_to_edge):
  output row ``2r`` is source row ``r``; row ``2r + 1`` is predicted from
  the 8 x 4 window of source rows ``r - 1 .. r + 2`` and columns
  ``x - 3 .. x + 4`` (sample ``s`` of the window, component ``c``: row
  ``r + s // 2 - 1``, column ``x + (s % 2) * 4 + c - 3``; weight ``4 s +
  c``), clamped to the edge. Pass 2 is pass 1 transposed: it doubles x,
  its window 4 rows by 8 columns. Each of R, G and B is predicted alone.
* The prediction: the window's mean and variance (``sum(x²) / 32 -
  mean²``); where the variance is at least the shader's epsilon
  ``1.192092896e-7``, its square root ``std`` and ``rstd = 1 / std``, else
  both 0; for each neuron ``k`` the sums ``sum1 = w1_k · x`` and ``sum2 =
  w2_k · x``, then ``e = exp(sum1 · rstd + b1_k)`` and the softsign ``t =
  sum2 · rstd + b2_k``, ``t / (1 + |t|)``; ``wsum`` the sum of the ``e``,
  ``vsum`` the sum of ``e`` times the softsign; the value ``mean + 5 · vsum
  / wsum · std``, clamped to [0, 1].
* Each pass is stored into an RGBA8 framebuffer (clamp, round to the
  nearest level), which the next pass reads.
* The window's blit stretches the last pass (960 x 1280 at the
  benchmark's size) to the viewport: LINEAR, clamp_to_edge, texel centres
  at half-texels, rows then columns; then the u8 pack.

Departures from the published shaders:

* The nets are seeded stand-ins, not the trained weights (the preset
  writer's docstring).
* The published preset ends in the jinc2 passes to the viewport, which
  the repo does not carry: the blit takes their place, as in the
  configuration the program runs (its ``reduced``).
* The program accumulates the window's sums and each neuron's dot in
  float64 and rounds each once to float32; the reference sums in
  ``dtype``, as the GLSL does, in torch's order (a matrix product for the
  dots, with TF32 off). They differ by a few units in the last place,
  which an RGBA8 store can turn into one level.
* ``exp`` is torch's; the program takes XLA's inline polynomial. The
  program takes ``rstd`` as ``1 / sqrt(var)`` and ``std`` as ``var ·
  rstd``. Each is a unit in the last place or two.
* The blit's weights are computed in float32 in every ``dtype``: they
  are the sampler's, not the shaders' arithmetic.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

EPS = 1.192092896e-7  # the shaders' variance floor
_WRITER = Path(__file__).resolve().parents[1] / "presets" / "nnedi3-nns64-2x-nns32-4x-rgb.py"
_NETS: dict = {}


def _writer():
    spec = importlib.util.spec_from_file_location("nnedi3_4x_writer", _WRITER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def passes(dev, dtype):
    """[(axis, (W1, W2, B1, B2)), ...]: each pass's doubled axis (0 y, 1
    x) and its net as ``dtype`` tensors on ``dev``."""
    key = (str(dev), dtype)
    if key not in _NETS:
        writer = _writer()
        nets = writer.weights()
        _NETS[key] = [(0 if "-pass1-" in name else 1,
                       tuple(torch.from_numpy(a).to(dev).to(dtype) for a in nets[name]))
                      for name in writer.PASSES]
    return _NETS[key]


def window(tex, axis: int):
    """The 8 x 4 window (4 x 8 for pass 2) of every source pixel of ``tex
    [h, w, 3]``, clamped to the edge: ``[h, w, 3, 32]``, entry ``4 s + c``
    as the shader's weights order it."""
    h, w = tex.shape[0], tex.shape[1]
    dev = tex.device
    q = torch.arange(32, device=dev)
    minor, major = q // 8 - 1, (q // 4) % 2 * 4 + q % 4 - 3  # s = q // 4: s // 2 - 1, (s % 2) * 4 + c - 3
    dy, dx = (minor, major) if axis == 0 else (major, minor)
    ys = (torch.arange(h, device=dev)[:, None] + dy[None, :]).clamp(0, h - 1)  # [h, 32]
    xs = (torch.arange(w, device=dev)[:, None] + dx[None, :]).clamp(0, w - 1)  # [w, 32]
    win = tex[ys[:, None, :], xs[None, :, :]]  # [h, w, 32, 3]
    return win.permute(0, 1, 3, 2)


def predict(win, net):
    """The predicted value of each window ``[..., 32]``."""
    w1, w2, b1, b2 = net
    mean = win.sum(dim=-1) / 32.0
    var = (win * win).sum(dim=-1) / 32.0 - mean * mean
    ok = var >= EPS
    std = torch.where(ok, torch.sqrt(torch.where(ok, var, 1.0)), 0.0)
    rstd = torch.where(ok, 1.0 / torch.where(ok, std, 1.0), 0.0)
    sum1, sum2 = win @ w1, win @ w2  # [..., nns]
    e = torch.exp(sum1 * rstd[..., None] + b1)
    t = sum2 * rstd[..., None] + b2
    wsum = e.sum(dim=-1)
    vsum = (e * (t / (1.0 + torch.abs(t)))).sum(dim=-1)
    return torch.clamp(mean + 5.0 * vsum / wsum * std, 0.0, 1.0)


def double(tex, axis: int, net):
    """One nnedi3 pass before its store: ``tex [h, w, 3]`` → ``[2h, w, 3]``
    (axis 0) or ``[h, 2w, 3]`` (axis 1), the source's rows or columns at
    the even positions."""
    pred = predict(window(tex, axis), net)  # [h, w, 3]
    h, w = tex.shape[0], tex.shape[1]
    if axis == 0:
        return torch.stack([tex, pred], dim=1).reshape(2 * h, w, 3)
    return torch.stack([tex, pred], dim=2).reshape(h, 2 * w, 3)


def store(x):
    """The RGBA8 framebuffer's level of ``x``."""
    return torch.round(x.clamp(0.0, 1.0) * 255.0)


def _taps(n_out: int, n_in: int, dev):
    """LINEAR, clamp_to_edge taps of ``n_out`` samples over ``n_in`` texels,
    in float32: (first texel, second texel, the second's weight)."""
    u = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) / float(n_out)
    s = u * float(n_in) - 0.5
    i0 = torch.floor(s)
    f = s - i0
    i0 = i0.long()
    return i0.clamp(0, n_in - 1), (i0 + 1).clamp(0, n_in - 1), f


def blit(tex, out_hw, dtype):
    """The window's LINEAR, clamp_to_edge stretch of ``tex [H, W, 3]`` to
    ``out_hw`` (OH, OW), rows then columns."""
    (h, w), (oh, ow) = tex.shape[:2], out_hw
    y0, y1, fy = _taps(oh, h, tex.device)
    fy = fy.to(dtype)[:, None, None]
    tex = tex[y0] * (1.0 - fy) + tex[y1] * fy
    x0, x1, fx = _taps(ow, w, tex.device)
    fx = fx.to(dtype)[None, :, None]
    return tex[:, x0] * (1.0 - fx) + tex[:, x1] * fx


def render(src, frame_count: int, params: dict, out_hw, dtype=torch.float32):
    """One output frame: ``src`` u8 ``[h, w, 3]`` (a tensor on the device
    to compute on), FrameCount (the shaders read none), the parameters
    (the preset has none), ``out_hw`` (OH, OW) → u8 ``[OH, OW, 3]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inv = float(torch.tensor(1.0 / 255.0, dtype=torch.float64).to(dtype))
    tex = src.to(dtype) * inv
    for axis, net in passes(src.device, dtype):
        tex = store(double(tex, axis, net)) * inv
    out = blit(tex, out_hw, dtype)
    return torch.round(out.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)
