"""The plain reference of crt-mattias.glsl (libretro glsl-shaders
crt/crt-mattias.glsl, Mattias's "CRT Emulation"): one viewport pass over a
NEAREST, clamp_to_edge source, written out in plain PyTorch.

It imports nothing of the program. Everything is computed in ``dtype``
(float32 as the shader states; the control runs it in bfloat16), the
output pixel by pixel as the fragment computes it, and stored as the
RGBA8 framebuffer stores it (round to nearest level).

One part needs the float32 arithmetic spelled out: the noise hash
``fract(sin(mod(dot(co, (12.9898, 78.233)), 3.14)) * 43758.5453)``. One
ulp of ``dot(...)`` (7.6e-6 at 91) moves the hash by a third of its range,
so the hash of an independent float32 evaluation is a different random
number. The coordinates that reach it (the warp ``uv`` and the blur's
tap positions) are therefore computed with the roundings the repository
fixes for the shader's float32 arithmetic (the JAX package as ``jax.jit``
compiles it on the CPU): a product with one use contracted into the add
that takes it (``_fma``: the f64 sum of the exact product, rounded once),
a division by a constant as a multiply by its rounded reciprocal.
Everything after the coordinates is plain arithmetic in ``dtype``.
"""

from __future__ import annotations

import torch

CURVATURE = 0.5
SCANSPEED = 1.0

# blur() weights, rows y = -2..2, columns x = -2..2 (crt-mattias.glsl blur()).
W5 = (
    (0.00366, 0.01465, 0.02564, 0.01465, 0.00366),
    (0.01465, 0.05861, 0.09524, 0.05861, 0.01465),
    (0.02564, 0.09524, 0.15018, 0.09524, 0.02564),
    (0.01465, 0.05861, 0.09524, 0.05861, 0.01465),
    (0.00366, 0.01465, 0.02564, 0.01465, 0.00366),
)

# The nine blur() calls of main(): (channel, uv offset x, y, offs, scale).
# col.r = blur(.., uv + (0.0009, 0.0009), 1.2).x + 0.005, and so on; the
# three +-0.005 and 0.0 constants of a channel add to 0.
BLURS = (
    (0, 0.0009, 0.0009, 1.2, 1.0),
    (1, 0.0, -0.0015, 1.2, 1.0),
    (2, -0.0015, 0.0, 1.2, 1.0),
    (0, 0.0009, 0.0009, 2.25, 0.2),
    (1, 0.0, -0.0015, 1.75, 0.2),
    (2, -0.0015, 0.0, 1.25, 0.2),
    (0, 0.75 * 0.01 + 0.001, 0.75 * -0.027 + 0.001, 7.0, 0.05 * (1.0 - 0.299)),
    (1, -0.75 * 0.022 + 0.0, 0.75 * -0.02 - 0.002, 5.0, 0.05 * (1.0 - 0.587)),
    (2, 0.75 * -0.02 - 0.002, 0.0, 3.0, 0.05 * (1.0 - 0.114)),
)


def _r(x, dtype) -> float:
    """The Python float ``x`` rounded to ``dtype``."""
    return float(torch.tensor(float(x), dtype=torch.float64).to(dtype))


def _fma(a, b, c, dtype):
    """``a*b + c`` rounded once to ``dtype`` (operands already in it)."""
    a = a.double() if isinstance(a, torch.Tensor) else a
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a * b + c).to(dtype)


def _curve(u, v, du, dv, dtype):
    """curve(): ``(uv - 0.5) * 2 * 1.1``, the barrel terms (uv.y's uses the
    updated uv.x), ``(uv / 2 + 0.5) * 0.92 + 0.04``."""
    x = (du if du is not None else u - 0.5) * 2.0 * _r(1.1, dtype)
    y = (dv if dv is not None else v - 0.5) * 2.0 * _r(1.1, dtype)
    ty = y.abs() * _r(1 / 5, dtype)
    x = x * _fma(ty, ty, 1.0, dtype)
    tx = x.abs() * _r(1 / 4, dtype)
    y = y * _fma(tx, tx, 1.0, dtype)
    cu = _fma(_fma(x, 0.5, 0.5, dtype), _r(0.92, dtype), _r(0.04, dtype), dtype)
    cv = _fma(_fma(y, 0.5, 0.5, dtype), _r(0.92, dtype), _r(0.04, dtype), dtype)
    return cu, cv


def _warp(oh: int, ow: int, curvature: float, cross: bool, dev, dtype):
    """uv = mix(q, curve(q), CURVATURE) over the pixel centres q, [oh, ow]
    each. ``cross``: the form the blur's and the scanline's coordinates
    take, where ``q - 0.5`` of the other axis is one contracted step."""
    xs = torch.arange(ow, dtype=dtype, device=dev)[None, :].expand(oh, ow) + 0.5
    ys = torch.arange(oh, dtype=dtype, device=dev)[:, None].expand(oh, ow) + 0.5
    ru, rv = _r(1 / ow, dtype), _r(1 / oh, dtype)
    qu, qv = xs * ru, ys * rv
    if cross:
        cu = _curve(qu, qv, None, _fma(ys, rv, -0.5, dtype), dtype)[0]
        cv = _curve(qu, qv, _fma(xs, ru, -0.5, dtype), None, dtype)[1]
    else:
        cu, cv = _curve(qu, qv, None, None, dtype)
    c = _r(curvature, dtype)
    return _fma(cu - qu, c, qu, dtype), _fma(cv - qv, c, qv, dtype)


def _blur(p, bu, bv, dtype):
    """The nine blur() calls: each a 5x5 weighted sum of NEAREST
    (clamp_to_edge) taps of the pow(rgb, 2.2) texture, added into its
    channel. ``p [h, w, 3]``, ``bu, bv [oh, ow]`` → ``[oh, ow, 3]``."""
    h, w = p.shape[0], p.shape[1]
    oh, ow = bu.shape
    acc = [torch.zeros((oh, ow), dtype=dtype, device=p.device) for _ in range(3)]
    for ch, bx, by, offs, scale in BLURS:
        ug = bu + _r(bx, dtype)
        vg = bv + _r(by, dtype)
        plane = p[..., ch].reshape(-1)
        cols = [torch.floor((ug + _r(_r(offs * k, dtype) / _r(ow, dtype), dtype)) * float(w)).long().clamp(0, w - 1)
                for k in (-2, -1, 0, 1, 2)]
        rows = [torch.floor((vg + _r(_r(offs * k, dtype) / _r(oh, dtype), dtype)) * float(h)).long().clamp(0, h - 1)
                for k in (-2, -1, 0, 1, 2)]
        for j, r in enumerate(rows):
            for i, c in enumerate(cols):
                acc[ch] = acc[ch] + _r(W5[j][i] * scale, dtype) * plane[r * w + c]
    return torch.stack(acc, dim=-1)


def _hash(cu, cv, dtype):
    """rand(co) = fract(sin(mod(dot(co, (12.9898, 78.233)), 3.14)) *
    43758.5453): the dot as one contracted step, ``mod`` as ``dt - 3.14 *
    floor(dt * (1 / 3.14))`` contracted, the sine of the reduced argument
    rounded once from float64."""
    dt = _fma(cu, _r(12.9898, dtype), cv * _r(78.233, dtype), dtype)
    inv = _r(_r(1.0, dtype) / _r(3.14, dtype), dtype)
    sn = _fma(torch.floor(dt * inv), -_r(3.14, dtype), dt, dtype)
    s = torch.sin(sn.double()).to(dtype) * _r(43758.5453, dtype)
    return s - torch.floor(s)


def render(src, frame_count: int, params: dict, out_hw, dtype=torch.float32):
    """One output frame: ``src`` u8 ``[h, w, 3]`` (a tensor on the device
    to compute on), FrameCount, the parameters, ``out_hw`` (OH, OW) → u8
    ``[OH, OW, 3]``."""
    oh, ow = out_hw
    dev = src.device
    curvature = float(params.get("CURVATURE", CURVATURE))
    scanspeed = float(params.get("SCANSPEED", SCANSPEED))
    tex = src.to(dtype) * _r(1 / 255, dtype)
    uu, uv = _warp(oh, ow, curvature, False, dev, dtype)
    bu, bv = _warp(oh, ow, curvature, True, dev, dtype)

    col = _blur(torch.pow(tex.clamp_min(0.0), 2.2), bu, bv, dtype)
    col = torch.clamp(col * 0.4 + 0.6 * col * col, 0.0, 1.0)
    vig = torch.pow(16.0 * uu * uv * (1.0 - uu) * (1.0 - uv), 0.3)
    col = col * vig[..., None]
    col = col * torch.tensor([0.95, 1.05, 0.95], dtype=dtype, device=dev)
    col = col + (col * col - col) * 0.3  # mix(col, col * col, 0.3)

    fc = torch.tensor(float(frame_count), dtype=dtype, device=dev)
    t60 = _r(_r(1.0, dtype) / _r(60.0, dtype), dtype)
    t = fc * t60  # iTime = FrameCount / 60
    scans = torch.clamp(0.35 + 0.15 * torch.sin(3.5 * (t * scanspeed) + bv * float(oh) * 1.5), 0.0, 1.0)
    col = col * (torch.pow(scans, 0.9) * 3.8)[..., None]
    col = col * (1.0 + 0.0015 * torch.sin(300.0 * t))

    xs = torch.arange(ow, dtype=dtype, device=dev)[None, :] + 0.5
    ys = torch.arange(oh, dtype=dtype, device=dev)[:, None] + 0.5
    o = torch.remainder(ys, 2.0) * (2.0 / ow)
    comb = torch.clamp((torch.remainder(xs + o, 2.0) - 1.0) * 2.0, 0.0, 1.0)
    col = col * (1.0 - 0.15 * comb)[..., None]

    drift = fc * _r(t60 * _r(0.0001, dtype), dtype)  # 0.0001 * iTime, the constants folded
    noise = torch.stack(
        [_hash((uu + drift) + _r(k, dtype), (uv + drift) + _r(k, dtype), dtype) for k in (0.0, 0.3, 0.5)], dim=-1
    )
    col = col * (1.0 - 0.25 * noise)
    col = torch.pow(col.clamp_min(0.0), 0.45)
    inside = (uu >= 0.0) & (uu <= 1.0) & (uv >= 0.0) & (uv <= 1.0)
    col = torch.where(inside[..., None], col, 0.0)
    col = torch.nan_to_num(col.float(), nan=0.0)
    return torch.round(col.clamp(0.0, 1.0) * 255.0).to(torch.uint8)

