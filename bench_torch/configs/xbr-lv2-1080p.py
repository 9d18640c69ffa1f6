"""The plain reference of xbr-lv2.glsl (libretro glsl-shaders
xbr/shaders/xbr-lv2.glsl, Hyllian's xBR level 2, CORNER_C, SMOOTH_TIPS,
XBR_SCALE 3): one viewport pass over a NEAREST, clamp_to_edge source,
written out in plain PyTorch.

It imports nothing of the program. Every output pixel is computed as the
fragment computes it: the 21 NEAREST taps at the vertex stage's t1..t7
coordinates (``TEX0 = TexCoord * 1.0001``), their luma, the edge rules and
the fp ramps, the mixes and the final select; then stored as the RGBA8
framebuffer stores it. Everything is computed in ``dtype`` (float32 as the
shader states; the control runs it in bfloat16).

The edge rules compare luma values for equality and order (``diff``,
``step``), so the luma is computed with the rounding the repository fixes
for the shader's float32 arithmetic (the JAX package as ``jax.jit``
compiles it on the CPU): ``dot(c, w)`` as ``c.b * w.b + (c.r * w.r + c.g
* w.g)`` with both outer products contracted into their adds (``_fma``),
and the taps as the level ``k`` times the rounded ``1 / 255``. Where two
colours tie in exact arithmetic, they then tie here too.
"""

from __future__ import annotations

import torch

XBR_Y_WEIGHT = 48.0
XBR_EQ_THRESHOLD = 15.0
XBR_LV2_COEFFICIENT = 2.0
XBR_SCALE = 3.0
RGBW = (14.352, 28.176, 5.472)  # small_details 0: luma weights of the edge rules

# The taps: (name, dx, dy) in texels from the pixel's own (t1..t7).
TAPS = (
    ("A1", -1, -2), ("B1", 0, -2), ("C1", 1, -2),
    ("A", -1, -1), ("B", 0, -1), ("C", 1, -1),
    ("D", -1, 0), ("E", 0, 0), ("F", 1, 0),
    ("G", -1, 1), ("H", 0, 1), ("I", 1, 1),
    ("G5", -1, 2), ("H5", 0, 2), ("I5", 1, 2),
    ("A0", -2, -1), ("D0", -2, 0), ("G0", -2, 1),
    ("C4", 2, -1), ("F4", 2, 0), ("I4", 2, 1),
)


def _r(x, dtype) -> float:
    return float(torch.tensor(float(x), dtype=torch.float64).to(dtype))


def _fma(a, b, c, dtype):
    """``a*b + c`` rounded once to ``dtype``."""
    return (a.double() * b + c.double()).to(dtype)


def _vec4(d, *names):
    return torch.stack([d[n] for n in names])


def render(src, frame_count: int, params: dict, out_hw, dtype=torch.float32):
    """One output frame: ``src`` u8 ``[h, w, 3]`` (a tensor on the device
    to compute on), FrameCount (unused by the shader), the parameters,
    ``out_hw`` (OH, OW) → u8 ``[OH, OW, 3]``."""
    if float(params.get("small_details", 0.0)) >= 0.5:
        raise NotImplementedError("the reference computes small_details 0 only")
    oh, ow = out_hw
    h, w = src.shape[0], src.shape[1]
    dev = src.device
    thr = _r(params.get("XBR_EQ_THRESHOLD", XBR_EQ_THRESHOLD), dtype)
    cf = _r(params.get("XBR_LV2_COEFFICIENT", XBR_LV2_COEFFICIENT), dtype)

    # The varyings at the pixel centres: TexCoord spans the viewport quad
    # (TextureSize = InputSize), TEX0 = TexCoord * 1.0001, the taps one
    # texel apart (dx = 1 / TextureSize.x).
    tx = ((torch.arange(ow, dtype=torch.float64, device=dev) + 0.5) / ow).to(dtype) * _r(1.0001, dtype)
    ty = ((torch.arange(oh, dtype=torch.float64, device=dev) + 0.5) / oh).to(dtype) * _r(1.0001, dtype)
    dx, dy = _r(1.0 / w, dtype), _r(1.0 / h, dtype)
    cols = {k: torch.floor((tx + k * dx) * float(w)).long().clamp(0, w - 1) for k in (-2, -1, 0, 1, 2)}
    rows = {k: torch.floor((ty + k * dy) * float(h)).long().clamp(0, h - 1) for k in (-2, -1, 0, 1, 2)}
    fpx = tx * float(w) - torch.floor(tx * float(w))  # fp = fract(texCoord * TextureSize)
    fpy = (ty * float(h) - torch.floor(ty * float(h)))[:, None]

    tex = src.to(dtype) * _r(1 / 255, dtype)
    c = {n: tex[rows[j]][:, cols[i]] for n, i, j in TAPS}  # [oh, ow, 3] each
    wr, wg, wb = (_r(x, dtype) for x in RGBW)
    L = {n: _fma(v[..., 2], wb, _fma(v[..., 0], wr, v[..., 1] * wg, dtype), dtype) for n, v in c.items()}

    b = _vec4(L, "B", "D", "H", "F")
    cc = _vec4(L, "C", "A", "G", "I")
    d = _vec4(L, "D", "H", "F", "B")
    e = L["E"]
    f = _vec4(L, "F", "B", "D", "H")
    g = _vec4(L, "G", "I", "C", "A")
    hh = _vec4(L, "H", "F", "B", "D")
    i = _vec4(L, "I", "C", "A", "G")
    i4 = _vec4(L, "I4", "C1", "A0", "G5")
    i5 = _vec4(L, "I5", "C4", "A1", "G0")
    h5 = _vec4(L, "H5", "F4", "B1", "D0")
    f4 = torch.zeros_like(i4)  # the shader declares vec4 f4 and never assigns it

    def df(x, y):
        return (x - y).abs()

    def diff(x, y):
        return (x != y).to(dtype)

    def eq(x, y):
        return (df(x, y) <= thr).to(dtype)  # step(df, threshold)

    def neq(x, y):
        return 1.0 - eq(x, y)

    def step(edge, x):
        return (x >= edge).to(dtype)

    irlv0 = diff(e, f) * diff(e, hh)
    irlv1 = irlv0 * (neq(f, b) * neq(f, cc) + neq(hh, d) * neq(hh, g)
                     + eq(e, i) * (neq(f, f4) * neq(f, i4) + neq(hh, h5) * neq(hh, i5)) + eq(e, g) + eq(e, cc))
    irlv2l = diff(e, g) * diff(d, g)
    irlv2u = diff(e, cc) * diff(b, cc)
    wd1 = df(e, cc) + df(e, g) + df(i, h5) + df(i, f4) + 4.0 * df(hh, f)
    wd2 = df(hh, d) + df(hh, i5) + df(f, i4) + df(f, b) + 4.0 * df(e, i)
    edri = step(wd1, wd2) * irlv0
    edr = step(wd1 + _r(0.1, dtype), wd2) * step(0.5, irlv1)
    edr_left = step(cf * df(f, g), df(hh, cc)) * irlv2l * edr
    edr_up = step(cf * df(hh, cc), df(f, g)) * irlv2u * edr
    px = step(df(e, f), df(e, hh))

    def vec(*x):
        return torch.tensor(x, dtype=dtype, device=dev)[:, None, None]

    def ramp(a, bb, cst, delta):
        return torch.clamp((a * fpy + bb * fpx + delta - cst) / (2.0 * delta), 0.0, 1.0)

    delta = vec(*(4 * [1.0 / XBR_SCALE]))
    delta_l = vec(0.5 / XBR_SCALE, 1.0 / XBR_SCALE, 0.5 / XBR_SCALE, 1.0 / XBR_SCALE)
    delta_u = delta_l[[1, 0, 3, 2]]
    ao, bo, co = vec(1.0, -1.0, -1.0, 1.0), vec(1.0, 1.0, -1.0, -1.0), vec(1.5, 0.5, -0.5, 0.5)
    ax, bx, cx = vec(1.0, -1.0, -1.0, 1.0), vec(0.5, 2.0, -0.5, -2.0), vec(1.0, 1.0, -0.5, 0.0)
    ay, by, cy = vec(1.0, -1.0, -1.0, 1.0), vec(2.0, 0.5, -2.0, -0.5), vec(2.0, 0.0, -1.0, 0.5)
    fx45i = ramp(ao, bo, co + 0.25, delta) * edri
    fx45 = ramp(ao, bo, co, delta) * edr
    fx30 = ramp(ax, bx, cx, delta_l) * edr_left
    fx60 = ramp(ay, by, cy, delta_u) * edr_up
    m = torch.maximum(torch.maximum(fx30, fx60), torch.maximum(fx45, fx45i))  # [4, oh, ow]

    def mix(x, y, a):
        return x * (1.0 - a) + y * a

    E, H, F, B, D = c["E"], c["H"], c["F"], c["B"], c["D"]
    px = px[..., None]
    m = m[..., None]
    res1 = mix(E, mix(H, F, px[0]), m[0])
    res1 = mix(res1, mix(B, D, px[2]), m[2])
    res2 = mix(E, mix(F, B, px[1]), m[1])
    res2 = mix(res2, mix(D, H, px[3]), m[3])

    def c_df(x, y):
        a = df(x, y)
        return a[..., 0] + a[..., 1] + a[..., 2]

    res = mix(res1, res2, step(c_df(E, res1), c_df(E, res2))[..., None])
    return torch.round(res.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)
