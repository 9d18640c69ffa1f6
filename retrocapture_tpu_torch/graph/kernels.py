"""Hand-written kernel-library entries: the crt-mattias and xbr-lv2 passes.

The port of the crt-mattias and xbr-lv2 parts of
``retrocapture_tpu/graph/kernels.py``. The generic evaluator lowers any
GLSL; an entry here replaces one shader's whole fragment with a direct
formulation (torch sections around a CUDA kernel), selected by the
shader's basename through ``find_kernel``. An entry checks its own
feasibility and returns None to leave the pass to the evaluator.
``RCTPU_KERNELS=off`` disables the library; otherwise an entry runs on
either device, taking its kernels' plain versions on the CPU (the
reference's interpret mode).

Numerics follow the reference as ``jax.jit`` compiles it: XLA's CPU
code contracts ``a*b + c`` into one rounding where the tests
(tests/test_torch_mattias.py, tests/test_torch_xbr.py) show it does,
which ``fma32`` reproduces,
and divides by a constant as a multiply by its reciprocal, taken in
f32 (``f32(1) / f32(c)``, one ulp below ``f32(1/c)`` for c = 3.14). The
f32 ``sin`` is ``policy.sinf32``: the C library's ``sinf`` that XLA's CPU
code calls, repeated in float64 tensor ops, so that the CPU and CUDA
runs of the port agree with it and with each other.

The ntsc 2-phase and nnedi3 entries of the reference are not ported yet
(ROADMAP queue 1).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from retrocapture_tpu_torch.policy import fma32, sinf32

__all__ = ["find_kernel"]

_F = np.float32


def _glsl_pow(x, p: float):
    """Non-integer pow exactly as the evaluator lowers it
    (frontend/builtins._b_pow): exp2(p * log2(x)); NaN for x<0 flushes
    to 0 at the RGBA8 store."""
    return torch.exp2(float(_F(p)) * torch.log2(x))


def _rand_dt_sn(co_u, co_v):
    """rand()'s dt = dot(co, (12.9898, 78.233)) and sn = mod(dt, 3.14),
    contracted as jitted XLA contracts them; ``dt / 3.14`` is XLA's
    multiply by the f32 reciprocal ``f32(1) / f32(3.14)``."""
    dt = fma32(co_u, 12.9898, co_v * float(_F(78.233)))
    sn = fma32(torch.floor(dt * float(_F(1.0) / _F(3.14))), -3.14, dt)
    return dt, sn


def _rand(co_u, co_v):
    """crt-mattias.glsl rand(): precision-safe hash
    fract(sin(mod(dot(co, (12.9898, 78.233)), 3.14)) * 43758.5453)."""
    s = sinf32(_rand_dt_sn(co_u, co_v)[1], below_120=True) * float(_F(43758.5453))
    return s - torch.floor(s)


def _mattias_curve(u, v):
    """crt-mattias.glsl curve(): barrel distortion; uv.y's factor uses
    the already-updated uv.x (statement order). ``1 + t*t`` and the
    affine tail contract as jitted XLA contracts them."""
    x = (u - 0.5) * 2.0 * float(_F(1.1))
    y = (v - 0.5) * 2.0 * float(_F(1.1))
    ty = torch.abs(y) * float(_F(1.0 / 5.0))
    x = x * fma32(ty, ty, 1.0)
    tx = torch.abs(x) * float(_F(1.0 / 4.0))
    y = y * fma32(tx, tx, 1.0)
    u2 = fma32(fma32(x, 0.5, 0.5), 0.92, 0.04)
    v2 = fma32(fma32(y, 0.5, 0.5), 0.92, 0.04)
    return u2, v2


# 5x5 Gaussian-ish weights from crt-mattias.glsl blur() (rows = y offs
# -2,-1,0,+1,+2; cols = x offs -2,-1,0,+1,+2).
_MATTIAS_W = np.array(
    [
        [0.00366, 0.01465, 0.02564, 0.01465, 0.00366],
        [0.01465, 0.05861, 0.09524, 0.05861, 0.01465],
        [0.02564, 0.09524, 0.15018, 0.09524, 0.02564],
        [0.01465, 0.05861, 0.09524, 0.05861, 0.01465],
        [0.00366, 0.01465, 0.02564, 0.01465, 0.00366],
    ],
    np.float64,
)

def _mattias_max_dudv() -> float:
    """Worst-case |du/dv| of the mattias warp, at CURVATURE=1 (the
    pragma max, crt-mattias.glsl:5; the runtime parameter only
    interpolates q -> curve(q), so c=1 is the hard ceiling). Used by
    blur_groups v2's static drift gate: its tau routing anchors gathers
    to the tile's row-0 column base and covers per-row drift via a
    +-1-texel candidate margin — this bound proves the margin holds for
    every tile at any runtime CURVATURE instead of assuming it."""
    v = np.linspace(0.0, 1.0, 2049)[None, :]
    u = np.linspace(0.0, 1.0, 65)[:, None]
    # numpy transcription of _mattias_curve (keeps this pure-host).
    x = (u - 0.5) * 2.0 * 1.1 + 0.0 * v
    y = (v - 0.5) * 2.0 * 1.1 + 0.0 * u
    ty = np.abs(y) / 5.0
    x = x * (1.0 + ty * ty)
    tx = np.abs(x) / 4.0
    y = y * (1.0 + tx * tx)
    uu = (x * 0.5 + 0.5) * 0.92 + 0.04
    dudv = np.abs(np.diff(uu, axis=1)) / np.diff(v[0])[None, :]
    return float(dudv.max()) * 1.05  # 5% grid-resolution slack


_MATTIAS_MAX_DUDV = _mattias_max_dudv()


# (channel, base dx, base dy, offs, scale, post_add) per blur call,
# crt-mattias.glsl main() lines col.r/.g/.b =/+= ...
_MATTIAS_GROUPS = [
    (0, 0.0009, 0.0009, 1.2, 1.0, 0.005),
    (1, 0.0, -0.0015, 1.2, 1.0, 0.005),
    (2, -0.0015, 0.0, 1.2, 1.0, 0.005),
    (0, 0.0009, 0.0009, 2.25, 0.2, -0.005),
    (1, 0.0, -0.0015, 1.75, 0.2, -0.005),
    (2, -0.0015, 0.0, 1.25, 0.2, -0.005),
    (0, 0.75 * 0.01 + 0.001, 0.75 * -0.027 + 0.001, 7.0, 0.05 * (1.0 - 0.299), 0.0),
    (1, -0.75 * 0.022 + 0.0, 0.75 * -0.02 - 0.002, 5.0, 0.05 * (1.0 - 0.587), 0.0),
    (2, 0.75 * -0.02 - 0.002, 0.0, 3.0, 0.05 * (1.0 - 0.114), 0.0),
]


def mattias_groups(ow: int, oh: int):
    """The 9 BlurGroups of crt-mattias at output size (ow, oh), built as
    the reference's _mattias_kernel builds them."""
    from retrocapture_tpu_torch.ops.cuda.blur_groups import BlurGroup

    groups = []
    for ch, bx, by, offs, scale, _ in _MATTIAS_GROUPS:
        xo = [_F(offs * k) / _F(ow) for k in (-2.0, -1.0, 0.0, 1.0, 2.0)]
        yo = [_F(offs * k) / _F(oh) for k in (-2.0, -1.0, 0.0, 1.0, 2.0)]
        groups.append(BlurGroup(ch, bx, by, xo, yo, _MATTIAS_W, scale))
    return groups


def _pixel_grid(ow: int, oh: int, device):
    """Column and row indices of the output grid, [oh, ow] f32 each."""
    xg = torch.arange(ow, dtype=torch.float32, device=device)[None, :].expand(oh, ow)
    yg = torch.arange(oh, dtype=torch.float32, device=device)[:, None].expand(oh, ow)
    return xg, yg


def mattias_uv(ow: int, oh: int, curvature: float, device):
    """The base warp of the fragment: q -> mix(q, curve(q), CURVATURE)
    over the output pixel centres, [oh, ow] f32 each."""
    xg, yg = _pixel_grid(ow, oh, device)
    q_u = (xg + 0.5) * float(_F(1.0 / ow))
    q_v = (yg + 0.5) * float(_F(1.0 / oh))
    cu, cv = _mattias_curve(q_u, q_v)
    return fma32(cu - q_u, curvature, q_u), fma32(cv - q_v, curvature, q_v)


def _mattias_kernel(ctx, sh):
    """crt-mattias.glsl on the kernel library: the 9-group blur (CUDA
    kernel on the card) + torch epilogue. Returns None when infeasible."""
    from retrocapture_tpu_torch.ops.cuda.blur_groups import blur5x5_groups, blur_groups_fits
    from retrocapture_tpu_torch.ops.preconv_blur import blur_preconv, blur_preconv_fits

    cfg = ctx.program.preset.passes[ctx.i]
    if cfg.filter_linear or cfg.wrap_mode != "clamp_to_edge":
        return None
    tex = ctx.input_binding.tex
    h, w = tex.shape[0], tex.shape[1]
    ow, oh = ctx.out_size
    dev = tex.device
    groups = mattias_groups(ow, oh)
    if not blur_groups_fits((h, w, 3), (oh, ow), groups, max_dudv=_MATTIAS_MAX_DUDV, device=dev):
        return None

    curvature = float(_F(ctx.params.get("CURVATURE", _F(0.5))))
    scanspeed = float(_F(ctx.params.get("SCANSPEED", _F(1.0))))
    fc = torch.as_tensor(ctx.frame_count, device=dev)
    t = fc.to(torch.float32) * float(_F(1.0) / _F(60.0))

    uv_u, uv_v = mattias_uv(ow, oh, curvature, dev)

    # phosphor values are sampled through pow(rgb, 2.2)
    p = _glsl_pow(torch.clamp_min(tex[..., :3], 0.0), 2.2)
    # The two lowerings of the 225-tap blur, as in the reference:
    # RCTPU_MATTIAS=preconv takes the pre-convolution (one warped NEAREST
    # sample per group), the default the direct blur kernel. On the CPU
    # (the reference's interpret mode) only an explicit "preconv" takes
    # the pre-convolution.
    which = os.environ.get("RCTPU_MATTIAS", "groups")
    use_preconv = which != "groups" and blur_preconv_fits((h, w), groups)
    if use_preconv and dev.type == "cpu" and which != "preconv":
        use_preconv = False
    if use_preconv:
        planes = blur_preconv(p, uv_u, uv_v, groups)
    else:
        planes = blur5x5_groups(p, uv_u, uv_v, groups)

    posts = {0: 0.0, 1: 0.0, 2: 0.0}
    for ch, _, _, _, _, post in _MATTIAS_GROUPS:
        posts[ch] += post
    col = torch.stack([planes[ch] + float(_F(posts[ch])) for ch in range(3)], dim=-1)

    xg, yg = _pixel_grid(ow, oh, dev)
    # epilogue (crt-mattias.glsl main tail)
    col = torch.clamp(col * 0.4 + 0.6 * col * col, 0.0, 1.0)
    vig = 16.0 * uv_u * uv_v * (1.0 - uv_u) * (1.0 - uv_v)
    col = col * _glsl_pow(vig, 0.3)[..., None]
    col = col * torch.tensor([0.95, 1.05, 0.95], dtype=torch.float32, device=dev)
    col = (col + (col * col - col) * float(_F(0.3))) * float(_F(3.8))
    # The scanline phase of every pixel and the flicker's one phase go
    # through sinf32 together: one chain of launches, not two.
    scan_arg = 3.5 * (t * scanspeed) + uv_v * float(oh) * 1.5
    sines = sinf32(torch.cat([scan_arg.reshape(-1), (300.0 * t).reshape(1)]))
    scans = torch.clamp(0.35 + 0.15 * sines[:-1].reshape(oh, ow), 0.0, 1.0)
    col = col * _glsl_pow(scans, 0.9)[..., None]
    col = col * (1.0 + 0.0015 * sines[-1])
    o = 2.0 * torch.remainder(yg + 0.5, 2.0) * float(_F(1.0 / ow))
    fx = xg + 0.5
    comb = torch.clamp((torch.remainder(fx + o, 2.0) - 1.0) * 2.0, 0.0, 1.0)
    col = col * (1.0 - 0.15 * comb)[..., None]
    # rand(uv + 1e-4 t + {0, 0.3, 0.5}) per channel: the three hashes in
    # one pass over a stacked [oh, ow, 3] argument.
    offs = torch.tensor([0.0, 0.3, 0.5], dtype=torch.float32, device=dev)
    noise = _rand((uv_u + 0.0001 * t)[..., None] + offs, (uv_v + 0.0001 * t)[..., None] + offs)
    col = col * (1.0 - 0.25 * noise)
    col = _glsl_pow(torch.clamp_min(col, 0.0), 0.45)
    inside = (uv_u >= 0.0) & (uv_u <= 1.0) & (uv_v >= 0.0) & (uv_v <= 1.0)
    col = torch.where(inside[..., None], col, 0.0)
    col = torch.where(torch.isnan(col), 0.0, col)
    return torch.cat([col, torch.ones((oh, ow, 1), dtype=torch.float32, device=dev)], dim=-1)


# ---------------------------------------------------------------------------
# xbr-lv2 (shaders_glsl/xbr/shaders/xbr-lv2.glsl): every NEAREST tap index
# is an integer offset of the base source texel, so the tap and
# edge-detection section runs at [output rows, source columns] and only the
# fp-ramp blend is full resolution (the CUDA epilogue, ops/cuda/
# xbr_epilogue.py). The reference's XLA tails (the one-hot matmul and the
# RCTPU_XBR=dense|phase forms) exist for TPU gathers and are not ported:
# the epilogue takes the 19 planes straight from the front section.

_XBR_RGBW = np.array([14.352, 28.176, 5.472], np.float32)

# (name, dx texels, dy texels) for the 21 neighbourhood taps.
_XBR_TAPS = [
    ("A1", -1, -2), ("B1", 0, -2), ("C1", 1, -2),
    ("A", -1, -1), ("B", 0, -1), ("C", 1, -1),
    ("D", -1, 0), ("E", 0, 0), ("F", 1, 0),
    ("G", -1, 1), ("H", 0, 1), ("I", 1, 1),
    ("G5", -1, 2), ("H5", 0, 2), ("I5", 1, 2),
    ("A0", -2, -1), ("D0", -2, 0), ("G0", -2, 1),
    ("C4", 2, -1), ("F4", 2, 0), ("I4", 2, 1),
]
_XBR_Y = np.array([0.2126, 0.7152, 0.0722], np.float32)


def _xbr_axis_maps(ctx, ow: int, oh: int, w: int, h: int):
    """Concrete replication of the evaluator's coordinate math from the
    pass's rasterizer-exact varying planes (engine._plane_varyings): the
    xbr tap coordinates are the t1..t7 varyings (TEX1..TEX7), each
    plane-fit from its own float32 corner values, and the sampler floors
    ``f32(f64(d)*j + f64(a0)) * f32(n)`` exactly like sample2d_affine. fp
    mirrors the fragment's f32 data math ``fract(texCoord * TextureSize)``
    on the TEX0 plane vectors. Returns (bx, fpx, tx, by, fpy, ty) or None
    when the planes aren't available (vertex stage not corner-runnable,
    renamed varyings), the quad is transformed, or a tap axis is not
    separable."""
    from retrocapture_tpu_torch.runtime.engine import _plane_varyings

    cp = ctx.program.passes[ctx.i]
    try:
        planes, plane_cover = _plane_varyings(cp, ctx, ow, oh)
    except Exception:
        return None
    if plane_cover is not None:
        return None  # transformed quad: evaluator path handles coverage
    need = {"TEX0": 2, "TEX1": 4, "TEX2": 4, "TEX3": 4, "TEX4": 4,
            "TEX5": 4, "TEX6": 4, "TEX7": 4}
    for nm, ncomp in need.items():
        v = planes.get(nm)
        if v is None or v.affine is None or len(v.affine) < ncomp:
            return None

    def aff(nm, comp):
        return planes[nm].affine[comp]

    def col_idx(a, n, m):
        dadx, dady, a0 = a
        if dady != 0.0:
            return None
        row = (np.float64(dadx) * np.arange(m, dtype=np.float64) + np.float64(a0)).astype(np.float32)
        return np.floor(row * np.float32(n)).astype(np.int64)

    def row_idx(a, n, m):
        dadx, dady, a0 = a
        if dadx != 0.0:
            return None
        col = (np.float64(dady) * np.arange(m, dtype=np.float64) + np.float64(a0)).astype(np.float32)
        return np.floor(col * np.float32(n)).astype(np.int64)

    # x taps: A0/D0/G0 column = t6.x (-2dx), t1.x/.y/.z = -dx,0,+dx,
    # C4/F4/I4 column = t7.x (+2dx).
    tx = {
        -2: col_idx(aff("TEX6", 0), w, ow),
        -1: col_idx(aff("TEX1", 0), w, ow),
        0: col_idx(aff("TEX1", 1), w, ow),
        1: col_idx(aff("TEX1", 2), w, ow),
        2: col_idx(aff("TEX7", 0), w, ow),
    }
    ty = {
        -2: row_idx(aff("TEX1", 3), h, oh),
        -1: row_idx(aff("TEX2", 3), h, oh),
        0: row_idx(aff("TEX3", 3), h, oh),
        1: row_idx(aff("TEX4", 3), h, oh),
        2: row_idx(aff("TEX5", 3), h, oh),
    }
    if any(v is None for v in tx.values()) or any(v is None for v in ty.values()):
        return None

    def fp_of(a, n, m):
        dadx, dady, a0 = a
        d = dadx if dady == 0.0 else dady
        coord = (np.float64(d) * np.arange(m, dtype=np.float64) + np.float64(a0)).astype(np.float32)
        prod = coord * np.float32(n)
        return (prod - np.floor(prod)).astype(np.float32)

    ax, ay = aff("TEX0", 0), aff("TEX0", 1)
    if ax[1] != 0.0 or ay[0] != 0.0:
        return None
    fpx = fp_of(ax, w, ow)
    fpy = fp_of(ay, h, oh)
    return tx[0], fpx, tx, ty[0], fpy, ty


def _xbr_lum(x, weights):
    """dot(rgb, weights) over the last axis, as jitted XLA computes
    ``x0*w0 + x1*w1 + x2*w2``: ``x1*w1`` rounded, then ``x0*w0`` and
    ``x2*w2`` contracted into the running sum (tests/test_torch_xbr.py)."""
    return fma32(x[..., 2], weights[2], fma32(x[..., 0], weights[0], x[..., 1] * float(weights[1])))


def _xbr_gathers(ty, h: int, w: int, dev):
    """The front section's index tensors on ``dev``: the edge-padded
    column gather ``[W + 4]`` and the 5 clamped row gathers ``{-2..2:
    [OH]}`` of the row-index maps ``ty``."""
    cols = torch.from_numpy(np.clip(np.arange(-2, w + 2), 0, w - 1)).to(dev)
    rows = {k: torch.from_numpy(np.clip(ty[k], 0, h - 1)).to(dev) for k in (-2, -1, 0, 1, 2)}
    return cols, rows


def _xbr_planes(tex, gathers, eq_thr, lv2_cf, small, y_weight, quantized: bool):
    """The front section of xbr-lv2: ``tex [H, W, >=3]`` f32 (one frame),
    ``gathers`` the index tensors of ``_xbr_gathers`` (from the 5
    row-index maps of ``_xbr_axis_maps``), on tex's device → ``S [19, OH,
    W]`` f32: the E, H, F, B, D colours x255 and the 4 packed flag codes (edri + 2 edr + 4 edr_left + 8 edr_up + 16 px per
    corner). Each y tap row is an index gather (the reference's one-hot
    einsum); x taps are column shifts of the edge-padded rows. The corner
    "vec4"s ride as [4, OH, W] stacks; every pixel sees the reference's
    operations in its order.

    The colours ride x255 and the taps are those values x f32(1/255), as
    in the reference. For a texture on the k/255 grid (``quantized``: the
    u8 chain input, RGBA8 pass outputs) jitted XLA folds ``(k *
    f32(1/255)) * 255`` into the level k, since f32(255 * f32(1/255)) =
    1; the port rounds to the level there (tests/test_torch_xbr.py holds
    S bit-equal to the reference's for u8 and f32 input)."""
    h, w = tex.shape[0], tex.shape[1]
    tex255 = tex[..., :3] * 255.0
    if quantized:
        tex255 = torch.round(tex255)
    cols, rows = gathers
    pads = {k: tex255.index_select(0, r).index_select(1, cols) for k, r in rows.items()}  # [OH, W+4, 3]
    taps = {k: p * float(_F(1.0 / 255.0)) for k, p in pads.items()}
    lum = {k: _xbr_lum(t, _XBR_RGBW) for k, t in taps.items()}

    def plane(maps, dx, dy):  # the (dx, dy) tap of a padded [OH, W+4, ...] map
        return maps[dy][:, 2 + dx : 2 + dx + w]

    L = {name: plane(lum, dx, dy) for name, dx, dy in _XBR_TAPS}
    at = {name: (dx, dy) for name, dx, dy in _XBR_TAPS}

    def v4(*names):
        return torch.stack([L[n] for n in names])

    b4 = v4("B", "D", "H", "F")
    c4 = v4("C", "A", "G", "I")
    d4 = v4("D", "H", "F", "B")
    e4 = L["E"]
    f4_ = v4("F", "B", "D", "H")
    g4 = v4("G", "I", "C", "A")
    h4 = v4("H", "F", "B", "D")
    i4_ = v4("I", "C", "A", "G")
    if small < 0.5:
        i4 = v4("I4", "C1", "A0", "G5")
        i5 = v4("I5", "C4", "A1", "G0")
        h5 = v4("H5", "F4", "B1", "D0")
    else:
        yw = _XBR_Y * _F(y_weight)

        def lum_y(*names):
            return torch.stack([_xbr_lum(plane(taps, *at[n]), yw) for n in names])

        i4 = lum_y("I4", "C1", "A0", "G5")
        i5 = lum_y("I5", "C4", "A1", "G0")
        h5 = lum_y("H5", "F4", "B1", "D0")
    f44 = torch.zeros_like(i4)  # `vec4 f4` never assigned

    def df(a, b):
        return (a - b).abs()

    def diff(a, b):
        return (a != b).to(torch.float32)

    def eq(a, b):
        return ((a - b).abs() <= float(eq_thr)).to(torch.float32)

    def neq(a, b):
        return 1.0 - eq(a, b)

    irlv0 = diff(e4, f4_) * diff(e4, h4)
    # CORNER_C (the compiled-in variant, xbr-lv2.glsl:41,307-309)
    irlv1 = irlv0 * (
        neq(f4_, b4) * neq(f4_, c4)
        + neq(h4, d4) * neq(h4, g4)
        + eq(e4, i4_) * (neq(f4_, f44) * neq(f4_, i4) + neq(h4, h5) * neq(h4, i5))
        + eq(e4, g4)
        + eq(e4, c4)
    )
    irlv2l = diff(e4, g4) * diff(d4, g4)
    irlv2u = diff(e4, c4) * diff(b4, c4)
    if small < 0.5:
        wd1 = df(e4, c4) + df(e4, g4) + df(i4_, h5) + df(i4_, f44) + 4.0 * df(h4, f4_)
        wd2 = df(h4, d4) + df(h4, i5) + df(f4_, i4) + df(f4_, b4) + 4.0 * df(e4, i4_)
    else:
        wd1 = df(e4, c4) + df(e4, g4) + df(i4_, f44) + df(i4_, h5) + df(b4, d4) + df(i4, i5) + 2.0 * df(h4, f4_)
        wd2 = df(h4, d4) + df(h4, i5) + df(f4_, b4) + df(f4_, i4) + df(g4, h5) + df(c4, f44) + 2.0 * df(e4, i4_)

    edri = (wd2 >= wd1).to(torch.float32) * irlv0
    edr = (wd2 >= wd1 + float(_F(0.1))).to(torch.float32) * (irlv1 >= 0.5).to(torch.float32)
    cf = float(lv2_cf)
    edr_l = (df(h4, c4) >= cf * df(f4_, g4)).to(torch.float32) * irlv2l * edr
    edr_u = (df(f4_, g4) >= cf * df(h4, c4)).to(torch.float32) * irlv2u * edr
    px = (df(e4, h4) >= df(e4, f4_)).to(torch.float32)
    code = edri + 2.0 * edr + 4.0 * edr_l + 8.0 * edr_u + 16.0 * px  # [4, OH, W], integers 0..31

    def x255(dx, dy):  # [3, OH, W] colour planes x255 of one tap
        return plane(pads, dx, dy).permute(2, 0, 1)

    return torch.cat([x255(0, 0), x255(0, 1), x255(1, 0), x255(0, -1), x255(-1, 0), code])


_XBR_INFEASIBLE = "infeasible"  # a geometry the kernel declines, kept as such
_XBR_GEOMETRIES_MAX = 8  # geometries kept per program; a ninth starts anew


def _xbr_lv2_kernel(ctx, sh):
    """xbr-lv2.glsl on the kernel library: the front section (torch, at
    [output rows, source columns]) and the epilogue (the CUDA kernel on
    the card). Returns None when infeasible."""
    from retrocapture_tpu_torch.ops.cuda import xbr_epilogue as xe

    cfg = ctx.program.preset.passes[ctx.i]
    if cfg.filter_linear or cfg.wrap_mode != "clamp_to_edge":
        return None
    params = ctx.params

    def p(name, default):
        v = params.get(name, _F(default))
        if not isinstance(v, (int, float, np.generic)):
            return None  # a tensor parameter: leave the pass to the evaluator
        return _F(v)

    eq_thr = p("XBR_EQ_THRESHOLD", 15.0)
    lv2_cf = p("XBR_LV2_COEFFICIENT", 2.0)
    small = p("small_details", 0.0)
    y_weight = p("XBR_Y_WEIGHT", 48.0)
    if None in (eq_thr, lv2_cf, small, y_weight):
        return None

    tex = ctx.input_binding.tex
    h, w = int(tex.shape[0]), int(tex.shape[1])
    ow, oh = ctx.out_size
    # The geometry's maps depend on the pass, the sizes and the parameters
    # only, unless the vertex stage reads frame state: they are kept with
    # the compiled program (the engine drops them when a parameter or the
    # viewport changes) and built per frame otherwise.
    cp = ctx.program.passes[ctx.i]
    cache = ctx.program.kernel_cache if cp.vertex_static else None
    key = ("xbr-lv2", ctx.i, w, h, ow, oh, ctx.source_size, ctx.viewport, str(tex.device))
    geo = None if cache is None else cache.get(key)
    if geo is None:
        geo = _xbr_geometry(ctx, ow, oh, w, h, tex.device)
        if cache is not None:
            if len(cache) >= _XBR_GEOMETRIES_MAX:
                cache.clear()
            cache[key] = geo
    if geo is _XBR_INFEASIBLE:
        return None
    gathers, maps = geo
    S = _xbr_planes(tex, gathers, eq_thr, lv2_cf, small, y_weight, ctx.input_binding.quantized)
    return xe.xbr_epilogue(S[None], maps)[0]


def _xbr_geometry(ctx, ow: int, oh: int, w: int, h: int, dev):
    """What the xbr-lv2 kernel derives from a geometry: the front
    section's index tensors and the epilogue's maps, on ``dev``; or
    ``_XBR_INFEASIBLE``."""
    from retrocapture_tpu_torch.ops.cuda import xbr_epilogue as xe

    maps = _xbr_axis_maps(ctx, ow, oh, w, h)
    if maps is None:
        return _XBR_INFEASIBLE
    bx, fpx, tx, _, fpy, ty = maps
    # x-exactness gate: every x-tap's f32-floored index must equal
    # clamp(base + k) everywhere (true whenever ow/w is an integer ratio),
    # so x offsets factor to source-column shifts. Each y offset has its
    # own exact row gather, so the y axis needs no such property.
    for k, arr in tx.items():
        if not np.array_equal(np.clip(arr, 0, w - 1), np.clip(bx + k, 0, w - 1)):
            return _XBR_INFEASIBLE
    return _xbr_gathers(ty, h, w, dev), xe.prepare_maps(np.clip(bx, 0, w - 1).astype(np.int32), fpx, fpy, w, dev)


_REGISTRY = {
    "crt-mattias.glsl": _mattias_kernel,
    "xbr-lv2.glsl": _xbr_lv2_kernel,
}


def find_kernel(shader_path: str):
    """Hand kernel for a pass, or None (``RCTPU_KERNELS=off``, or no
    entry for the shader's basename)."""
    if os.environ.get("RCTPU_KERNELS", "on") == "off":
        return None
    return _REGISTRY.get(Path(shader_path).name)
