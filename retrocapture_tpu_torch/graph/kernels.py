"""Hand-written kernel-library entries: crt-mattias, xbr-lv2, the ntsc
2-phase passes and nnedi3.

The port of ``retrocapture_tpu/graph/kernels.py``: every entry of its
registry (19 shader basenames). The generic evaluator lowers any GLSL; an
entry here replaces one shader's whole fragment with a direct formulation
(torch sections around a CUDA kernel, or torch alone where the reference
has no Pallas kernel: the ntsc and nnedi3 entries, whose products are f32
matmuls with TF32 off), selected by the shader's basename through
``find_kernel``. An entry checks its own feasibility and returns None to
leave the pass to the evaluator, exactly where the reference's entry
declines. ``RCTPU_KERNELS=off`` disables the library; otherwise an entry
runs on either device, taking its kernels' plain versions on the CPU (the
reference's interpret mode). The reference's ntsc pass-2 entry declines on
a CPU outside interpret mode (the evaluator there is its GL-parity path);
the port's runs on both devices, like its other entries.

Numerics follow the reference as ``jax.jit`` compiles it: XLA's CPU
code contracts ``a*b + c`` into one rounding where the tests
(tests/test_torch_mattias.py, tests/test_torch_xbr.py) show it does,
which ``fma32`` reproduces,
and divides by a constant as a multiply by its reciprocal, taken in
f32 (``f32(1) / f32(c)``, one ulp below ``f32(1/c)`` for c = 3.14). The
f32 ``sin`` is the C library's ``sinf`` that XLA's CPU code calls, and the
pows take XLA's own ``log`` and ``exp``, as the jitted reference does:
``ops/cuda/mirrors`` computes them (the mirrors' CUDA kernel on a card,
``policy.sinf32``, ``logf32`` and ``expf32`` on the CPU), so that the CPU
and CUDA runs of the port agree with the reference and with each other.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from retrocapture_tpu_torch.ops.cuda import mirrors
from retrocapture_tpu_torch.ops.cuda.fma import fma32, fmaf32
from retrocapture_tpu_torch.policy import count, unrecorded, upload, walk_program

__all__ = ["find_kernel"]

_F = np.float32


def _glsl_pow(x, p: float):
    """Non-integer pow as the reference's kernels write it, exp2(p *
    log2(x)), in the form jitted XLA computes: its simplifier folds the
    two base-2 conversions into one constant, ``exp(log(x) * f32(f32(p *
    f32(1/ln 2)) * f32(ln 2)))``, with XLA's own ``log`` and ``exp``, in
    one pass (``mirrors.powf32``). NaN for x<0 flushes to 0 at the RGBA8
    store."""
    c = _F(_F(_F(p) * _F(1.0 / np.log(2.0))) * _F(np.log(2.0)))
    return mirrors.powf32(x, float(c))


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
    s = mirrors.sinf32(_rand_dt_sn(co_u, co_v)[1]) * float(_F(43758.5453))
    return s - torch.floor(s)


def _mattias_curve(u, v, du=None, dv=None):
    """crt-mattias.glsl curve(): barrel distortion; uv.y's factor uses
    the already-updated uv.x (statement order). ``1 + t*t`` and the
    affine tail contract as jitted XLA contracts them. ``du``/``dv``, when
    given, stand for ``u - 0.5``/``v - 0.5`` (see mattias_uv)."""
    x = (u - 0.5 if du is None else du) * 2.0 * float(_F(1.1))
    y = (v - 0.5 if dv is None else dv) * 2.0 * float(_F(1.1))
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


def mattias_uv(ow: int, oh: int, curvature: float, device, cross: bool = False):
    """The base warp of the fragment: q -> mix(q, curve(q), CURVATURE)
    over the output pixel centres, [oh, ow] f32 each.

    ``cross``: each output as the jitted reference computes it where a
    fusion produces that output alone (the blur's coordinates, the
    scanline's v). There the other axis's centre ``q = (i + 0.5) *
    f32(1/n)`` has one use, ``q - 0.5``, and XLA's CPU code contracts the
    two into one FMA; a fusion that computes both outputs (the vignette,
    the hash, the inside test) uses each q more than once and rounds the
    product first, as the default does (the dumped fusions' LLVM IR and
    object code)."""
    xg, yg = _pixel_grid(ow, oh, device)
    ru, rv = float(_F(1.0 / ow)), float(_F(1.0 / oh))
    q_u = (xg + 0.5) * ru
    q_v = (yg + 0.5) * rv
    if cross:
        cu = _mattias_curve(q_u, q_v, dv=fmaf32(yg + 0.5, rv, -0.5))[0]
        cv = _mattias_curve(q_u, q_v, du=fmaf32(xg + 0.5, ru, -0.5))[1]
    else:
        cu, cv = _mattias_curve(q_u, q_v)
    return fma32(cu - q_u, curvature, q_u), fma32(cv - q_v, curvature, q_v)


_INFEASIBLE = "infeasible"  # a geometry a kernel declines, kept as such


def _kept(key, build, keep: bool = True):
    """``build()``, kept under ``key`` in the tables of the engine's program
    whose walk runs (``policy.walk_program``) where ``keep``, built anew
    otherwise and in a walk with no program (concrete FrameCount). For
    what an entry derives from the program's key and constant parameters
    alone: the program (and a graph captured from its walk) reads it for
    its whole life, and the engine drops the programs when a parameter or
    the viewport changes. The uploads of ``build`` belong to the kept
    value, not to the walk's recorded sequence."""
    wp = walk_program()
    if not keep or wp is None:
        return build()
    if key not in wp.tables:
        with unrecorded():
            wp.tables[key] = build()
    return wp.tables[key]


def _mattias_geometry(w: int, h: int, ow: int, oh: int, dev):
    """What the crt-mattias kernel derives from the sizes alone: the blur
    groups and the comb mask's factor [oh, ow, 1]. ``_INFEASIBLE`` where
    the blur gate declines the geometry."""
    from retrocapture_tpu_torch.ops.cuda.blur_groups import blur_groups_fits

    groups = mattias_groups(ow, oh)
    if not blur_groups_fits((h, w, 3), (oh, ow), groups, max_dudv=_MATTIAS_MAX_DUDV, device=dev):
        return _INFEASIBLE
    return groups, _mattias_comb(ow, oh, dev)


def _mattias_comb(ow: int, oh: int, dev):
    """The comb mask's factor [oh, ow, 1]."""
    xg, yg = _pixel_grid(ow, oh, dev)
    o = fma32(torch.remainder(yg + 0.5, 2.0), float(_F(2.0) * _F(1.0 / ow)), xg + 0.5)
    comb = torch.clamp((torch.remainder(o, 2.0) - 1.0) * 2.0, 0.0, 1.0)
    return fma32(comb, -0.15, 1.0)[..., None]


def _mattias_warp(ow: int, oh: int, curvature, dev):
    """What the crt-mattias kernel derives from CURVATURE (a constant, or
    the f32 0-d tensor of a traced parameter): the base warp (uv_u, uv_v)
    and the blur's own (bu, bv, mattias_uv), the vignette's pow and the
    inside test, [oh, ow, 1] each."""
    uv_u, uv_v = mattias_uv(ow, oh, curvature, dev)
    bu, bv = mattias_uv(ow, oh, curvature, dev, cross=True)
    vig = _glsl_pow(16.0 * uv_u * uv_v * (1.0 - uv_u) * (1.0 - uv_v), 0.3)
    inside = (uv_u >= 0.0) & (uv_u <= 1.0) & (uv_v >= 0.0) & (uv_v <= 1.0)
    return uv_u, uv_v, bu, bv, vig[..., None], inside[..., None]


def _param(ctx, name: str, default: float):
    """A parameter of the pass: an f32 constant in const mode, the f32 0-d
    device tensor of its buffer in traced mode."""
    v = ctx.params.get(name, _F(default))
    return v if isinstance(v, torch.Tensor) else _F(v)


def _mattias_epilogue_plain(planes, bv, uv_u, uv_v, vig, comb, inside, fcf, scanspeed, oh: int, ow: int):
    """crt-mattias.glsl's main tail on one frame, as eager passes: the blur
    planes ``{channel: [OH, OW]}`` f32 to RGBA ``[OH, OW, 4]`` f32. The
    maps are ``_mattias_warp``'s (``bv [OH, OW]``, ``uv_u``, ``uv_v [OH,
    OW]``, ``vig``, ``inside [OH, OW, 1]``) and ``_mattias_geometry``'s
    ``comb [OH, OW, 1]``; ``fcf`` the f32 0-d FrameCount and ``scanspeed``
    SCANSPEED (an f32 constant, or the f32 0-d device tensor of a traced
    parameter). The plain version of ``rctpu::mattias_epilogue``
    (ops/cuda/mattias_epilogue.py) and the route of a CPU tensor."""
    dev = bv.device
    # t = FrameCount / 60 enters three products with constants; XLA folds
    # each chain into one constant times FrameCount.
    t60 = _F(1.0) / _F(60.0)
    posts = {0: 0.0, 1: 0.0, 2: 0.0}
    for ch, _, _, _, _, post in _MATTIAS_GROUPS:
        posts[ch] += post
    col = torch.stack([planes[ch] + float(_F(posts[ch])) for ch in range(3)], dim=-1)

    # epilogue (crt-mattias.glsl main tail), each step in the form of the
    # reference's jitted fusion: a product with one use contracted into
    # the add or subtract that takes it, the constant factors of the
    # scanline and flicker chains folded, ``x * 3.8 * scans`` taken as
    # ``x * (scans * 3.8)``.
    col = torch.clamp(fma32(col, 0.4, (col * 0.6) * col), 0.0, 1.0)
    col = col * vig
    col = col * upload(np.array([0.95, 1.05, 0.95], np.float32), dev)
    col = fma32(fma32(col, col, -col), 0.3, col)
    # The scanline phase of every pixel and the flicker's one phase go
    # through the sine together: one launch, not two.
    if isinstance(scanspeed, torch.Tensor):
        scan_t = ((fcf * float(t60)) * scanspeed) * 3.5
    else:
        scan_t = fcf * float(_F(_F(t60 * scanspeed) * _F(3.5)))
    scan_arg = fma32(bv, float(_F(_F(oh) * _F(1.5))), scan_t)
    sines = mirrors.sinf32(torch.cat([scan_arg.reshape(-1), (fcf * float(_F(300.0) * t60)).reshape(1)]))
    scans = torch.clamp(fma32(sines[:-1].reshape(oh, ow), 0.15, 0.35), 0.0, 1.0)
    col = col * (_glsl_pow(scans, 0.9) * 3.8)[..., None]
    col = col * fma32(sines[-1], 0.0015, 1.0)
    col = col * comb
    # rand(uv + 1e-4 t + {0, 0.3, 0.5}) per channel: the three hashes in
    # one pass over a stacked [oh, ow, 3] argument.
    offs = upload(np.array([0.0, 0.3, 0.5], np.float32), dev)
    drift = fcf * float(_F(t60 * _F(0.0001)))
    noise = _rand((uv_u + drift)[..., None] + offs, (uv_v + drift)[..., None] + offs)
    col = col * fma32(noise, -0.25, 1.0)
    col = _glsl_pow(torch.clamp_min(col, 0.0), 0.45)
    col = torch.where(inside, col, 0.0)
    col = torch.where(torch.isnan(col), 0.0, col)
    return torch.cat([col, torch.ones((oh, ow, 1), dtype=torch.float32, device=dev)], dim=-1)


def _mattias_kernel(ctx, sh):
    """crt-mattias.glsl on the kernel library: the 9-group blur and the
    epilogue (CUDA kernels on the card, their plain versions on the CPU).
    Returns None when infeasible."""
    from retrocapture_tpu_torch.ops.cuda.blur_groups import blur5x5_groups
    from retrocapture_tpu_torch.ops.cuda.mattias_epilogue import mattias_epilogue
    from retrocapture_tpu_torch.ops.preconv_blur import blur_preconv, blur_preconv_fits

    cfg = ctx.program.preset.passes[ctx.i]
    if cfg.filter_linear or cfg.wrap_mode != "clamp_to_edge":
        return None
    tex = ctx.input_binding.tex
    h, w = int(tex.shape[0]), int(tex.shape[1])
    ow, oh = ctx.out_size
    dev = tex.device
    # A traced parameter is an f32 0-d tensor on the device (the engine's
    # parameter buffer): what derives from it is computed on every walk,
    # never read back to the host or kept.
    curvature = _param(ctx, "CURVATURE", 0.5)
    scanspeed = _param(ctx, "SCANSPEED", 1.0)
    geo = _kept(("crt-mattias", ctx.i, w, h, ow, oh, str(dev)), lambda: _mattias_geometry(w, h, ow, oh, dev))
    if geo is _INFEASIBLE:
        return None
    groups, comb = geo
    if isinstance(curvature, torch.Tensor):
        warp = _mattias_warp(ow, oh, curvature, dev)
    else:
        warp = _kept(("crt-mattias-warp", ow, oh, float(curvature), str(dev)), lambda: _mattias_warp(ow, oh, float(curvature), dev))
    uv_u, uv_v, bu, bv, vig, inside = warp

    fcf = upload(ctx.frame_count, dev).to(torch.float32)

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
        planes = blur_preconv(p, bu, bv, groups)
    else:
        planes = blur5x5_groups(p, bu, bv, groups)

    return mattias_epilogue(planes, bv, uv_u, uv_v, vig, comb, inside, fcf, scanspeed)


# ---------------------------------------------------------------------------
# xbr-lv2 (shaders_glsl/xbr/shaders/xbr-lv2.glsl): every NEAREST tap index
# is an integer offset of the base source texel, so the tap and
# edge-detection section runs at [output rows, source columns] (the CUDA
# front section, ops/cuda/xbr_front.py, whose plain version is _xbr_planes)
# and only the fp-ramp blend is full resolution (the CUDA epilogue,
# ops/cuda/xbr_epilogue.py). The reference's XLA tails (the one-hot matmul and the
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
    cols = upload(torch.from_numpy(np.clip(np.arange(-2, w + 2), 0, w - 1)), dev)
    rows = {k: upload(torch.from_numpy(np.clip(ty[k], 0, h - 1)), dev) for k in (-2, -1, 0, 1, 2)}
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




def _xbr_lv2_kernel(ctx, sh):
    """xbr-lv2.glsl on the kernel library: the front section at [output
    rows, source columns] (``rctpu::xbr_front``, whose plain version is
    ``_xbr_planes``) and the epilogue (``rctpu::xbr_epilogue``), each a
    CUDA kernel on the card. Returns None when infeasible."""
    from retrocapture_tpu_torch.ops.cuda import xbr_epilogue as xe
    from retrocapture_tpu_torch.ops.cuda import xbr_front as xf

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
    # the compiled program and built per frame otherwise.
    key = ("xbr-lv2", ctx.i, w, h, ow, oh, ctx.source_size, ctx.viewport, str(tex.device))
    geo = _kept(key, lambda: _xbr_geometry(ctx, ow, oh, w, h, tex.device), ctx.program.passes[ctx.i].vertex_static)
    if geo is _INFEASIBLE:
        return None
    gathers, maps = geo
    S = xf.xbr_front(tex[None], gathers, eq_thr, lv2_cf, small, y_weight, ctx.input_binding.quantized)
    return xe.xbr_epilogue(S, maps)[0]


def _xbr_geometry(ctx, ow: int, oh: int, w: int, h: int, dev):
    """What the xbr-lv2 kernel derives from a geometry: the front
    section's index tensors and the epilogue's maps, on ``dev``; or
    ``_INFEASIBLE``."""
    from retrocapture_tpu_torch.ops.cuda import xbr_epilogue as xe

    maps = _xbr_axis_maps(ctx, ow, oh, w, h)
    if maps is None:
        return _INFEASIBLE
    bx, fpx, tx, _, fpy, ty = maps
    # x-exactness gate: every x-tap's f32-floored index must equal
    # clamp(base + k) everywhere (true whenever ow/w is an integer ratio),
    # so x offsets factor to source-column shifts. Each y offset has its
    # own exact row gather, so the y axis needs no such property.
    for k, arr in tx.items():
        if not np.array_equal(np.clip(arr, 0, w - 1), np.clip(bx + k, 0, w - 1)):
            return _INFEASIBLE
    return _xbr_gathers(ty, h, w, dev), xe.prepare_maps(np.clip(bx, 0, w - 1).astype(np.int32), fpx, fpy, w, dev)


# ---------------------------------------------------------------------------
# ntsc 2-phase (shaders_glsl/ntsc/shaders/ntsc-pass1-*-2phase.glsl,
# ntsc-pass2-2phase{,-gamma,-linear}.glsl; bench config ntsc-320px).
#
# Pass 1 (encode): with frame_count_mod0 = 2 the shader sees FrameCount in
# {0, 1}, and its chroma phase cos/sin(PI*(mod(y, 2) + fc) + x*CMF) depends
# on the pixel only through (y & 1, x): four [W] rows, built once on the
# host with the evaluator's step order and llvmpipe trig (_lp_trig) and
# selected per frame by fc % 2 on the device. The absolute-scale
# x-upsample is NEAREST at an integer ratio: repeat_interleave.
#
# Pass 2 (decode): the 65-tap x FIR and the decimate-by-2 are one [in_w,
# out_w] band matrix per filter (luma, chroma), built once in numpy by
# _ntsc_band_np_cols' clamped-accumulation rule (the reference's iota /
# barrier / select-sum build exists only for XLA and Mosaic) and uploaded
# once per geometry and device: one f32 matmul per channel, TF32 off.

# begin params block constants (f32 stepwise, evaluator order)
_NTSC_PI = np.float32(3.14159265)
_NTSC_CMF2 = np.float32(np.float32(4.0) * _NTSC_PI) / np.float32(15.0)

# rgb2yiq / mix_mat columns ([col][row] per GLSL column-major ctor).
_NTSC_YIQ_COLS = (
    (np.float32(0.2989), np.float32(0.5870), np.float32(0.1140)),
    (np.float32(0.5959), np.float32(-0.2744), np.float32(-0.3216)),
    (np.float32(0.2115), np.float32(-0.5229), np.float32(0.3114)),
)
_NTSC_MIX_COLS = {
    False: ((1.0, 1.0, 1.0), (1.0, 2.0, 0.0), (1.0, 0.0, 2.0)),  # composite
    True: ((1.0, 0.0, 0.0), (0.0, 2.0, 0.0), (0.0, 0.0, 2.0)),  # svideo
}

# Filter constants: the shader's own float[TAPS+1] tables
# (ntsc-pass2-2phase-gamma.glsl:186-254).
_NTSC2_LUMA = (
    -0.000174844, -0.000205844, -0.000149453, -0.000051693,
    0.000000000, -0.000066171, -0.000245058, -0.000432928,
    -0.000472644, -0.000252236, 0.000198929, 0.000687058,
    0.000944112, 0.000803467, 0.000363199, 0.000013422,
    0.000253402, 0.001339461, 0.002932972, 0.003983485,
    0.003026683, -0.001102056, -0.008373026, -0.016897700,
    -0.022914480, -0.021642347, -0.008863273, 0.017271957,
    0.054921920, 0.098342579, 0.139044281, 0.168055832,
    0.178571429,
)
_NTSC2_CHROMA = (
    0.001384762, 0.001678312, 0.002021715, 0.002420562,
    0.002880460, 0.003406879, 0.004004985, 0.004679445,
    0.005434218, 0.006272332, 0.007195654, 0.008204665,
    0.009298238, 0.010473450, 0.011725413, 0.013047155,
    0.014429548, 0.015861306, 0.017329037, 0.018817382,
    0.020309220, 0.021785952, 0.023227857, 0.024614500,
    0.025925203, 0.027139546, 0.028237893, 0.029201910,
    0.030015081, 0.030663170, 0.031134640, 0.031420995,
    0.031517031,
)

# yiq2rgb_mat columns ([col][row], GLSL column-major ctor).
_NTSC_YIQ2RGB_COLS = (
    (np.float32(1.0), np.float32(0.956), np.float32(0.6210)),
    (np.float32(1.0), np.float32(-0.2720), np.float32(-0.6474)),
    (np.float32(1.0), np.float32(-1.1060), np.float32(1.7046)),
)

def _ntsc_phase_rows(w_out: int):
    """[2(fc), 2(y&1), w_out] cos/sin chroma-phase constants, bit-matched
    to the evaluator: same f32 step order, same _lp_trig polynomials
    (numpy path = exact-FMA llvmpipe match)."""
    from retrocapture_tpu_torch.frontend.builtins import _lp_trig

    x = np.arange(w_out, dtype=np.float32) + np.float32(0.5)  # pix_no.x
    t = (x * _NTSC_CMF2).astype(np.float32)
    cosr = np.empty((2, 2, w_out), np.float32)
    sinr = np.empty((2, 2, w_out), np.float32)
    for fcm in range(2):
        for ypar in range(2):
            s = np.float32(np.float32(ypar) + np.float32(0.5)) + np.float32(
                np.float32(fcm)
            )
            cp = np.float32(_NTSC_PI * s)
            mp = (cp + t).astype(np.float32)
            cosr[fcm, ypar] = _lp_trig(np, mp, True)
            sinr[fcm, ypar] = _lp_trig(np, mp, False)
    return cosr, sinr


def _ntsc_band_np_cols(weights, in_w: int, xs):
    """Exact numpy band columns (clamped-tap accumulation) for the given
    x positions — used for the edge strips where taps clamp."""
    taps = len(weights) - 1
    m = np.zeros((in_w, len(xs)), np.float32)
    for ci, x in enumerate(xs):
        for k in range(-taps, taps + 1):
            j = min(max(2 * x + k, 0), in_w - 1)
            m[j, ci] += np.float32(weights[taps - abs(k)])
    return m


def _ntsc_band_matrix(weights, in_w: int, out_w: int) -> np.ndarray:
    """[in_w, out_w] f32 band matrix: column x accumulates weight w_|k| at
    row clamp(2x + k, 0, in_w - 1), k in [-32, 32], in the reference's
    order (its device build equals these columns, tests/test_kernels_ntsc.py)."""
    return _ntsc_band_np_cols(weights, in_w, range(out_w))


def _dot3(a0, a1, a2, cols):
    """``[..., 3] x [3, 3]`` as jitted XLA's CPU dot computes ``v * mat``
    for a [rows, 3] operand: output columns 0 and 1 as ``(a0*b0 + a1*b1) +
    a2*b2`` rounded per step, column 2 as two FMAs in k order
    (tests/test_torch_ntsc.py holds all three bit-equal). ``cols`` holds the
    three output columns' weights."""
    out = []
    for c, (b0, b1, b2) in enumerate(cols):
        b0, b1, b2 = float(_F(b0)), float(_F(b1)), float(_F(b2))
        if c < 2:
            out.append((a0 * b0 + a1 * b1) + a2 * b2)
        else:
            out.append(fmaf32(a2, b2, fmaf32(a1, b1, a0 * b0)))
    return out


def _ntsc_pass1_2phase_kernel(ctx, sh, *, svideo: bool):
    cfg = ctx.program.preset.passes[ctx.i]
    if cfg.filter_linear or cfg.wrap_mode != "clamp_to_edge" or cfg.mipmap_input:
        return None
    if cfg.frame_count_mod != 2:
        return None  # field enumeration relies on fc in {0, 1}
    ow, oh = ctx.out_size
    h, w = sh.in_h, sh.in_w
    if oh != h or ow % w != 0:
        return None
    r = ow // w
    tex = ctx.input_binding.tex
    if tex.shape[0] != h or tex.shape[1] != w:
        return None
    dev = tex.device

    def build():
        cosr, sinr = _ntsc_phase_rows(ow)
        return upload(np.stack([cosr, sinr], axis=1), dev)  # [2(fc), 2(cos, sin), 2(y&1), ow]

    rows = _kept(("ntsc-phase", ow, str(dev)), build)
    fc = ctx.frame_count
    if isinstance(fc, torch.Tensor):
        # A device index: no host decision from the frame count.
        sel = rows.index_select(0, torch.remainder(fc.reshape(1).to(dev), 2).to(torch.int64))[0]
    else:
        sel = rows[int(np.asarray(fc)) % 2]  # RCTPU_CONCRETE_FC=1: a host constant
    reps = (h + 1) // 2  # row parity tiled; h may be odd
    i_mod = sel[0].repeat(reps, 1)[:h]
    q_mod = sel[1].repeat(reps, 1)[:h]

    # The reference's CPU form (its v * mat einsums) plane by plane.
    up = tex[..., :3].repeat_interleave(r, dim=1)  # [h, ow, 3] NEAREST
    y, i, q = _dot3(up[..., 0], up[..., 1], up[..., 2], _NTSC_YIQ_COLS)
    i, q = i * i_mod, q * q_mod  # modulate
    cx, cy, cz = _dot3(y, i, q, _NTSC_MIX_COLS[svideo])
    ones = torch.ones((h, ow), dtype=torch.float32, device=dev)
    return torch.stack([cx, cy * i_mod, cz * q_mod, ones], dim=-1)  # demodulate


def _ntsc_row_index(ow: int, oh: int, h: int) -> np.ndarray:
    """The last pass's NEAREST row map to the viewport height: the
    evaluator's plane setup for vTexCoord.y (corners 0/1/1), the f64
    affine evaluation cast once to f32, then the NEAREST floor. A naive
    (y + 0.5) / oh picks other rows at the 4.5-ratio boundaries."""
    from retrocapture_tpu_torch.runtime.engine import _plane_setup_f32

    a0, _dadx, dady = _plane_setup_f32(ow, oh, np.float32(0.0), np.float32(1.0), np.float32(1.0))
    coord = (np.float64(dady) * np.arange(oh, dtype=np.float64) + np.float64(a0)).astype(np.float32)
    return np.clip(np.floor(coord * h).astype(np.int64), 0, h - 1)


def _ntsc_pass2_2phase_kernel(ctx, sh, *, gamma):
    """gamma: None (plain), or the constant f32 exponent (2.5/2.0 for
    -gamma, 2.4 for -linear)."""
    cfg = ctx.program.preset.passes[ctx.i]
    if cfg.filter_linear or cfg.wrap_mode != "clamp_to_edge" or cfg.mipmap_input:
        return None
    ow, oh = ctx.out_size
    h, w = sh.in_h, sh.in_w
    if w != 2 * ow:
        return None
    tex = ctx.input_binding.tex
    if tex.shape[0] != h or tex.shape[1] != w:
        return None
    dev = tex.device
    ml = _kept(("ntsc-luma", w, ow, str(dev)), lambda: upload(_ntsc_band_matrix(_NTSC2_LUMA, w, ow), dev))
    mc = _kept(("ntsc-chroma", w, ow, str(dev)), lambda: upload(_ntsc_band_matrix(_NTSC2_CHROMA, w, ow), dev))
    # One band product per channel; the FIR is y-invariant, so it and the
    # gamma run at the h source rows.
    y = tex[..., 0] @ ml
    i = tex[..., 1] @ mc
    q = tex[..., 2] @ mc
    (r0, r1, r2), (g0, g1, g2), (b0, b1, b2) = (tuple(float(c) for c in col) for col in _NTSC_YIQ2RGB_COLS)
    rgb = [y * r0 + i * r1 + q * r2, y * g0 + i * g1 + q * g2, y * b0 + i * b1 + q * b2]
    if gamma is not None:
        rgb = [_glsl_pow(c, gamma) for c in rgb]
    if oh != h:
        # The last pass lands at the viewport height (its explicit source
        # 1.0 y scale upgrades to the viewport): NEAREST row expansion as
        # a row gather, never a one-hot matmul, so that a row whose
        # negative FIR went NaN under pow keeps its NaN to itself.
        idx = _kept(("ntsc-rows", ow, oh, h, str(dev)), lambda: upload(torch.from_numpy(_ntsc_row_index(ow, oh, h)), dev))
        rgb = [c.index_select(0, idx) for c in rgb]
    return torch.stack(rgb + [torch.ones((oh, ow), dtype=torch.float32, device=dev)], dim=-1)


def _ntsc_pass2_2phase(ctx, sh):
    return _ntsc_pass2_2phase_kernel(ctx, sh, gamma=None)


def _ntsc_pass2_2phase_gamma(ctx, sh):
    return _ntsc_pass2_2phase_kernel(ctx, sh, gamma=np.float32(np.float32(2.5) / np.float32(2.0)))


def _ntsc_pass2_2phase_linear(ctx, sh):
    return _ntsc_pass2_2phase_kernel(ctx, sh, gamma=np.float32(2.4))


def _ntsc_pass1_composite_2phase(ctx, sh):
    """ntsc-pass1-composite-2phase.glsl (ntsc/ntsc-320px.glslp pass 0)."""
    return _ntsc_pass1_2phase_kernel(ctx, sh, svideo=False)


def _ntsc_pass1_svideo_2phase(ctx, sh):
    """ntsc-pass1-svideo-2phase.glsl (ntsc/ntsc-320px-svideo.glslp)."""
    return _ntsc_pass1_2phase_kernel(ctx, sh, svideo=True)


# ---------------------------------------------------------------------------
# nnedi3 (shaders_glsl/nnedi3/shaders/nnedi3-nns*-win8x4-pass{1,2}-*.glsl):
# neural edge-directed doubling. The shader embeds its net as ~nns*66
# inline intBitsToFloat literals and evaluates, per predicted pixel, an
# 8x4-window [32]-vector through 2*nns neuron dot products. Here the
# weights are parsed once from the shader text and the pass becomes one
# launch of rctpu::nnedi3 (ops/cuda/nnedi3.py) on the card; its plain
# version, _nnedi3_plain, runs on the CPU: 32 shifted tap planes of the
# edge-padded input -> two [32, nns] contractions (one matmul, accumulated
# in f64 and rounded once to f32) -> the exp/softsign mix -> the interleave
# along the doubled axis. pass2 is pass1 transposed (x-doubling); -rgb runs
# 3 channels, -luma channel 0 only.
#
# Tap geometry (pass1, scale source 1x2, NEAREST, clamp_to_edge): output
# row 2r is source row r; row 2r+1 is predicted from source rows r-1..r+2
# and columns x-3..x+4. The half-texel floors are exact in f32, so taps
# are integer shifts with edge clamp.

_NNEDI3_W_RE = None


def _nnedi3_weights(shader_path: str):
    """Parse the per-neuron weight literals from the shader source.
    Returns (W1 [32, nns], B1 [nns], W2 [32, nns], B2 [nns]) float32,
    or None when the source does not match the expected structure.
    Weight order: flat q = s*4 + c over samples[s] components — the
    window position is (dy, dx) = (s//2 - 1, (s % 2)*4 + c - 3) for
    pass1, transposed for pass2 (handled by the tap builder)."""
    import re

    global _NNEDI3_W_RE
    if _NNEDI3_W_RE is None:
        _NNEDI3_W_RE = (
            re.compile(r"W\((\d),(-?\d+),(-?\d+),(-?\d+),(-?\d+)\)"),
            re.compile(r"WS\((-?\d+),(-?\d+)\)"),
            re.compile(r"sum1=(.*?);sum2=(.*?);WS\((-?\d+),(-?\d+)\);"),
        )
    w_re, _ws_re, line_re = _NNEDI3_W_RE
    try:
        src = Path(shader_path).read_text(encoding="utf-8", errors="replace")
    except OSError:
        return None
    neurons = line_re.findall(src)
    if not neurons:
        return None
    w1, w2, b1, b2 = [], [], [], []

    def vec32(expr):
        terms = w_re.findall(expr)
        if len(terms) != 8:
            return None
        v = np.zeros(32, np.int32)
        seen = set()
        for s, a, b, c, d in terms:
            s = int(s)
            if s in seen:
                return None
            seen.add(s)
            v[s * 4 : s * 4 + 4] = [int(a), int(b), int(c), int(d)]
        return v

    for e1, e2, bb1, bb2 in neurons:
        v1, v2 = vec32(e1), vec32(e2)
        if v1 is None or v2 is None:
            return None
        w1.append(v1)
        w2.append(v2)
        b1.append(int(bb1))
        b2.append(int(bb2))
    W1 = np.stack(w1, axis=1).view(np.float32)
    W2 = np.stack(w2, axis=1).view(np.float32)
    B1 = np.asarray(b1, np.int32).view(np.float32)
    B2 = np.asarray(b2, np.int32).view(np.float32)
    if not (np.isfinite(W1).all() and np.isfinite(W2).all()):
        return None
    return W1, W2, B1, B2


_NNEDI3_WCACHE: dict = {}  # shader path -> the parsed weights (numpy) or None


def _nnedi3_plain(tex, wt, bias, axis: int, comps: int):
    """One nnedi3 pass on one frame as eager passes: ``tex [h, w, C]`` f32,
    the net's ``wt`` f64 [2 nns, 32] and ``bias`` f32 [2 nns] (b1, then b2;
    ``ops/cuda/nnedi3.net``) → RGBA [oh, ow, 4] f32. The plain version of
    ``rctpu::nnedi3`` (ops/cuda/nnedi3.py) and the route of a CPU tensor."""
    h, w = int(tex.shape[0]), int(tex.shape[1])
    oh, ow = (2 * h, w) if axis == 0 else (h, 2 * w)
    dev = tex.device
    nns = bias.shape[0] // 2
    b1, b2 = bias[:nns, None], bias[nns:, None]

    # 32 tap planes at source resolution: q = s*4 + cw; pass1 window (dy,
    # dx) = (s//2 - 1, (s%2)*4 + cw - 3), pass2 the transpose; edge clamp.
    pad = ((1, 2), (3, 4)) if axis == 0 else ((3, 4), (1, 2))
    src = tex[..., :comps].to(torch.float32)
    rows = torch.arange(-pad[0][0], h + pad[0][1], device=dev).clamp(0, h - 1)
    cols = torch.arange(-pad[1][0], w + pad[1][1], device=dev).clamp(0, w - 1)
    padded = src.index_select(0, rows).index_select(1, cols)
    taps = []
    for s in range(8):
        for cw in range(4):
            du, dv = s // 2 - 1, (s % 2) * 4 + cw - 3  # (minor, major)
            dy, dx = (du, dv) if axis == 0 else (dv, du)
            oy, ox = dy + pad[0][0], dx + pad[1][0]
            taps.append(padded[oy : oy + h, ox : ox + w])
    S = torch.stack(taps).reshape(32, -1)  # [32, h*w*comps]

    # The sums and the contraction accumulate in f64 and round once to
    # f32: a sum's order differs between the CPU and the card (and from
    # XLA's), and exp and the RGBA8 store between the two passes amplify
    # an ulp of it to two u8 steps; rounded once, both devices agree.
    S64 = S.to(torch.float64)
    ssum = S64.sum(dim=0).to(torch.float32)
    sumsq = (S64 * S64).sum(dim=0).to(torch.float32)
    mstd0 = ssum * float(_F(1.0 / 32.0))
    mstd1 = sumsq * float(_F(1.0 / 32.0)) - mstd0 * mstd0
    ok = mstd1 >= float(_F(1.192092896e-7))
    mstd2 = torch.where(ok, 1.0 / torch.sqrt(mstd1), 0.0)
    mstd1 = mstd1 * mstd2

    d = (wt @ S64).to(torch.float32)  # [2 nns, h*w*comps]
    e1 = mirrors.expf32(d[:nns] * mstd2 + b1)
    s2 = d[nns:] * mstd2 + b2
    wsum = e1.to(torch.float64).sum(dim=0).to(torch.float32)
    vsum = (e1 * (s2 / (1.0 + torch.abs(s2)))).to(torch.float64).sum(dim=0).to(torch.float32)
    pred = torch.clamp(mstd0 + 5.0 * vsum / wsum * mstd1, 0.0, 1.0).reshape(h, w, comps)

    # Interleave passthrough/predicted along the doubled axis (even
    # positions are the source rows/cols).
    out = torch.stack([src, pred], dim=1 if axis == 0 else 2).reshape(oh, ow, comps)
    ones = torch.ones((oh, ow, 4 - comps), dtype=torch.float32, device=dev)
    return torch.cat([out, ones], dim=-1)


def _nnedi3_kernel(ctx, sh, *, axis: int, comps: int):
    """axis 0 = pass1 (y-doubling), 1 = pass2 (x-doubling); comps 3 for
    -rgb, 1 for -luma. The pass is one ``rctpu::nnedi3`` launch on the card
    (``ops/cuda/nnedi3.py``), ``_nnedi3_plain`` on the CPU. Declines a net
    whose neuron count the kernel has no form for."""
    from retrocapture_tpu_torch.ops.cuda.nnedi3 import NNS, net, nnedi3

    cfg = ctx.program.preset.passes[ctx.i]
    if cfg.filter_linear or cfg.wrap_mode != "clamp_to_edge" or cfg.mipmap_input:
        return None
    tex = ctx.input_binding.tex
    h, w = int(tex.shape[0]), int(tex.shape[1])
    ow, oh = ctx.out_size
    if axis == 0 and (ow != w or oh != 2 * h):
        return None
    if axis == 1 and (ow != 2 * w or oh != h):
        return None

    key = str(cfg.shader_path)
    if key not in _NNEDI3_WCACHE:
        _NNEDI3_WCACHE[key] = _nnedi3_weights(key)
    packs = _NNEDI3_WCACHE[key]
    if packs is None or packs[2].shape[0] not in NNS:
        return None
    dev = tex.device
    wt, bias = _kept(("nnedi3", key, str(dev)), lambda: tuple(upload(torch.from_numpy(a), dev) for a in net(*packs)))
    return nnedi3(tex, wt, bias, axis=axis, comps=comps)


def _make_nnedi3(axis: int, comps: int):
    def k(ctx, sh):
        out = _nnedi3_kernel(ctx, sh, axis=axis, comps=comps)
        if out is None:
            count(("nnedi3", ctx.i), {"nnedi3_declined": 1})
        else:
            tex = ctx.input_binding.tex  # one frame's, under vmap too
            values = int(tex.shape[0]) * int(tex.shape[1]) * comps
            count(("nnedi3", ctx.i), {"nnedi3_passes": 1, "nnedi3_values": values})
        return out

    return k


_REGISTRY = {
    "crt-mattias.glsl": _mattias_kernel,
    "xbr-lv2.glsl": _xbr_lv2_kernel,
    "ntsc-pass1-composite-2phase.glsl": _ntsc_pass1_composite_2phase,
    "ntsc-pass1-svideo-2phase.glsl": _ntsc_pass1_svideo_2phase,
    "ntsc-pass2-2phase.glsl": _ntsc_pass2_2phase,
    "ntsc-pass2-2phase-gamma.glsl": _ntsc_pass2_2phase_gamma,
    "ntsc-pass2-2phase-linear.glsl": _ntsc_pass2_2phase_linear,
}

for _nns in (16, 32, 64):
    for _pass, _ax in (("pass1", 0), ("pass2", 1)):
        for _kind, _nc in (("luma", 1), ("rgb", 3)):
            _REGISTRY[f"nnedi3-nns{_nns}-win8x4-{_pass}-{_kind}.glsl"] = _make_nnedi3(_ax, _nc)


def find_kernel(shader_path: str):
    """Hand kernel for a pass, or None (``RCTPU_KERNELS=off``, or no
    entry for the shader's basename)."""
    if os.environ.get("RCTPU_KERNELS", "on") == "off":
        return None
    return _REGISTRY.get(Path(shader_path).name)
