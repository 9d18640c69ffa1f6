"""Hand-written kernel-library entries: the crt-mattias pass.

The port of the crt-mattias part of ``retrocapture_tpu/graph/kernels.py``.
The generic evaluator lowers any GLSL; an entry here replaces one
shader's whole fragment with a direct formulation (a CUDA blur kernel
and a torch epilogue), selected by the shader's basename through
``find_kernel``. An entry checks its own feasibility and returns None to
leave the pass to the evaluator. ``RCTPU_KERNELS=off`` disables the
library; otherwise an entry runs on either device, taking its kernels'
plain versions on the CPU (the reference's interpret mode).

Numerics follow the reference as ``jax.jit`` compiles it: XLA's CPU
code contracts ``a*b + c`` into one rounding where the tests
(tests/test_torch_mattias.py) show it does, which ``fma32`` reproduces,
and divides by a constant as a multiply by its reciprocal, taken in
f32 (``f32(1) / f32(c)``, one ulp below ``f32(1/c)`` for c = 3.14). The
hash's ``sin`` is taken in float64 and rounded once to f32, so that the
CPU and CUDA runs of the port agree; XLA's own f32 ``sin`` is within an
ulp of it.

The xbr-lv2, ntsc 2-phase and nnedi3 entries of the reference are not
ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from retrocapture_tpu_torch.policy import fma32

__all__ = ["find_kernel"]

_F = np.float32


def _glsl_pow(x, p: float):
    """Non-integer pow exactly as the evaluator lowers it
    (frontend/builtins._b_pow): exp2(p * log2(x)); NaN for x<0 flushes
    to 0 at the RGBA8 store."""
    return torch.exp2(float(_F(p)) * torch.log2(x))


def _sin32(x):
    """f32 sin rounded once from float64: the same bits on the CPU and
    in CUDA."""
    return torch.sin(x.to(torch.float64)).to(torch.float32)


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
    s = _sin32(_rand_dt_sn(co_u, co_v)[1]) * float(_F(43758.5453))
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
    scans = torch.clamp(
        0.35 + 0.15 * _sin32(3.5 * (t * scanspeed) + uv_v * float(oh) * 1.5),
        0.0,
        1.0,
    )
    col = col * _glsl_pow(scans, 0.9)[..., None]
    col = col * (1.0 + 0.0015 * _sin32(300.0 * t))
    o = 2.0 * torch.remainder(yg + 0.5, 2.0) * float(_F(1.0 / ow))
    fx = xg + 0.5
    comb = torch.clamp((torch.remainder(fx + o, 2.0) - 1.0) * 2.0, 0.0, 1.0)
    col = col * (1.0 - 0.15 * comb)[..., None]
    n0 = _rand(uv_u + 0.0001 * t, uv_v + 0.0001 * t)
    n1 = _rand(uv_u + 0.0001 * t + 0.3, uv_v + 0.0001 * t + 0.3)
    n2 = _rand(uv_u + 0.0001 * t + 0.5, uv_v + 0.0001 * t + 0.5)
    col = col * (1.0 - 0.25 * torch.stack([n0, n1, n2], dim=-1))
    col = _glsl_pow(torch.clamp_min(col, 0.0), 0.45)
    inside = (uv_u >= 0.0) & (uv_u <= 1.0) & (uv_v >= 0.0) & (uv_v <= 1.0)
    col = torch.where(inside[..., None], col, 0.0)
    col = torch.where(torch.isnan(col), 0.0, col)
    return torch.cat([col, torch.ones((oh, ow, 1), dtype=torch.float32, device=dev)], dim=-1)


_REGISTRY = {
    "crt-mattias.glsl": _mattias_kernel,
}


def find_kernel(shader_path: str):
    """Hand kernel for a pass, or None (``RCTPU_KERNELS=off``, or no
    entry for the shader's basename)."""
    if os.environ.get("RCTPU_KERNELS", "on") == "off":
        return None
    return _REGISTRY.get(Path(shader_path).name)
