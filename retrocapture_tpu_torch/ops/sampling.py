"""GL-faithful texture sampling in torch.

Implements the sampling semantics the reference gets from the GL driver
(per-pass ``filter_linear#`` / ``wrap_mode#`` applied in
ShaderEngine::renderMultipassPass, ShaderEngine.cpp:1004-1036):

* texel centers at ``(i + 0.5) / N`` (GL convention);
* NEAREST: texel ``floor(u * N)``; LINEAR: taps at ``u*N - 0.5`` with
  fractional lerp weights;
* wrap modes clamp_to_edge / repeat / mirrored_repeat applied per tap,
  clamp_to_border masking taps outside [0,N) to the GL default border
  color (0,0,0,0).

Textures are ``[H, W, C]`` float32 tensors in texture space: row 0 is
``v = 0``. Coordinates are numpy arrays (compile-time concrete) or
tensors on the texture's device.

Lowerings, as in the JAX package: separable grids with an integer or
rational texel progression take per-axis index selects with tiny weight
vectors (``_nearest_stride_slice``, ``_separable_slices``); other
separable grids take two f32 resampling matmuls; warped grids take the
gather below on the CPU and the hand-written warp kernel
(``ops/cuda/warp_sample``) on a CUDA tensor. Every index is wrapped or
clipped into range before it reaches a gather.

``mipmap_input`` textures sample a 2x2 box pyramid built on the fly:
an affine grid has one level of detail, known on the host, and blends at
most two separable samples (``sample2d_affine_mip``); a warped grid has a
level of detail per pixel and blends one warped sample per pyramid level
(``sample2d_warped_mip``: one warp-kernel launch per level on the card);
``sample2d_lod`` is ``textureLod`` with a constant level. The blends are
contracted (``fma32``) as the reference's jitted fusions contract them.
"""

from __future__ import annotations

import numpy as np
import torch

from retrocapture_tpu_torch.ops.cuda import mirrors
from retrocapture_tpu_torch.ops.cuda.fma import fma32, fmaf32
from retrocapture_tpu_torch.policy import ifloor32, upload, walk_program

__all__ = [
    "sample2d",
    "sample2d_affine",
    "sample2d_affine_mip",
    "sample2d_warped_mip",
    "sample2d_lod",
    "sample2d_separable",
    "sample2d_gather",
    "sample2d_requant",
    "WRAP_MODES",
]

WRAP_MODES = ("clamp_to_edge", "clamp_to_border", "repeat", "mirrored_repeat")


def _wrap_index(idx, n: int, mode: str):
    """Wrap integer texel indices into [0, n). Returns (indices, valid)
    where valid is None unless mode == clamp_to_border."""
    if mode == "clamp_to_edge":
        return torch.clamp(idx, 0, n - 1), None
    if mode == "repeat":
        return torch.remainder(idx, n), None
    if mode == "mirrored_repeat":
        # GL MIRRORED_REPEAT: period 2n, reflect the second half.
        m = torch.remainder(idx, 2 * n)
        return torch.where(m < n, m, 2 * n - 1 - m), None
    if mode == "clamp_to_border":
        valid = (idx >= 0) & (idx < n)
        return torch.clamp(idx, 0, n - 1), valid
    raise ValueError(f"unknown wrap mode {mode!r}")


def _gather(tex, iy, ix, valid_y, valid_x):
    """tex: [H, W, C]; iy/ix: wrapped int index tensors of identical
    shape S. Returns [*S, C]."""
    h, w, c = tex.shape
    flat = tex.reshape(h * w, c)
    lin = (iy * w + ix).to(torch.int64)
    out = flat.index_select(0, lin.reshape(-1)).reshape(tuple(lin.shape) + (c,))
    if valid_y is not None or valid_x is not None:
        valid = None
        for v in (valid_y, valid_x):
            if v is not None:
                valid = v if valid is None else (valid & v)
        # GL border color default is (0,0,0,0).
        out = torch.where(valid[..., None], out, torch.zeros((), dtype=tex.dtype, device=tex.device))
    return out


def _wrap_index_np(idx: np.ndarray, n: int, mode: str):
    if mode == "clamp_to_edge":
        return np.clip(idx, 0, n - 1), None
    if mode == "repeat":
        return np.remainder(idx, n), None
    if mode == "mirrored_repeat":
        m = np.remainder(idx, 2 * n)
        return np.where(m < n, m, 2 * n - 1 - m), None
    if mode == "clamp_to_border":
        valid = (idx >= 0) & (idx < n)
        return np.clip(idx, 0, n - 1), valid
    raise ValueError(mode)


def _axis_matrix(coord: np.ndarray, n: int, filter_linear: bool, wrap: str) -> np.ndarray:
    """Build the [n_out, n] resampling matrix for one axis: one-hot rows
    for NEAREST, two-hot lerp rows for LINEAR, zero rows for border taps.
    Sampling then becomes a dense matmul — the MXU-native formulation of a
    separable gather."""
    n_out = coord.shape[0]
    a = np.zeros((n_out, n), np.float32)
    rows = np.arange(n_out)
    if not filter_linear:
        idx = np.floor(coord * n).astype(np.int64)
        idx, valid = _wrap_index_np(idx, n, wrap)
        w = np.ones(n_out, np.float32) if valid is None else valid.astype(np.float32)
        np.add.at(a, (rows, idx), w)
        return a
    x = coord * n - 0.5
    x0 = np.floor(x).astype(np.int64)
    fx = (x - x0).astype(np.float32)
    i0, v0 = _wrap_index_np(x0, n, wrap)
    i1, v1 = _wrap_index_np(x0 + 1, n, wrap)
    w0 = 1.0 - fx
    w1 = fx
    if v0 is not None:
        w0 = w0 * v0
    if v1 is not None:
        w1 = w1 * v1
    np.add.at(a, (rows, i0), w0)
    np.add.at(a, (rows, i1), w1)
    return a


def separable_rows(u: np.ndarray, v: np.ndarray):
    """``_separable_rows``, kept in the tables of the program whose walk
    runs under the call's place in the walk (``WalkProgram.site``): in such
    a walk a concrete grid derives from the program's key alone."""
    wp = walk_program()
    if wp is None:
        return _separable_rows(u, v)
    key = ("separable_rows", wp.site("separable_rows"), u.shape, v.shape)
    if key not in wp.tables:
        wp.tables[key] = _separable_rows(u, v)
    return wp.tables[key]


def _separable_rows(u: np.ndarray, v: np.ndarray):
    """If u varies only along columns and v only along rows of a 2D grid,
    return (u_row, v_col); else None."""
    if u.ndim != 2 or v.ndim != 2 or u.shape != v.shape:
        return None
    if not np.all(u == u[:1, :]):
        return None
    if not np.all(v == v[:, :1]):
        return None
    return u[0, :], v[:, 0]


def _axis_stride(coord_f32: np.ndarray, n: int):
    """(idx0, stride) when the pre-wrap NEAREST indices for one axis
    advance with an exact constant integer stride >= 1, else None.
    Mirrors _axis_matrix exactly: indices are floor(coord * n) in
    float32 arithmetic."""
    idx = np.floor(coord_f32 * np.float32(n)).astype(np.int64)
    if idx.shape[0] <= 1:
        return (int(idx[0]), 1) if idx.shape[0] else (0, 1)
    d = np.diff(idx)
    s = int(d[0])
    if s < 1 or s > 64 or not np.all(d == s):
        return None
    return int(idx[0]), s


def _rational_pattern(idx: np.ndarray, max_den: int = 1):
    """Small integers (a, b, c) and per-element deltas in {0, 1} with
    ``idx[j] == (a*j + c) // b + delta[j]`` for every j, or None, up to
    the sparse ±1 flips float32 coordinate rounding introduces at texel
    boundaries. Only integer-stride progressions (b == 1) are used, as
    in the JAX package."""
    m = idx.shape[0]
    if m < 2:
        return None
    j = np.arange(m, dtype=np.int64)
    span = float(idx[-1] - idx[0])
    for b in range(1, max_den + 1):
        a = int(round(span * b / (m - 1)))
        if a < 1:
            continue
        t = b * idx - a * j
        span_t = int(t.max()) - int(t.min())
        if span_t <= b - 1:
            c = int(t.max())
            return a, b, c, np.zeros(m, np.int64)
        if span_t <= 2 * b - 1:
            c = int(t.max()) - b
            delta = idx - (a * j + c) // b
            return a, b, c, delta
    return None


def _axis_take(tex, idx: np.ndarray, axis: int, wrap: str):
    """``out[..., j, ...] = ext(tex)[idx[j]]`` along ``axis``, where ext
    extends the texture beyond [0, n) by the wrap mode exactly as the
    JAX package's pad modes do (edge / wrap / symmetric / zero). The
    indices are wrapped on the host, so the device select never sees an
    out-of-range index."""
    n = tex.shape[axis]
    wi, valid = _wrap_index_np(np.asarray(idx, np.int64), n, wrap)
    out = tex.index_select(axis, upload(torch.from_numpy(wi.astype(np.int64)), tex.device))
    if valid is not None and not valid.all():
        shape = [1] * tex.dim()
        shape[axis] = len(wi)
        mk = upload(torch.from_numpy(valid.reshape(shape)), tex.device)
        out = torch.where(mk, out, torch.zeros((), dtype=tex.dtype, device=tex.device))
    return out


def _axis_slice_plan(coord_f32: np.ndarray, n: int, filter_linear: bool, wrap: str):
    """Per-axis tap plan: a list of ``(pattern, weight_or_None)`` taps, or
    None when the index progression has no integer-stride pattern.
    Index/weight math mirrors _axis_matrix bit-for-bit (same float32
    ops), so results are exact."""
    m = coord_f32.shape[0]
    if m < 2:
        return None
    if not filter_linear:
        idx = np.floor(coord_f32 * np.float32(n)).astype(np.int64)
        pat = _rational_pattern(idx)
        if pat is None:
            return None
        a, b, c, delta = pat
        if not delta.any():
            return [((a, b, c), None)]
        m0 = (delta == 0).astype(np.float32)
        return [((a, b, c), m0), ((a, b, c + b), np.float32(1.0) - m0)]
    x = coord_f32 * np.float32(n) - np.float32(0.5)
    x0 = np.floor(x).astype(np.int64)
    fx = (x - x0).astype(np.float32)
    pat = _rational_pattern(x0)
    if pat is None:
        return None
    a, b, c, delta = pat
    w0 = np.float32(1.0) - fx
    # Tap pair (x0, x0+1) relative to base+delta: combine the shared
    # delta masks into per-offset weight vectors (<=3 takes).
    m0 = (delta == 0).astype(np.float32)
    m1 = np.float32(1.0) - m0
    cand = [
        (c, w0 * m0),
        (c + b, w0 * m1 + fx * m0),
        (c + 2 * b, fx * m1),
    ]
    taps = [((a, b, cc), wv) for cc, wv in cand if np.any(wv != 0.0)]
    if not taps:
        taps = [((a, b, c), w0)]
    return taps


def _pattern_index(pat, m: int) -> np.ndarray:
    a, b, c = pat
    return (a * np.arange(m, dtype=np.int64) + c) // b


def _slice_axis_take(src, taps, m, axis, filter_linear, wrap):
    """Apply a _axis_slice_plan tap list along ``axis``: one index select
    per tap, weighted and summed in the JAX package's order."""
    shape = [1] * src.dim()
    shape[axis] = m
    # NEAREST delta pair: a pure row select (0/1 complementary masks) —
    # where-select rather than 0*NaN-hazardous weighting.
    if not filter_linear and len(taps) == 2 and taps[0][1] is not None:
        (p0, w0), (p1, _) = taps
        t0 = _axis_take(src, _pattern_index(p0, m), axis, wrap)
        t1 = _axis_take(src, _pattern_index(p1, m), axis, wrap)
        mk = upload(torch.from_numpy(np.asarray(w0 == 1.0).reshape(shape)), src.device)
        return torch.where(mk, t0, t1)
    taken = []
    for pat, wv in taps:
        t = _axis_take(src, _pattern_index(pat, m), axis, wrap)
        taken.append((t, None if wv is None else upload(np.asarray(wv, np.float32).reshape(shape), src.device)))
    if len(taken) == 1:
        t, wt = taken[0]
        return t if wt is None else t * wt
    # Weighted LINEAR taps, summed as the reference's jitted fusion
    # computes them: XLA's CPU code generator contracts the first add's
    # left product and rounds its right one, then contracts each further
    # product into the running sum (frontend/builtins._contract).
    (t0, w0), (t1, w1) = taken[:2]
    acc = fma32(t0, w0, t1 * w1)
    for t, wt in taken[2:]:
        acc = fma32(t, wt, acc)
    return acc


def _separable_slices(tex, u_row: np.ndarray, v_col: np.ndarray, filter_linear: bool, wrap_mode: str):
    """Separable sample via per-axis index selects + 1D weight vectors —
    the matmul-free lowering for affine taps with integer-stride texel
    progressions (NEAREST and LINEAR). Exact float32. Returns
    [oh, ow, C] or None when not applicable."""
    h, w, _ = tex.shape
    xplan = _axis_slice_plan(u_row, w, filter_linear, wrap_mode)
    if xplan is None:
        return None
    yplan = _axis_slice_plan(v_col, h, filter_linear, wrap_mode)
    if yplan is None:
        return None
    ow, oh = u_row.shape[0], v_col.shape[0]
    rows = _slice_axis_take(tex, yplan, oh, 0, filter_linear, wrap_mode)
    return _slice_axis_take(rows, xplan, ow, 1, filter_linear, wrap_mode)


def _nearest_stride_slice(tex, u_row, v_col, wrap_mode: str):
    """NEAREST separable tap whose per-axis texel indices advance with a
    constant integer stride (identity taps, integer-offset FIR taps,
    integer decimation): two index selects instead of one-hot resampling
    matmuls."""
    h, w, _ = tex.shape
    rx = _axis_stride(u_row, w)
    ry = _axis_stride(v_col, h)
    if rx is None or ry is None:
        return None
    x0, sx = rx
    y0, sy = ry
    ow, oh = u_row.shape[0], v_col.shape[0]
    x1 = x0 + sx * (ow - 1)
    y1 = y0 + sy * (oh - 1)
    pad_lo = (max(0, -y0), max(0, -x0))
    pad_hi = (max(0, y1 - (h - 1)), max(0, x1 - (w - 1)))
    if max(pad_lo) > 4 * h + 64 or max(pad_hi) > 4 * w + 64:
        return None  # degenerate maps: the matrix path, as in the reference
    if wrap_mode not in WRAP_MODES:
        wrap_mode = "clamp_to_edge"
    iy = y0 + sy * np.arange(oh, dtype=np.int64)
    ix = x0 + sx * np.arange(ow, dtype=np.int64)
    if y0 == 0 and sy == 1 and oh == h and x0 == 0 and sx == 1 and ow == w:
        return tex  # identity tap
    return _axis_take(_axis_take(tex, iy, 0, wrap_mode), ix, 1, wrap_mode)


def _axis_is_identity(coord_f32: np.ndarray, n: int, filter_linear: bool, wrap: str) -> bool:
    """True when this axis's resampling matrix would be the exact [n, n]
    identity (same size, texel-centered coords): NEAREST hits texel j
    with weight 1, LINEAR's lerp fraction is exactly 0 on texel centers.
    Mirrors _axis_matrix's float32 index math bit-for-bit."""
    m = coord_f32.shape[0]
    if m != n or wrap == "clamp_to_border":
        return False
    if filter_linear:
        x = coord_f32 * np.float32(n) - np.float32(0.5)
        x0 = np.floor(x)
        return bool(np.all(x == x0) and np.array_equal(x0, np.arange(n)))
    idx = np.floor(coord_f32 * np.float32(n))
    return bool(np.array_equal(idx, np.arange(n)))


def _axis_matrix_traced(coord, n: int, filter_linear: bool, wrap: str):
    """[m, n] resampling matrix for one axis from a coordinate tensor:
    one-hot rows (NEAREST) or two-hot lerp rows (LINEAR), border taps
    zeroed."""
    # Masks select (torch.where) rather than multiply: the reference's
    # "weight * mask" products are rewritten by XLA into selects, so a
    # NaN weight (a NaN or infinite coordinate) lands only on its own
    # tap column, and a border tap contributes an exact 0.
    coord = coord.to(torch.float32)
    iw = torch.arange(n, dtype=torch.int32, device=coord.device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=coord.device)
    if not filter_linear:
        idx = ifloor32(coord * n)
        idx, valid = _wrap_index(idx, n, wrap)
        hit = iw == idx[:, None]
        if valid is not None:
            hit = hit & valid[:, None]
        return hit.to(torch.float32)
    x = fma32(coord, n, -0.5)
    x0f = torch.floor(x)
    fx = x - x0f
    x0 = ifloor32(x)
    i0, v0 = _wrap_index(x0, n, wrap)
    i1, v1 = _wrap_index(x0 + 1, n, wrap)
    w0 = 1.0 - fx
    w1 = fx
    if v0 is not None:
        w0 = torch.where(v0, w0, zero)
    if v1 is not None:
        w1 = torch.where(v1, w1, zero)
    return torch.where(iw == i0[:, None], w0[:, None], zero) + torch.where(
        iw == i1[:, None], w1[:, None], zero
    )


def _axis_matrix_device(coord_np, n: int, filter_linear: bool, wrap: str, device):
    """The axis matrix built on ``device`` from a small concrete
    coordinate vector (bit-identical to the numpy ``_axis_matrix``)."""
    return _axis_matrix_traced(upload(np.asarray(coord_np, np.float32), device), n, filter_linear, wrap)


def sample2d_affine(
    tex,
    u_aff: tuple,
    v_aff: tuple,
    oh: int,
    ow: int,
    *,
    filter_linear: bool,
    wrap_mode: str = "clamp_to_edge",
):
    """Sample ``tex [H, W, C]`` over an output grid whose coordinates are
    affine in the pixel indices: ``u = u_aff[0]*X + u_aff[2]`` (column X),
    ``v = v_aff[1]*Y + v_aff[2]`` (row Y). Separable by construction.
    Returns ``[oh, ow, C]``."""
    if wrap_mode not in WRAP_MODES:
        wrap_mode = "clamp_to_edge"
    h, w, _ = tex.shape
    u_row = (
        np.float64(u_aff[0]) * np.arange(ow, dtype=np.float64) + np.float64(u_aff[2])
    ).astype(np.float32)
    v_col = (
        np.float64(v_aff[1]) * np.arange(oh, dtype=np.float64) + np.float64(v_aff[2])
    ).astype(np.float32)
    if not filter_linear:
        out = _nearest_stride_slice(tex, u_row, v_col, wrap_mode)
        if out is not None:
            return out
    out = _separable_slices(tex, u_row, v_col, filter_linear, wrap_mode)
    if out is not None:
        return out.to(tex.dtype)
    # Identity axes skip their matmul entirely.
    out = tex
    if not _axis_is_identity(v_col, h, filter_linear, wrap_mode):
        ay = _axis_matrix_device(v_col, h, filter_linear, wrap_mode, tex.device)
        out = torch.einsum("hs,swc->hwc", ay, out)
    if not _axis_is_identity(u_row, w, filter_linear, wrap_mode):
        ax = _axis_matrix_device(u_row, w, filter_linear, wrap_mode, tex.device)
        out = torch.einsum("ws,hsc->hwc", ax, out)
    return out.to(tex.dtype)


def sample2d_separable(
    tex,
    u_row,
    v_col,
    *,
    filter_linear: bool,
    wrap_mode: str = "clamp_to_edge",
):
    """Sample ``tex [H, W, C]`` over a separable output grid given as
    per-axis coordinate vectors ``u_row [ow]`` / ``v_col [oh]`` (tensors
    or numpy). Two f32 resampling matmuls; all four wrap modes are exact
    (a mirrored/repeat boundary where both taps wrap to the same texel
    sums the lerp weights, which is what GL samples too)."""
    if wrap_mode not in WRAP_MODES:
        wrap_mode = "clamp_to_edge"
    h, w, _ = tex.shape
    if isinstance(u_row, np.ndarray) and isinstance(v_col, np.ndarray):
        out = _separable_slices(
            tex,
            np.asarray(u_row, np.float32),
            np.asarray(v_col, np.float32),
            filter_linear,
            wrap_mode,
        )
        if out is not None:
            return out.to(tex.dtype)
    ax = _axis_matrix_traced(upload(u_row, tex.device), w, filter_linear, wrap_mode)
    ay = _axis_matrix_traced(upload(v_col, tex.device), h, filter_linear, wrap_mode)
    th = torch.einsum("hs,swc->hwc", ay, tex)
    return torch.einsum("ws,hsc->hwc", ax, th).to(tex.dtype)


def sample2d_gather(tex, u, v, *, filter_linear: bool, wrap_mode: str = "clamp_to_edge", fmaf=None):
    """The plain gather form of a warped tap: ``tex [..., H, W, C]``
    sampled at per-pixel normalized ``u, v`` tensors of one shape S →
    ``[..., *S, C]``. This is the plain version of the CUDA warp kernel
    (ops/cuda/warp_sample), with the reference's operation order
    (sampling.py:1200-1233) as its jitted gather rounds it on the CPU:
    the LINEAR tap position ``u*W - 0.5`` and the three lerps are
    fused multiply-adds (``fmaf32``: one rounding, as the kernel's
    ``__fmaf_rn``). ``fmaf`` computes them where given (the warp kernel's
    plain version passes ``policy.fmaf32``); else the ``rctpu::fma``
    operator does."""
    fmaf = fmaf32 if fmaf is None else fmaf
    if tex.dim() == 4:
        return torch.stack(
            [sample2d_gather(t, u, v, filter_linear=filter_linear, wrap_mode=wrap_mode, fmaf=fmaf) for t in tex]
        )
    h, w, _ = tex.shape
    if not filter_linear:
        ix = ifloor32(u * w)
        iy = ifloor32(v * h)
        ix, vx = _wrap_index(ix, w, wrap_mode)
        iy, vy = _wrap_index(iy, h, wrap_mode)
        return _gather(tex, iy, ix, vy, vx)

    x = fmaf(u, w, -0.5)
    y = fmaf(v, h, -0.5)
    fx = (x - torch.floor(x)).to(tex.dtype)
    fy = (y - torch.floor(y)).to(tex.dtype)
    x0 = ifloor32(x)
    y0 = ifloor32(y)

    x0w, vx0 = _wrap_index(x0, w, wrap_mode)
    x1w, vx1 = _wrap_index(x0 + 1, w, wrap_mode)
    y0w, vy0 = _wrap_index(y0, h, wrap_mode)
    y1w, vy1 = _wrap_index(y0 + 1, h, wrap_mode)

    t00 = _gather(tex, y0w, x0w, vy0, vx0)
    t01 = _gather(tex, y0w, x1w, vy0, vx1)
    t10 = _gather(tex, y1w, x0w, vy1, vx0)
    t11 = _gather(tex, y1w, x1w, vy1, vx1)

    fx = fx[..., None]
    fy = fy[..., None]
    top = fmaf(t01 - t00, fx, t00)
    bot = fmaf(t11 - t10, fx, t10)
    return fmaf(bot - top, fy, top)


def _box_downsample(tex):
    """One mip level down: 2x2 box average (glGenerateMipmap's filter),
    truncating odd trailing rows/cols like GL's floor(n/2) level sizing."""
    h, w, _ = tex.shape
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    t = tex[: h2 * 2, : w2 * 2]
    if h >= 2:
        t = (t[0::2] + t[1::2]) * 0.5
    if w >= 2:
        t = (t[:, 0::2] + t[:, 1::2]) * 0.5
    return t


def _max_lod(h: int, w: int) -> int:
    return int(np.floor(np.log2(max(min(h, w), 1))))


def _pyramid(tex, levels: int) -> list:
    """``[tex, level 1, ..., level levels]`` of the box pyramid."""
    out = [tex]
    for _ in range(levels):
        out.append(_box_downsample(out[-1]))
    return out


def sample2d_affine_mip(
    tex,
    u_aff: tuple,
    v_aff: tuple,
    oh: int,
    ow: int,
    *,
    filter_linear: bool,
    wrap_mode: str = "clamp_to_edge",
):
    """GL_LINEAR_MIPMAP_LINEAR sampling for an affine output grid: the
    texel footprint (and therefore the LOD) is a host-side constant, so
    trilinear filtering is at most two separable samples of box-pyramid
    levels blended by the LOD fraction (``mipmap_input#`` passes, e.g.
    crt-hyllian-glow's 0.25x glow blur)."""
    h, w, _ = tex.shape
    # rho: max texels stepped per output pixel (GL LOD rule).
    rho = max(abs(u_aff[0]) * w, abs(v_aff[1]) * h, 1e-12)
    lod = float(np.log2(rho))
    if lod <= 0.0 or not filter_linear:
        return sample2d_affine(
            tex, u_aff, v_aff, oh, ow, filter_linear=filter_linear, wrap_mode=wrap_mode
        )
    max_lod = _max_lod(h, w)
    l0 = min(int(np.floor(lod)), max_lod)
    l1 = min(l0 + 1, max_lod)
    frac = min(max(lod - l0, 0.0), 1.0) if l1 > l0 else 0.0
    levels = _pyramid(tex, l1)
    s0 = sample2d_affine(
        levels[l0], u_aff, v_aff, oh, ow, filter_linear=True, wrap_mode=wrap_mode
    )
    if frac == 0.0:
        return s0
    s1 = sample2d_affine(
        levels[l1], u_aff, v_aff, oh, ow, filter_linear=True, wrap_mode=wrap_mode
    )
    return fma32(s1 - s0, frac, s0)


def sample2d_warped_mip(
    tex,
    u,
    v,
    *,
    filter_linear: bool,
    wrap_mode: str = "clamp_to_edge",
):
    """Mipmapped sampling for WARPED 2D grids (``mipmap_input#`` passes
    whose taps are data-dependent — the case the reference's GL stack
    handles in hardware, ShaderEngine.cpp:1004-1036): per-pixel LOD from
    screen-space finite differences (the quad-derivative analog), then
    per-pixel trilinear across the box pyramid. Every reachable level is
    sampled with the warped sampler (the warp kernel on the card, one
    launch per level) and blended by its per-pixel weight."""
    h, w, _ = tex.shape
    u = upload(u, tex.device).to(torch.float32)
    v = upload(v, tex.device).to(torch.float32)

    def ddiff(a, axis):
        d = torch.diff(a, dim=axis)
        last = d.narrow(axis, d.shape[axis] - 1, 1)
        return torch.cat([d, last], dim=axis)

    dx = torch.maximum(torch.abs(ddiff(u, 1)) * w, torch.abs(ddiff(v, 1)) * h)
    dy = torch.maximum(torch.abs(ddiff(u, 0)) * w, torch.abs(ddiff(v, 0)) * h)
    floor_rho = torch.full((), 1e-12, dtype=torch.float32, device=tex.device)
    rho = torch.maximum(torch.maximum(dx, dy), floor_rho)
    max_lod = _max_lod(h, w)
    lod = torch.clamp(mirrors.log2f32(rho), 0.0, float(max_lod))
    if not filter_linear:
        lod = torch.zeros_like(lod)  # NEAREST min filter: base level
    l0 = torch.floor(lod)
    frac = lod - l0

    level = tex
    out = None
    first = None  # level 0's (sample, weight): contracted into level 1's add
    for lev in range(max_lod + 1):
        wt = torch.where(l0 == lev, 1.0 - frac, 0.0) + torch.where(l0 == lev - 1, frac, 0.0)
        s = sample2d(level, u, v, filter_linear=filter_linear, wrap_mode=wrap_mode)
        wt = wt[..., None]
        if lev == 0:
            first = (s, wt)
            out = s * wt
        elif lev == 1:
            out = fma32(first[0], first[1], s * wt)
        else:
            out = fma32(s, wt, out)
        if lev < max_lod:
            level = _box_downsample(level)
    return out


def sample2d_lod(
    tex,
    u,
    v,
    lod: float,
    *,
    filter_linear: bool,
    wrap_mode: str = "clamp_to_edge",
):
    """Explicit-LOD sampling (textureLod with a constant LOD) over a box
    pyramid: trilinear between the two adjacent levels."""
    h, w, _ = tex.shape
    max_lod = _max_lod(h, w)
    lod = min(max(lod, 0.0), float(max_lod))
    l0 = int(np.floor(lod))
    l1 = min(l0 + 1, max_lod)
    frac = lod - l0 if l1 > l0 else 0.0
    levels = _pyramid(tex, l1)
    s0 = sample2d(levels[l0], u, v, filter_linear=filter_linear, wrap_mode=wrap_mode)
    if frac == 0.0:
        return s0
    s1 = sample2d(levels[l1], u, v, filter_linear=filter_linear, wrap_mode=wrap_mode)
    return fma32(s1 - s0, frac, s0)


def sample2d(
    tex,
    u,
    v,
    *,
    filter_linear: bool,
    wrap_mode: str = "clamp_to_edge",
):
    """Sample ``tex [H, W, C]`` at normalized coords ``u, v`` (any common
    shape S; numpy or tensors) with GL semantics. Returns ``[*S, C]`` in
    ``tex.dtype``.

    Concrete separable grids (u a function of the column, v of the row —
    every non-warping shader and all scale/blit resampling) lower to
    per-axis selects or two matmuls. Warped 2-D grids on a CUDA texture
    go to the warp kernel; on the CPU they take the plain gather."""
    return sample2d_requant(tex, u, v, filter_linear=filter_linear, wrap_mode=wrap_mode)[0]


def sample2d_requant(tex, u, v, *, filter_linear: bool, wrap_mode: str = "clamp_to_edge"):
    """``(sample2d(...), requant)``: ``requant`` is True where the
    reference re-materialises a sample of an RGBA8-quantized texture
    through uint8 (its ``sampling._requant_u8``): a NEAREST tap of a
    concrete separable grid that takes the one-hot matmuls. The values
    are the same; what differs is the HLO the reference's shader
    arithmetic meets (frontend/interp.py)."""
    if wrap_mode not in WRAP_MODES:
        wrap_mode = "clamp_to_edge"
    h, w, _ = tex.shape
    if isinstance(u, np.ndarray) and isinstance(v, np.ndarray):
        sep = separable_rows(np.asarray(u, np.float32), np.asarray(v, np.float32))
        if sep is not None:
            u_row, v_col = sep
            if not filter_linear:
                out = _nearest_stride_slice(tex, u_row, v_col, wrap_mode)
                if out is not None:
                    return out, False
            out = _separable_slices(tex, u_row, v_col, filter_linear, wrap_mode)
            if out is not None:
                return out.to(tex.dtype), False
            ax = _axis_matrix_device(u_row, w, filter_linear, wrap_mode, tex.device)
            ay = _axis_matrix_device(v_col, h, filter_linear, wrap_mode, tex.device)
            th = torch.einsum("hs,swc->hwc", ay, tex)
            return torch.einsum("ws,hsc->hwc", ax, th).to(tex.dtype), not filter_linear

    u = upload(u, tex.device).to(torch.float32)
    v = upload(v, tex.device).to(torch.float32)
    if u.dim() == 2 and u.shape == v.shape:
        # A warped grid: the warp kernel's wrapper (its plain gather on
        # the CPU).
        from retrocapture_tpu_torch.ops.cuda.warp_sample import warp_sample

        return warp_sample(tex, u, v, filter_linear=filter_linear, wrap_mode=wrap_mode), False
    return sample2d_gather(tex, u, v, filter_linear=filter_linear, wrap_mode=wrap_mode), False
