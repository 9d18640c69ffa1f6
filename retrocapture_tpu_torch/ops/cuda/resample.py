"""Fused viewport blit + uint8 pack: the CUDA kernel and its plain version.

Replaces ``retrocapture_tpu/ops/pallas/resample.py:resample_u8`` (reached
through ``blit_u8``). The reference computes the blit as two dense f32
matmuls, y first, then the quantize:

    out[y, x, c] = u8(rint(clip(sum_s sum_t ay[y,s] tex[s,t,c] ax[x,t], 0, 1) * 255))

Each row of ``ay`` / ``ax`` (LINEAR, clamp_to_edge) has at most two
nonzero weights. The CUDA kernel (``csrc/resample_u8.cu``) takes those
two (index, weight) pairs per row, read on the host from the very
matrix the reference builds (``sampling._axis_matrix``), and sums y first
and x second. It is bound by the bytes it moves; see the source note. The
wrapper cuts the output columns into segments and tells the kernel which
source columns each segment reads (``_seg_plan``); a segment whose source
range does not fit shared memory is computed from global memory in the
same kernel and counted in ``general_blocks()``.

``resample_u8`` launches the kernel for a CUDA tensor and takes the
plain version (two einsums and the quantize, the reference's
``_einsum_fallback``) only for a CPU tensor. ``LAUNCHES`` counts kernel
launches.

``blit_u8`` keeps what it derives from a geometry ``(h, w, vw, vh)`` on
a device (the axis matrices, the tap tables and segment plan on the device,
the xphase plan and its tables) in a small bounded cache, so a blit of a
known geometry uploads nothing; ``clear_blit_cache()`` empties it.

``resample_u8_xphase`` replaces
``retrocapture_tpu/ops/pallas/resample.py:_resample_u8_xphase``, the
phase form of the same blit for an integer x-upscale (``_xphase_plan``,
copied). ``blit_u8`` takes it under ``RCTPU_XPHASE=on``, as the
reference does. Its kernel (``csrc/resample_xphase.cu``) computes the
bytes of ``resample_u8``'s kernel; its plain version runs the same 2-tap
sums in torch. ``XPHASE_LAUNCHES`` counts its launches.
"""

from __future__ import annotations

import os
from collections import OrderedDict, namedtuple

import numpy as np
import torch

from retrocapture_tpu_torch.ops.sampling import _axis_is_identity, _axis_matrix
from retrocapture_tpu_torch.policy import to_device

__all__ = [
    "resample_u8",
    "resample_u8_plain",
    "resample_u8_xphase",
    "resample_u8_xphase_plain",
    "blit_u8",
    "blit_matrices",
    "axis_taps",
    "general_blocks",
    "clear_blit_cache",
    "LAUNCHES",
    "XPHASE_LAUNCHES",
]

LAUNCHES = 0
XPHASE_LAUNCHES = 0
_GENERAL_BLOCKS = 0

# The kernel's geometry (csrc/resample_u8.cu): a warp owns a segment of at
# most 32 lanes x 8 pixels and a band of rows; the shared memory of a
# block's 8 warps (each: two source rows of the segment's source range,
# the y-pass row, the staged bytes) stays under the budget so that two
# blocks share an SM. A texel of 3 channels takes 4 floats there.
_WARPS = 8
_SEG_MAX = 256
_SEG_WIDTHS = (256, 128, 64, 32, 16, 8, 4)
_SHARED_BUDGET = 110 * 1024
_PADDED = {1: 1, 2: 2, 3: 4, 4: 4}
_BAND = 32  # output rows per warp (at most 32); halved while the grid is small
_MIN_BLOCKS = 1056  # 132 SMs x 8

_BLIT_CACHE_MAX = 16


def axis_taps(a: np.ndarray):
    """The two nonzero (index, weight) pairs of each row of an axis
    matrix ``a [m, n]`` (at most two per row for LINEAR clamp_to_edge):
    ``(i0, w0, i1, w1)``, each of length m. A row with one nonzero (both
    taps clamped onto one texel, whose weights the matrix summed) gets
    ``(i, w, i, 0)``; an all-zero row gets zero weights."""
    a = np.asarray(a, np.float32)
    nz = a != 0.0
    if (nz.sum(axis=1) > 2).any():
        raise ValueError("axis matrix has a row with more than two taps")
    m, n = a.shape
    rows = np.arange(m)
    has = nz.any(axis=1)
    i0 = np.where(has, nz.argmax(axis=1), 0)
    i1 = np.where(has, n - 1 - nz[:, ::-1].argmax(axis=1), 0)
    w0 = a[rows, i0]
    w1 = np.where(i1 != i0, a[rows, i1], np.float32(0.0)).astype(np.float32)
    return i0.astype(np.int32), w0.astype(np.float32), i1.astype(np.int32), w1


def _quantize_u8(x):
    q = torch.round(torch.clamp(x, 0.0, 1.0) * 255.0)
    # NaN stores 0 (jnp's NaN -> uint8 convert); a NaN cast is undefined.
    return torch.where(torch.isnan(q), 0.0, q).to(torch.uint8)


def resample_u8_plain(tex, ay, ax):
    """Plain torch version: ``tex [..., H, W, C]`` f32, ``ay [OH, H]`` and
    ``ax [OW, W]`` f32 tensors or None (identity) → u8 ``[..., OH, OW, C]``.
    Two f32 einsums, y then x, then the quantize."""
    if ay is not None:
        tex = torch.einsum("os,...shc->...ohc", ay, tex)
    if ax is not None:
        tex = torch.einsum("pt,...otc->...opc", ax, tex)
    return _quantize_u8(tex)


def general_blocks(reset: bool = False) -> int:
    """The units of work (one warp each: one frame, one band of rows, one
    segment of columns) that the blit kernel has computed from global
    memory since the last reset: segments whose source range does not fit
    the shared-memory budget. ``reset`` zeroes the count."""
    global _GENERAL_BLOCKS
    n = _GENERAL_BLOCKS
    if reset:
        _GENERAL_BLOCKS = 0
    return n


def _seg_plan(xtaps, ow: int, c: int, has_y: bool):
    """Cut ``ow`` output columns into segments for the kernel: ``(seg_px,
    seg_lo [segs], seg_n [segs], cap)``. ``seg_lo`` / ``seg_n`` are the
    first source column and the number of source columns each segment's
    x taps read (``xtaps`` = ``axis_taps`` of the x matrix; None: the x
    axis is the identity and a segment reads its own columns). The widest
    segment whose shared memory stays in the budget is taken; at the
    narrowest width a segment that still exceeds it gets ``n = 0``
    (computed from global memory). ``cap``: the largest ``n`` times the
    floats a texel takes in shared memory, a multiple of 4."""
    if ow == 0:
        return _SEG_MAX, np.zeros(0, np.int32), np.zeros(0, np.int32), 0
    rows = 3 if has_y else 2
    cp = _PADDED[c]
    budget = _SHARED_BUDGET // _WARPS - (_SEG_MAX * c + 16)
    for seg_px in _SEG_WIDTHS:
        starts = np.arange(0, ow, seg_px)
        if xtaps is None:
            lo = starts
            n = np.minimum(starts + seg_px, ow) - starts
        else:
            i0, _, i1, _ = xtaps
            lo = np.minimum.reduceat(np.minimum(i0, i1), starts)
            n = np.maximum.reduceat(np.maximum(i0, i1), starts) - lo + 1
        need = rows * 4 * ((n * cp + 3) // 4 * 4)
        if (need <= budget).all():
            break
    n = np.where(need <= budget, n, 0)
    cap = int((n.max() * cp + 3) // 4 * 4)
    return seg_px, lo.astype(np.int32), n.astype(np.int32), cap


# What a launch needs beside the texture: the axes' tap tables and the
# segment plan on the device (None tables: identity axis).
_Dense = namedtuple("_Dense", "ytaps xtaps seg_lo seg_n seg_px cap general_segs oh ow")


def _dense_tables(ay, ax, h: int, w: int, c: int, dev, ytaps=None) -> _Dense:
    for a, n_in in ((ay, h), (ax, w)):
        if a is not None and a.shape[1] != n_in:
            raise ValueError(f"resample_u8: axis matrix {a.shape} does not match {n_in}")
    if not 1 <= c <= 4:
        raise ValueError(f"resample_u8: the kernel takes 1 to 4 channels, got {c}")
    oh = h if ay is None else ay.shape[0]
    ow = w if ax is None else ax.shape[0]
    xt = None if ax is None else axis_taps(ax)
    yt = None if ay is None else axis_taps(ay)
    if ytaps is None and yt is not None:
        ytaps = tuple(to_device(t, dev) for t in yt)
    seg_px, lo, n, cap = _seg_plan(xt, ow, c, ay is not None)
    if yt is not None:
        # The kernel keeps source row r in slot r & 1: a row whose two taps
        # would share a slot (no blit matrix has one) sends the launch to
        # the general path.
        apart = yt[2] - yt[0]
        if ((apart != 0) & (apart % 2 == 0)).any():
            n = np.zeros_like(n)
            cap = 0
    return _Dense(
        ytaps, None if xt is None else tuple(to_device(t, dev) for t in xt),
        to_device(lo, dev), to_device(n, dev), seg_px, cap, int((n == 0).sum()), oh, ow,
    )


def _batch4(tex, name: str):
    """``tex`` as a contiguous f32 [B, H, W, C] and whether it was [H, W, C]."""
    if tex.dtype != torch.float32:
        raise TypeError(f"{name}: tex must be float32, got {tex.dtype}")
    squeeze = tex.dim() == 3
    t4 = tex[None] if squeeze else tex
    if t4.dim() != 4:
        raise ValueError(f"{name}: tex must be [H,W,C] or [B,H,W,C], got {tuple(tex.shape)}")
    return t4.contiguous(), squeeze


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(t4, dense: _Dense):
    from retrocapture_tpu_torch.ops.cuda._build import load

    global LAUNCHES, _GENERAL_BLOCKS
    b, h, w, c = t4.shape
    dev = t4.device
    oh, ow = dense.oh, dense.ow
    out = torch.empty((b, oh, ow, c), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    segs = dense.seg_lo.shape[0]
    band = _BAND
    while band > 6 and segs * -(-oh // band) * b < _MIN_BLOCKS * _WARPS:
        band //= 2
    rc = load("resample_u8")(
        t4.data_ptr(), out.data_ptr(),
        *(_ptr(t) for t in dense.ytaps or (None,) * 4),
        *(_ptr(t) for t in dense.xtaps or (None,) * 4),
        dense.seg_lo.data_ptr(), dense.seg_n.data_ptr(),
        b, h, w, c, oh, ow, dense.seg_px, band, dense.cap,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"resample_u8 kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    _GENERAL_BLOCKS += dense.general_segs * -(-oh // band) * b
    return out


def resample_u8(tex, ay, ax):
    """``tex [H, W, C]`` or ``[B, H, W, C]`` f32; ``ay [OH, H]`` /
    ``ax [OW, W]`` numpy axis matrices or None (identity axis, skipped)
    → u8 ``[..., OH, OW, C]``. A CUDA tensor launches the kernel (1 to 4
    channels); a CPU tensor takes the plain version. The caller's matrices
    are read anew on every call; ``blit_u8`` caches its own."""
    if tex.is_cuda:
        t4, squeeze = _batch4(tex, "resample_u8")
        _, h, w, c = t4.shape
        out = _launch(t4, _dense_tables(ay, ax, h, w, c, t4.device))
        return out[0] if squeeze else out
    if tex.device.type != "cpu":
        raise RuntimeError(f"resample_u8: no kernel for device {tex.device}")
    dev = tex.device
    return resample_u8_plain(
        tex,
        None if ay is None else to_device(ay, dev),
        None if ax is None else to_device(ax, dev),
    )


def _xphase_plan(ax_np: np.ndarray, w: int, ow: int):
    """Detect the integer-upscale phase structure of a LINEAR x-axis
    resampling matrix: ow == r*w and every output column X = r*k + p
    reads source texels {k + d_p, k + d_p + 1} (post-clamp). Returns
    (r, d [r] of {-1, 0}, w0 [r, w], w1 [r, w]) with the matrix's OWN
    per-column weights (they wobble in the last ulps across k from the
    f32 u-coordinate rounding, so they ride as vectors, not scalars),
    or None when the structure doesn't hold.

    The final 1080p blit is the bandwidth/FLOP-dominant tensor of most
    chains, and its dense [w, ow] matmul costs inner-dim*ow MXU work
    for what is a 2-tap FMA per output pixel: the phase form cuts the
    x-resample from ~9 GFLOP/frame (640->1920, 3ch) to ~0.05."""
    if w < 2 or ow % w != 0:
        return None
    r = ow // w
    if r < 2:
        return None
    d = []
    w0 = np.zeros((r, w), np.float32)
    w1 = np.zeros((r, w), np.float32)
    for p in range(r):
        rows = ax_np[p::r]  # [w, w]
        # Phase tap offset from an interior row.
        ki = min(max(2, w // 2), w - 2)
        nz = np.nonzero(rows[ki])[0]
        if len(nz) == 0 or len(nz) > 2:
            return None
        dp = int(nz[0] - ki)
        if dp not in (-1, 0):
            return None
        d.append(dp)
        for k in range(w):
            j0 = min(max(k + dp, 0), w - 1)
            j1 = min(max(k + dp + 1, 0), w - 1)
            nzk = np.nonzero(rows[k])[0]
            if not set(nzk.tolist()) <= {j0, j1}:
                return None
            if j0 == j1:
                # Both taps clamp to the same texel: matrix accumulated
                # w0+w1 there; split as (sum, 0) so the kernel's
                # w0*t0 + w1*t1 reproduces the exact matrix value
                # (t0 == t1, w1 term is 0).
                w0[p, k] = rows[k][j0]
                w1[p, k] = 0.0
            else:
                w0[p, k] = rows[k][j0]
                w1[p, k] = rows[k][j1]
    return r, d, w0, w1


def resample_u8_xphase_plain(tex, ytaps, plan):
    """Plain torch version: ``tex [B, H, W, C]`` f32; ``ytaps`` the y
    axis's ``(i0, w0, i1, w1)`` tensors (``axis_taps``) or None for the
    identity; ``plan`` from ``_xphase_plan`` → u8 ``[B, OH, r*W, C]``.
    y first, then per phase ``w0*t0 + w1*t1``, each rounded apart: the
    kernel's arithmetic."""
    r, d, w0, w1 = plan
    b, _, w, c = tex.shape
    dev = tex.device
    a = tex
    if ytaps is not None:
        i0, y0, i1, y1 = ytaps
        a = y0[:, None, None] * tex[:, i0.long()] + y1[:, None, None] * tex[:, i1.long()]
    k = torch.arange(w, device=dev)
    w0_t, w1_t = to_device(w0, dev), to_device(w1, dev)
    phases = []
    for p in range(r):
        j0 = (k + d[p]).clamp(0, w - 1)
        j1 = (k + d[p] + 1).clamp(0, w - 1)
        phases.append(w0_t[p][:, None] * a[:, :, j0] + w1_t[p][:, None] * a[:, :, j1])
    out = torch.stack(phases, dim=-2).reshape(b, a.shape[1], r * w, c)
    return _quantize_u8(out)


def _xphase_tables(plan, dev):
    """The plan's phase tables ``(d, w0, w1)`` on ``dev``."""
    _, d, w0, w1 = plan
    return (
        torch.tensor(d, dtype=torch.int32, device=dev),
        to_device(w0, dev).contiguous(),
        to_device(w1, dev).contiguous(),
    )


def _launch_xphase(t4, ytaps, plan, tables=None):
    from retrocapture_tpu_torch.ops.cuda._build import load

    global XPHASE_LAUNCHES
    r = plan[0]
    b, h, w, c = t4.shape
    if not 1 <= c <= 4:
        raise ValueError(f"resample_u8_xphase: the kernel takes 1 to 4 channels, got {c}")
    dev = t4.device
    oh = h if ytaps is None else ytaps[0].shape[0]
    out = torch.empty((b, oh, r * w, c), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    d_t, w0_t, w1_t = tables or _xphase_tables(plan, dev)
    rc = load("resample_xphase")(
        t4.data_ptr(), out.data_ptr(), *(_ptr(t) for t in ytaps or (None,) * 4),
        d_t.data_ptr(), w0_t.data_ptr(), w1_t.data_ptr(),
        b, h, w, c, oh, r,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"resample_xphase kernel launch failed: cudaError {rc}")
    XPHASE_LAUNCHES += 1
    return out


def resample_u8_xphase(tex, ay, plan, *, ytaps=None, tables=None):
    """``tex [H, W, C]`` or ``[B, H, W, C]`` f32; ``ay [OH, H]`` numpy
    axis matrix or None (identity); ``plan`` from ``_xphase_plan`` → u8
    ``[..., OH, r*W, C]``. A CUDA tensor launches the kernel; a CPU
    tensor takes the plain version. ``ytaps`` (``axis_taps(ay)`` as
    tensors on tex's device) and ``tables`` (``_xphase_tables``) spare a
    caller that keeps them the uploads."""
    t4, squeeze = _batch4(tex, "resample_u8_xphase")
    if plan[2].shape[1] != t4.shape[2]:
        raise ValueError(f"resample_u8_xphase: plan for width {plan[2].shape[1]}, tex width {t4.shape[2]}")
    if ay is not None and ay.shape[1] != t4.shape[1]:
        raise ValueError(f"resample_u8_xphase: axis matrix {ay.shape} does not match {t4.shape[1]}")
    dev = t4.device
    if ytaps is None and ay is not None:
        ytaps = tuple(to_device(t, dev) for t in axis_taps(ay))
    if t4.is_cuda:
        out = _launch_xphase(t4, ytaps, plan, tables)
    elif dev.type == "cpu":
        out = resample_u8_xphase_plain(t4, ytaps, plan)
    else:
        raise RuntimeError(f"resample_u8_xphase: no kernel for device {dev}")
    return out[0] if squeeze else out


def blit_matrices(h: int, w: int, vw: int, vh: int):
    """The viewport blit's axis matrices (LINEAR, clamp_to_edge), None for
    an identity axis — exactly what the reference's blit_u8 builds."""
    u_row = ((np.arange(vw, dtype=np.float64) + 0.5) / np.float64(vw)).astype(np.float32)
    v_col = ((np.arange(vh, dtype=np.float64) + 0.5) / np.float64(vh)).astype(np.float32)
    ay = None if _axis_is_identity(v_col, h, True, "clamp_to_edge") else _axis_matrix(
        v_col, h, True, "clamp_to_edge"
    )
    ax = None if _axis_is_identity(u_row, w, True, "clamp_to_edge") else _axis_matrix(
        u_row, w, True, "clamp_to_edge"
    )
    return ay, ax


class _BlitPlan:
    """What ``blit_u8`` derives from one geometry on one device, each part
    built at its first use: the axis matrices (host, and as tensors for
    the plain version), the y taps, the kernel's tables per channel
    count, and the xphase plan with its device tables."""

    _UNSET = object()

    def __init__(self, h: int, w: int, vw: int, vh: int, device):
        self.h, self.w, self.vw, self.device = h, w, vw, device
        self.ay, self.ax = blit_matrices(h, w, vw, vh)
        self._ytaps = self._mats = self._xplan = self._UNSET
        self._dense: dict = {}

    @property
    def ytaps(self):
        if self._ytaps is self._UNSET:
            self._ytaps = None if self.ay is None else tuple(
                to_device(t, self.device) for t in axis_taps(self.ay))
        return self._ytaps

    @property
    def matrices(self):
        if self._mats is self._UNSET:
            self._mats = tuple(None if a is None else to_device(a, self.device) for a in (self.ay, self.ax))
        return self._mats

    def dense(self, c: int) -> _Dense:
        d = self._dense.get(c)
        if d is None:
            d = self._dense[c] = _dense_tables(self.ay, self.ax, self.h, self.w, c, self.device, self.ytaps)
        return d

    @property
    def xphase(self):
        """(plan, device tables or None on the CPU), or None where the x
        axis has no integer phase structure."""
        if self._xplan is self._UNSET:
            plan = None if self.ax is None else _xphase_plan(self.ax, self.w, self.vw)
            cuda = plan is not None and torch.device(self.device).type == "cuda"
            self._xplan = None if plan is None else (plan, _xphase_tables(plan, self.device) if cuda else None)
        return self._xplan


_BLIT_CACHE: OrderedDict = OrderedDict()


def clear_blit_cache() -> None:
    _BLIT_CACHE.clear()


def _blit_plan(h: int, w: int, vw: int, vh: int, device) -> _BlitPlan:
    """The cached plan of a geometry on a device; the least recently used
    entry leaves when the cache is full."""
    key = (h, w, vw, vh, str(device))
    plan = _BLIT_CACHE.get(key)
    if plan is None:
        plan = _BLIT_CACHE[key] = _BlitPlan(h, w, vw, vh, device)
        while len(_BLIT_CACHE) > _BLIT_CACHE_MAX:
            _BLIT_CACHE.popitem(last=False)
    else:
        _BLIT_CACHE.move_to_end(key)
    return plan


def blit_u8(tex, vw: int, vh: int):
    """Final viewport blit (LINEAR, clamp_to_edge) fused with the uint8
    pack: ``tex [..., H, W, C]`` f32 → u8 ``[..., vh, vw, C]``. An
    identity-identity blit is the plain quantize, as in the reference.
    ``RCTPU_XPHASE=on`` takes the phase-form kernel where the x axis is
    an integer upscale (the reference's resample.py:421-425; its VMEM
    guard ``_xphase_fits`` has no counterpart here). The geometry's
    matrices and device tables come from the blit cache."""
    h, w = tex.shape[-3], tex.shape[-2]
    plan = _blit_plan(h, w, vw, vh, tex.device)
    if plan.ay is None and plan.ax is None:
        return _quantize_u8(tex)
    if plan.ax is not None and os.environ.get("RCTPU_XPHASE", "off") == "on" and plan.xphase is not None:
        xplan, tables = plan.xphase
        return resample_u8_xphase(tex, plan.ay, xplan, ytaps=plan.ytaps, tables=tables)
    if tex.is_cuda:
        t4, squeeze = _batch4(tex, "resample_u8")
        out = _launch(t4, plan.dense(t4.shape[3]))
        return out[0] if squeeze else out
    if tex.device.type != "cpu":
        raise RuntimeError(f"resample_u8: no kernel for device {tex.device}")
    return resample_u8_plain(tex, *plan.matrices)
