"""Fused viewport blit + uint8 pack: the CUDA kernel and its plain version.

Replaces ``retrocapture_tpu/ops/pallas/resample.py:resample_u8`` (reached
through ``blit_u8``). The reference computes the blit as two dense f32
matmuls, y first, then the quantize:

    out[y, x, c] = u8(rint(clip(sum_s sum_t ay[y,s] tex[s,t,c] ax[x,t], 0, 1) * 255))

Each row of ``ay`` / ``ax`` (LINEAR, clamp_to_edge) has at most two
nonzero weights. The CUDA kernel (``csrc/resample_u8.cu``) takes those
two (index, weight) pairs per row, read on the host from the very
matrix the reference builds (``sampling._axis_matrix``), and sums y first
and x second. It is bound by the bytes it writes; see the source note.

``resample_u8`` launches the kernel for a CUDA tensor and takes the
plain version (two einsums and the quantize, the reference's
``_einsum_fallback``) only for a CPU tensor. ``LAUNCHES`` counts kernel
launches.

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
    "LAUNCHES",
    "XPHASE_LAUNCHES",
]

LAUNCHES = 0
XPHASE_LAUNCHES = 0


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


def _launch(tex, ay, ax):
    from retrocapture_tpu_torch.ops.cuda._build import load

    global LAUNCHES
    if tex.dtype != torch.float32:
        raise TypeError(f"resample_u8: tex must be float32, got {tex.dtype}")
    squeeze = tex.dim() == 3
    t4 = tex[None] if squeeze else tex
    if t4.dim() != 4:
        raise ValueError(f"resample_u8: tex must be [H,W,C] or [B,H,W,C], got {tuple(tex.shape)}")
    t4 = t4.contiguous()
    b, h, w, c = t4.shape
    dev = t4.device
    tabs = []
    for a, n_in in ((ay, h), (ax, w)):
        if a is None:
            tabs.append((None, None, None, None))
            continue
        if a.shape[1] != n_in:
            raise ValueError(f"resample_u8: axis matrix {a.shape} does not match {n_in}")
        tabs.append(tuple(to_device(t, dev) for t in axis_taps(a)))
    oh = h if ay is None else ay.shape[0]
    ow = w if ax is None else ax.shape[0]
    out = torch.empty((b, oh, ow, c), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out[0] if squeeze else out

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = load("resample_u8")
    (yi0, yw0, yi1, yw1), (xi0, xw0, xi1, xw1) = tabs
    rc = fn(
        t4.data_ptr(), out.data_ptr(),
        ptr(yi0), ptr(yw0), ptr(yi1), ptr(yw1),
        ptr(xi0), ptr(xw0), ptr(xi1), ptr(xw1),
        b, h, w, c, oh, ow,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"resample_u8 kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out[0] if squeeze else out


def resample_u8(tex, ay, ax):
    """``tex [H, W, C]`` or ``[B, H, W, C]`` f32; ``ay [OH, H]`` /
    ``ax [OW, W]`` numpy axis matrices or None (identity axis, skipped)
    → u8 ``[..., OH, OW, C]``. A CUDA tensor launches the kernel; a CPU
    tensor takes the plain version."""
    if tex.is_cuda:
        return _launch(tex, ay, ax)
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


def _launch_xphase(t4, ytaps, plan):
    from retrocapture_tpu_torch.ops.cuda._build import load

    global XPHASE_LAUNCHES
    r, d, w0, w1 = plan
    b, h, w, c = t4.shape
    if not 1 <= c <= 4:
        raise ValueError(f"resample_u8_xphase: the kernel takes 1 to 4 channels, got {c}")
    dev = t4.device
    oh = h if ytaps is None else ytaps[0].shape[0]
    out = torch.empty((b, oh, r * w, c), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    yi0, yw0, yi1, yw1 = (None,) * 4 if ytaps is None else ytaps
    d_t = torch.tensor(d, dtype=torch.int32, device=dev)
    w0_t, w1_t = to_device(w0, dev).contiguous(), to_device(w1, dev).contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = load("resample_xphase")(
        t4.data_ptr(), out.data_ptr(), ptr(yi0), ptr(yw0), ptr(yi1), ptr(yw1),
        d_t.data_ptr(), w0_t.data_ptr(), w1_t.data_ptr(),
        b, h, w, c, oh, r,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"resample_xphase kernel launch failed: cudaError {rc}")
    XPHASE_LAUNCHES += 1
    return out


def resample_u8_xphase(tex, ay, plan):
    """``tex [H, W, C]`` or ``[B, H, W, C]`` f32; ``ay [OH, H]`` numpy
    axis matrix or None (identity); ``plan`` from ``_xphase_plan`` → u8
    ``[..., OH, r*W, C]``. A CUDA tensor launches the kernel; a CPU
    tensor takes the plain version."""
    if tex.dtype != torch.float32:
        raise TypeError(f"resample_u8_xphase: tex must be float32, got {tex.dtype}")
    squeeze = tex.dim() == 3
    t4 = (tex[None] if squeeze else tex).contiguous()
    if t4.dim() != 4:
        raise ValueError(f"resample_u8_xphase: tex must be [H,W,C] or [B,H,W,C], got {tuple(tex.shape)}")
    if plan[2].shape[1] != t4.shape[2]:
        raise ValueError(f"resample_u8_xphase: plan for width {plan[2].shape[1]}, tex width {t4.shape[2]}")
    if ay is not None and ay.shape[1] != t4.shape[1]:
        raise ValueError(f"resample_u8_xphase: axis matrix {ay.shape} does not match {t4.shape[1]}")
    dev = t4.device
    ytaps = None if ay is None else tuple(to_device(t, dev) for t in axis_taps(ay))
    if t4.is_cuda:
        out = _launch_xphase(t4, ytaps, plan)
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


def blit_u8(tex, vw: int, vh: int):
    """Final viewport blit (LINEAR, clamp_to_edge) fused with the uint8
    pack: ``tex [..., H, W, C]`` f32 → u8 ``[..., vh, vw, C]``. An
    identity-identity blit is the plain quantize, as in the reference.
    ``RCTPU_XPHASE=on`` takes the phase-form kernel where the x axis is
    an integer upscale (the reference's resample.py:421-425; its VMEM
    guard ``_xphase_fits`` has no counterpart here)."""
    h, w = tex.shape[-3], tex.shape[-2]
    ay, ax = blit_matrices(h, w, vw, vh)
    if ay is None and ax is None:
        return _quantize_u8(tex)
    if ax is not None and os.environ.get("RCTPU_XPHASE", "off") == "on":
        plan = _xphase_plan(ax, w, vw)
        if plan is not None:
            return resample_u8_xphase(tex, ay, plan)
    return resample_u8(tex, ay, ax)
