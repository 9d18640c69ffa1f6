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
"""

from __future__ import annotations

import numpy as np
import torch

from retrocapture_tpu_torch.ops.sampling import _axis_is_identity, _axis_matrix
from retrocapture_tpu_torch.policy import to_device

__all__ = ["resample_u8", "resample_u8_plain", "blit_u8", "blit_matrices", "axis_taps", "LAUNCHES"]

LAUNCHES = 0


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
    identity-identity blit is the plain quantize, as in the reference."""
    h, w = tex.shape[-3], tex.shape[-2]
    ay, ax = blit_matrices(h, w, vw, vh)
    if ay is None and ax is None:
        return _quantize_u8(tex)
    return resample_u8(tex, ay, ax)
