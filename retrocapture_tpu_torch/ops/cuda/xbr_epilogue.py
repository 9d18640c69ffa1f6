"""The xbr-lv2 full-resolution epilogue: the CUDA kernel and its plain
version.

Replaces ``retrocapture_tpu/ops/pallas/xbr_epilogue.py:xbr_epilogue``.
The xbr-lv2 hand kernel (graph/kernels._xbr_lv2_kernel) reduces the
shader to 19 planes at [output rows, source columns] (the E, H, F, B and
D colours x255 and 4 packed flag codes, ``S``); this function does the
rest at full resolution:

* a NEAREST x-upsample of every plane through ``bx`` (source column of
  each output column);
* ``x (1/255)`` on the colours and the decode of each code into its five
  edge flags (edri, edr, edr_left, edr_up, px);
* the four fp ramps of each corner (fx45, fx30, fx60, fx45i), rebuilt
  from the 1D phases ``fpx`` and ``fpy``, and their flag-weighted max;
* the px mixes, res1 / res2 and the ``c_df`` select; alpha = 1.

The TPU kernel rebuilds the x-upsample from a rotated 128-lane window
(Mosaic gathers are single-vreg), which is why the reference has
``xbr_epilogue_fits``. The CUDA kernel (``csrc/xbr_epilogue.cu``) is one
thread per output pixel: 19 reads at ``(b, c, y, bx[x])`` through L1 and
one 16-byte store; it has no width limit. See the source for its bound.

Numerics are those of the reference as ``jax.jit`` compiles it on the
CPU, measured in tests/test_torch_xbr.py: XLA contracts each mix
``a + (b - a) * m`` into one rounding (``policy.fma32``) where ``m`` is a
fractional ramp weight; where ``m`` is a flag (0 or 1) the product is
exact and both forms agree. The ramps' products are exact (A, B in
{+-0.5, +-1, +-2}), so contraction cannot change them. The kernel writes
every rounding out and is bit-equal to the plain version.

``xbr_epilogue`` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from retrocapture_tpu_torch.policy import fma32

__all__ = ["xbr_epilogue", "xbr_epilogue_plain", "LAUNCHES"]

LAUNCHES = 0
_NCH = 19  # E, H, F, B, D colours x255 (15 planes) + 4 code planes

# vec4 line constants (xbr-lv2.glsl:182-191); XBR_SCALE = 3.0
_AO = np.array([1.0, -1.0, -1.0, 1.0], np.float32)
_BO = np.array([1.0, 1.0, -1.0, -1.0], np.float32)
_CO = np.array([1.5, 0.5, -0.5, 0.5], np.float32)
_AX = np.array([1.0, -1.0, -1.0, 1.0], np.float32)
_BX = np.array([0.5, 2.0, -0.5, -2.0], np.float32)
_CX = np.array([1.0, 1.0, -0.5, 0.0], np.float32)
_AY = np.array([1.0, -1.0, -1.0, 1.0], np.float32)
_BY = np.array([2.0, 0.5, -2.0, -0.5], np.float32)
_CY = np.array([2.0, 0.0, -1.0, 0.5], np.float32)
_D4 = np.full(4, 1.0 / 3.0, np.float32)
_DL = np.array([0.5, 1.0, 0.5, 1.0], np.float32) / 3.0
_DU = np.array([1.0, 0.5, 1.0, 0.5], np.float32) / 3.0

_INV255 = np.float32(1.0 / 255.0)

# The four ramps of each corner, in the order the maximum takes them:
# (A, B, C, delta, extra) with ramp = clip((A fpy + B fpx + (delta - C -
# extra)) / (2 delta), 0, 1).
_RAMPS = (
    (_AX, _BX, _CX, _DL, 0.0),  # fx30, weighted by edr_left
    (_AY, _BY, _CY, _DU, 0.0),  # fx60, weighted by edr_up
    (_AO, _BO, _CO, _D4, 0.0),  # fx45, weighted by edr
    (_AO, _BO, _CO, _D4, 0.25),  # fx45i, weighted by edri
)


def _ramp_table() -> np.ndarray:
    """[4 ramps, 4 corners, 4] f32: (A, B, offset, scale) of each ramp,
    the offset and scale rounded to f32 as the reference rounds them."""
    return np.array(
        [
            [[A[ci], B[ci], np.float32(d[ci] - C[ci] - extra), np.float32(1.0 / (2.0 * d[ci]))] for ci in range(4)]
            for A, B, C, d, extra in _RAMPS
        ],
        np.float32,
    )


def _mix(a, b, m):
    """mix by a flag m in {0, 1}: the product is exact."""
    return a + (b - a) * m


def _mixf(a, b, m):
    """mix by a fractional ramp weight, contracted as jitted XLA does."""
    return fma32(b - a, m, a)


def xbr_epilogue_plain(S, bx, fpx, fpy):
    """Plain torch version: ``S [B, 19, OH, W]`` f32, ``bx [OW]`` int
    (clamped source columns), ``fpx [OW]``, ``fpy [OH]`` f32 tensors on
    S's device → ``[B, OH, OW, 4]`` f32. A torch gather, then the
    kernel's arithmetic in the kernel's order."""
    up = S.index_select(3, bx.long())  # [B, 19, OH, OW]
    col = up[:, :15] * float(_INV255)
    E, H, F, Bc, D = (col[:, 3 * k : 3 * k + 3] for k in range(5))
    code = up[:, 15:]
    edri = torch.remainder(code, 2.0)
    r = torch.floor(code * 0.5)
    edr = torch.remainder(r, 2.0)
    r = torch.floor(r * 0.5)
    edrl = torch.remainder(r, 2.0)
    r = torch.floor(r * 0.5)
    edru = torch.remainder(r, 2.0)
    px = torch.floor(r * 0.5)
    t = torch.from_numpy(_ramp_table()).to(S.device)[..., None, None]  # [4, 4, 4, 1, 1]
    ramps = torch.clamp(
        (t[:, :, 0] * fpy[:, None] + t[:, :, 1] * fpx[None, :] + t[:, :, 2]) * t[:, :, 3], 0.0, 1.0
    )  # [4 ramps, 4 corners, OH, OW]
    m = torch.maximum(
        torch.maximum(edrl * ramps[0], edru * ramps[1]), torch.maximum(edr * ramps[2], edri * ramps[3])
    )  # [B, 4, OH, OW]
    Tx = _mix(H, F, px[:, 0:1])
    Tz = _mix(Bc, D, px[:, 2:3])
    Ty = _mix(F, Bc, px[:, 1:2])
    Tw = _mix(D, H, px[:, 3:4])
    res1 = _mixf(_mixf(E, Tx, m[:, 0:1]), Tz, m[:, 2:3])
    res2 = _mixf(_mixf(E, Ty, m[:, 1:2]), Tw, m[:, 3:4])

    def c_df(c):
        d = (E - c).abs()
        return d[:, 0] + d[:, 1] + d[:, 2]

    sel = (c_df(res2) >= c_df(res1)).to(torch.float32)[:, None]
    res = _mix(res1, res2, sel)
    alpha = torch.ones_like(res[:, :1])
    return torch.cat([res, alpha], dim=1).permute(0, 2, 3, 1).contiguous()


_TABLES: dict = {}


def _table(device) -> torch.Tensor:
    """The kernel's constants on ``device``: the ramp table (64 floats)
    and 1/255."""
    t = _TABLES.get(device)
    if t is None:
        t = torch.from_numpy(np.append(_ramp_table().reshape(-1), _INV255)).to(device)
        _TABLES[device] = t
    return t


def _launch(S, bx, fpx, fpy):
    from retrocapture_tpu_torch.ops.cuda._build import load

    global LAUNCHES
    b, _, oh, w = S.shape
    ow = bx.shape[0]
    dev = S.device
    out = torch.empty((b, oh, ow, 4), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    rc = load("xbr_epilogue")(
        S.data_ptr(), bx.data_ptr(), fpx.data_ptr(), fpy.data_ptr(), _table(dev).data_ptr(), out.data_ptr(),
        b, oh, w, ow, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"xbr_epilogue kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def xbr_epilogue(S, bx, fpx, fpy):
    """``S [B, 19, OH, W]`` f32 (E, H, F, B, D x255 and 4 code planes),
    ``bx [OW]`` source column of each output column (host array, clamped
    to ``[0, W)``), ``fpx [OW]`` and ``fpy [OH]`` fract phases (host
    arrays) → ``[B, OH, OW, 4]`` f32 on S's device. A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version."""
    if not isinstance(S, torch.Tensor) or S.dtype != torch.float32:
        raise TypeError(f"xbr_epilogue: S must be a float32 tensor, got {getattr(S, 'dtype', type(S))}")
    if S.dim() != 4 or S.shape[1] != _NCH:
        raise ValueError(f"xbr_epilogue: S must be [B, {_NCH}, OH, W], got {tuple(S.shape)}")
    _, _, oh, w = S.shape
    bx = np.asarray(bx)
    fpx = np.asarray(fpx, np.float32)
    fpy = np.asarray(fpy, np.float32)
    if bx.ndim != 1 or fpx.shape != bx.shape or fpy.shape != (oh,):
        raise ValueError(
            f"xbr_epilogue: bx and fpx must be [OW] and fpy [{oh}], got {bx.shape}, {fpx.shape}, {fpy.shape}"
        )
    if not np.issubdtype(bx.dtype, np.integer) or (bx.size and (bx.min() < 0 or bx.max() >= w)):
        raise ValueError(f"xbr_epilogue: bx must be integer source columns in [0, {w})")
    if S.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"xbr_epilogue: no kernel for device {S.device}")
    dev = S.device
    bx_t = torch.from_numpy(bx.astype(np.int32)).to(dev)
    fpx_t = torch.from_numpy(fpx).to(dev)
    fpy_t = torch.from_numpy(fpy).to(dev)
    if S.is_cuda:
        return _launch(S.contiguous(), bx_t, fpx_t, fpy_t)
    return xbr_epilogue_plain(S, bx_t, fpx_t, fpy_t)
