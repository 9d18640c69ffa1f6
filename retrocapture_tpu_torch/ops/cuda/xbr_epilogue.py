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
``xbr_epilogue_fits``. The CUDA kernel (``csrc/xbr_epilogue.cu``) works on
tiles of output rows x output columns: the work that depends only on the
source texel is done once per texel into shared memory, the rest per
output pixel, one 16-byte store each. It has no width limit: a column
tile whose source range does not fit shared memory is computed from
global memory in the same kernel and counted in ``general_blocks()``.
See the source for its bound.

``prepare_maps`` validates ``bx``, ``fpx``, ``fpy`` for a source width,
puts them on a device and plans the kernel's column tiles; a caller that
keeps its result (the xbr-lv2 hand kernel does, per geometry) uploads
nothing per call.

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

from typing import Optional

import numpy as np
import torch

from retrocapture_tpu_torch.policy import fma32, upload

__all__ = ["xbr_epilogue", "xbr_epilogue_plain", "prepare_maps", "EpilogueMaps", "general_blocks", "LAUNCHES"]

LAUNCHES = 0
_GENERAL_BLOCKS = 0
_NCH = 19  # E, H, F, B, D colours x255 (15 planes) + 4 code planes

# The kernel's geometry (csrc/xbr_epilogue.cu): one output column a
# thread, a block of 128 to 256 threads (the width that pads the output
# row least), up to 8 output rows a block; a source texel's record takes
# 112 bytes of shared memory, and a block's records stay under the budget.
_TILE_WIDTHS = (256, 224, 192, 160, 128)
_TEXEL_BYTES = 112
_SHARED_BUDGET = 48 * 1024
_ROWS_MAX = 8

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
    t = upload(_ramp_table(), S.device)[..., None, None]  # [4, 4, 4, 1, 1]
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


def general_blocks(reset: bool = False) -> int:
    """The blocks (one frame, one tile of rows x columns) that the kernel
    has computed from global memory since the last reset: column tiles
    whose source range does not fit the shared-memory budget. ``reset``
    zeroes the count."""
    global _GENERAL_BLOCKS
    n = _GENERAL_BLOCKS
    if reset:
        _GENERAL_BLOCKS = 0
    return n


class EpilogueMaps:
    """``bx``, ``fpx``, ``fpy`` of one geometry, validated, as tensors on a
    device, with the kernel's plan of column tiles (``prepare_maps``)."""

    __slots__ = ("bx", "fpx", "fpy", "w", "tile_px", "rows", "max_n", "tile_lo", "tile_n", "general_tiles")


def _tile_plan(bx: np.ndarray):
    """``(tile_px, rows, max_n, tile_lo, tile_n)`` for the source columns
    ``bx [OW]``: the tile width, and per tile the first source column and
    the number of source columns it is mapped to (any ``bx`` has such a
    range); ``n = 0`` for a tile whose range exceeds the budget at one row
    a block. ``rows``: output rows a block, among the counts the budget
    allows (from half the most on) the one whose texels (``rows x max_n``,
    prepared once per block by all threads in turns) leave the fewest
    threads idle in the last turn; the larger of equals."""
    ow = bx.shape[0]
    if ow < _TILE_WIDTHS[-1]:
        tile_px = max(32, -(-ow // 32) * 32)
    else:
        tile_px = min(_TILE_WIDTHS, key=lambda t: (-(-ow // t) * t, -t))
    starts = np.arange(0, ow, tile_px)
    lo = np.minimum.reduceat(bx, starts)
    n = np.maximum.reduceat(bx, starts) - lo + 1
    n = np.where(n * _TEXEL_BYTES <= _SHARED_BUDGET, n, 0)
    max_n = int(n.max())
    if max_n == 0:
        return tile_px, _ROWS_MAX, max_n, lo.astype(np.int32), n.astype(np.int32)
    most = max(1, min(_ROWS_MAX, _SHARED_BUDGET // (_TEXEL_BYTES * max_n)))
    rows = min(range(-(-most // 2), most + 1), key=lambda r: (-(r * max_n) % tile_px / (r * max_n), -r))
    return tile_px, rows, max_n, lo.astype(np.int32), n.astype(np.int32)


def prepare_maps(bx, fpx, fpy, w: int, device) -> EpilogueMaps:
    """Validate ``bx [OW]`` (integer source columns in ``[0, w)``),
    ``fpx [OW]`` and ``fpy [OH]`` (host arrays) and put them on
    ``device``, with the kernel's tile plan where that is a card."""
    bx = np.asarray(bx)
    fpx = np.asarray(fpx, np.float32)
    fpy = np.asarray(fpy, np.float32)
    if bx.ndim != 1 or fpx.shape != bx.shape or fpy.ndim != 1:
        raise ValueError(f"xbr_epilogue: bx and fpx must be [OW] and fpy [OH], got {bx.shape}, {fpx.shape}, {fpy.shape}")
    if not np.issubdtype(bx.dtype, np.integer) or (bx.size and (bx.min() < 0 or bx.max() >= w)):
        raise ValueError(f"xbr_epilogue: bx must be integer source columns in [0, {w})")
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"xbr_epilogue: no kernel for device {device}")
    m = EpilogueMaps()
    m.w = int(w)
    m.bx = torch.from_numpy(bx.astype(np.int32)).to(device)
    m.fpx = torch.from_numpy(fpx).to(device)
    m.fpy = torch.from_numpy(fpy).to(device)
    m.tile_px = m.rows = m.max_n = m.general_tiles = 0
    m.tile_lo = m.tile_n = None
    if device.type == "cuda" and bx.size:
        m.tile_px, m.rows, m.max_n, lo, n = _tile_plan(bx.astype(np.int64))
        m.tile_lo = torch.from_numpy(lo).to(device)
        m.tile_n = torch.from_numpy(n).to(device)
        m.general_tiles = int((n == 0).sum())
    return m


# The kernel's constants (the ramp table, 64 floats, and 1/255), passed to
# the launch from host memory and to the kernel by value.
_CONSTANTS = np.ascontiguousarray(np.append(_ramp_table().reshape(-1), _INV255), np.float32)


@torch.library.custom_op("rctpu::xbr_epilogue", mutates_args=(), device_types="cuda")
def _xbr_epilogue_op(S: torch.Tensor, bx: torch.Tensor, fpx: torch.Tensor, fpy: torch.Tensor,
                     tile_lo: Optional[torch.Tensor], tile_n: Optional[torch.Tensor], tile_px: int, rows: int,
                     max_n: int, general_tiles: int) -> torch.Tensor:
    """``S [B, 19, OH, W]`` f32 and the maps of ``prepare_maps`` (its tile
    plan on a card) → ``[B, OH, OW, 4]``: the kernel on a card."""
    from retrocapture_tpu_torch.ops.cuda._build import load

    global LAUNCHES, _GENERAL_BLOCKS
    S = S.contiguous()
    b, _, oh, w = S.shape
    ow = bx.shape[0]
    dev = S.device
    out = torch.empty((b, oh, ow, 4), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    rc = load("xbr_epilogue")(
        S.data_ptr(), bx.data_ptr(), fpx.data_ptr(), fpy.data_ptr(), tile_lo.data_ptr(),
        tile_n.data_ptr(), _CONSTANTS.ctypes.data, out.data_ptr(),
        b, oh, w, ow, tile_px, rows, max_n, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"xbr_epilogue kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    _GENERAL_BLOCKS += general_tiles * -(-oh // rows) * b
    return out


@_xbr_epilogue_op.register_kernel("cpu")
def _xbr_epilogue_cpu(S, bx, fpx, fpy, tile_lo, tile_n, tile_px, rows, max_n, general_tiles):
    return xbr_epilogue_plain(S, bx, fpx, fpy)


@_xbr_epilogue_op.register_fake
def _xbr_epilogue_fake(S, bx, fpx, fpy, tile_lo, tile_n, tile_px, rows, max_n, general_tiles):
    return S.new_empty((S.shape[0], S.shape[2], bx.shape[0], 4))


@_xbr_epilogue_op.register_vmap
def _xbr_epilogue_vmap(info, in_dims, S, bx, fpx, fpy, tile_lo, tile_n, *plan):
    sd = in_dims[0]
    maps = (bx, fpx, fpy, tile_lo, tile_n)
    if all(d is None for d in in_dims[1:6]):
        # One geometry for the batch: its S planes in one launch.
        t = S.movedim(sd, 0)
        out = _xbr_epilogue_op(t.reshape((-1,) + tuple(t.shape[2:])), *maps, *plan)
        return out.reshape(tuple(t.shape[:2]) + tuple(out.shape[1:])), 0
    outs = [
        _xbr_epilogue_op(*(x if d is None else x.select(d, i) for x, d in zip((S,) + maps, in_dims)), *plan)
        for i in range(info.batch_size)
    ]
    return torch.stack(outs), 0


def xbr_epilogue(S, bx, fpx=None, fpy=None):
    """``S [B, 19, OH, W]`` f32 (E, H, F, B, D x255 and 4 code planes),
    ``bx [OW]`` source column of each output column (host array, clamped
    to ``[0, W)``), ``fpx [OW]`` and ``fpy [OH]`` fract phases (host
    arrays) → ``[B, OH, OW, 4]`` f32 on S's device. ``bx`` may be the
    ``EpilogueMaps`` that ``prepare_maps`` made of the three for S's width
    and device (then ``fpx`` and ``fpy`` are left out). A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version. Both sit
    behind the operator ``rctpu::xbr_epilogue``, whose batching rule
    launches once for a batch of S that shares the maps."""
    if not isinstance(S, torch.Tensor) or S.dtype != torch.float32:
        raise TypeError(f"xbr_epilogue: S must be a float32 tensor, got {getattr(S, 'dtype', type(S))}")
    if S.dim() != 4 or S.shape[1] != _NCH:
        raise ValueError(f"xbr_epilogue: S must be [B, {_NCH}, OH, W], got {tuple(S.shape)}")
    _, _, oh, w = S.shape
    m = bx if isinstance(bx, EpilogueMaps) else prepare_maps(bx, fpx, fpy, w, S.device)
    if m.w != w or m.fpy.shape != (oh,) or m.bx.device != S.device:
        raise ValueError(
            f"xbr_epilogue: maps for width {m.w}, {m.fpy.shape[0]} rows on {m.bx.device}; "
            f"S is {tuple(S.shape)} on {S.device}"
        )
    return _xbr_epilogue_op(
        S, m.bx, m.fpx, m.fpy, m.tile_lo, m.tile_n, m.tile_px, m.rows, m.max_n, m.general_tiles
    )
