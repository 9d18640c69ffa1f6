"""The xbr-lv2 front section: the CUDA kernel and its plain version.

Replaces no TPU kernel: the reference computes the front section of
``retrocapture_tpu/graph/kernels.py:_xbr_lv2_kernel`` as jnp code that
XLA fuses. The port's plain version is ``graph/kernels._xbr_planes``
(held bit-equal to the JAX engine in tests/test_torch_xbr.py): 21 NEAREST
taps at [output rows, source columns], their lumas, the edge rules and
the four corner codes, as eager torch passes. The CUDA kernel
(``csrc/xbr_front.cu``) reads the source texels and writes the 19 planes
``S [B, 19, OH, W]`` (the E, H, F, B, D colours x255 and 4 packed flag
codes) once, bit-equal to the plain version; ``xbr_epilogue`` reads them.

The geometry comes in as ``_xbr_gathers``' index tensors, kept per
geometry by the xbr-lv2 hand kernel: the clamped columns ``[W + 4]`` and
the 5 row maps ``{-2..2: [OH]}``. The kernel's branches come from the call:
``small`` (< 0.5: luma taps; else the y-weighted lumas of the outer taps)
and ``quantized`` (the texture is on the k/255 grid: the colours are
rounded to the level).

``xbr_front`` launches the kernel for a CUDA tensor and takes the plain
version only for a CPU tensor. Both sit behind the operator
``rctpu::xbr_front``, whose batching rule launches once for a batch of
textures that shares the gathers. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["xbr_front", "xbr_front_plain", "tile_plan", "LAUNCHES"]

LAUNCHES = 0
_NCH = 19

# The kernel's block (csrc/xbr_front.cu): one source column a thread, a
# tile width of 64 to 256 threads (the one that pads the row least, the
# larger of equals), ROWS consecutive output rows a block. At the
# benchmark's shape ([64, 240, 320] -> 1080 rows, on an H100) 8 rows a block
# beat 16, 32 and 64 at tile widths 64, 160 and 320 (PERF.md §6).
_TILE_WIDTHS = (256, 224, 192, 160, 128, 96, 64)
ROWS = 8

_F = np.float32


def tile_plan(w: int):
    """``(tile_px, rows)``: the kernel's block for source width ``w``."""
    if w < _TILE_WIDTHS[-1]:
        return max(32, -(-w // 32) * 32), ROWS
    return min(_TILE_WIDTHS, key=lambda t: (-(-w // t) * t, -t)), ROWS


def _constants(eq_thr, lv2_cf, y_weight) -> np.ndarray:
    """The kernel's constants, each the f32 value the plain version uses:
    eq_thr, the LV2 coefficient, 1/255, 0.1, the 3 luma weights and the 3
    y-luma weights."""
    from retrocapture_tpu_torch.graph.kernels import _XBR_RGBW, _XBR_Y

    yw = _XBR_Y * _F(y_weight)
    return np.ascontiguousarray(
        np.concatenate([[_F(eq_thr), _F(lv2_cf), _F(1.0 / 255.0), _F(0.1)], _XBR_RGBW, yw]), np.float32
    )


def xbr_front_plain(tex, cols, rows, eq_thr, lv2_cf, small, y_weight, quantized: bool):
    """Plain torch version: ``tex [B, H, W, >=3]`` f32, ``cols [W + 4]``
    and ``rows`` (5 row maps ``[OH]``, dy = -2..2) int64 on tex's device →
    ``S [B, 19, OH, W]`` f32: ``_xbr_planes`` frame by frame."""
    from retrocapture_tpu_torch.graph.kernels import _xbr_planes

    gathers = (cols, dict(zip((-2, -1, 0, 1, 2), rows)))
    return torch.stack([_xbr_planes(t, gathers, eq_thr, lv2_cf, small, y_weight, quantized) for t in tex])


@torch.library.custom_op("rctpu::xbr_front", mutates_args=(), device_types="cuda")
def _xbr_front_op(tex: torch.Tensor, cols: torch.Tensor, r_m2: torch.Tensor, r_m1: torch.Tensor,
                  r_0: torch.Tensor, r_p1: torch.Tensor, r_p2: torch.Tensor, eq_thr: float, lv2_cf: float,
                  small: float, y_weight: float, quantized: bool) -> torch.Tensor:
    """``tex [B, H, W, >=3]`` f32 and the gathers → ``S [B, 19, OH, W]``:
    the kernel on a card."""
    from retrocapture_tpu_torch.ops.cuda._build import load

    global LAUNCHES
    b, h, w, _ = tex.shape
    oh = r_0.shape[0]
    out = torch.empty((b, _NCH, oh, w), dtype=torch.float32, device=tex.device)
    if out.numel() == 0:
        return out
    tile_px, rows = tile_plan(w)
    consts = _constants(eq_thr, lv2_cf, y_weight)
    index = [x.contiguous() for x in (cols, r_m2, r_m1, r_0, r_p1, r_p2)]
    rc = load("xbr_front")(
        tex.data_ptr(), *tex.stride(), *(x.data_ptr() for x in index), consts.ctypes.data, out.data_ptr(),
        b, h, w, oh, tile_px, rows, int(not small < 0.5), int(quantized),
        torch.cuda.current_stream(tex.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"xbr_front kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


@_xbr_front_op.register_kernel("cpu")
def _xbr_front_cpu(tex, cols, r_m2, r_m1, r_0, r_p1, r_p2, eq_thr, lv2_cf, small, y_weight, quantized):
    return xbr_front_plain(tex, cols, (r_m2, r_m1, r_0, r_p1, r_p2), eq_thr, lv2_cf, small, y_weight, quantized)


@_xbr_front_op.register_fake
def _xbr_front_fake(tex, cols, r_m2, r_m1, r_0, r_p1, r_p2, *params):
    return tex.new_empty((tex.shape[0], _NCH, r_0.shape[0], tex.shape[2]))


@_xbr_front_op.register_vmap
def _xbr_front_vmap(info, in_dims, tex, *args):
    td = in_dims[0]
    gathers, params = args[:6], args[6:]
    if all(d is None for d in in_dims[1:7]):
        # One geometry for the batch: its textures in one launch.
        t = tex.movedim(td, 0)
        out = _xbr_front_op(t.reshape((-1,) + tuple(t.shape[2:])), *gathers, *params)
        return out.reshape(tuple(t.shape[:2]) + tuple(out.shape[1:])), 0
    outs = [
        _xbr_front_op(*(x if d is None else x.select(d, i) for x, d in zip((tex,) + gathers, in_dims)), *params)
        for i in range(info.batch_size)
    ]
    return torch.stack(outs), 0


def xbr_front(tex, gathers, eq_thr, lv2_cf, small, y_weight, quantized: bool):
    """``tex [B, H, W, >=3]`` f32, ``gathers`` the index tensors of
    ``graph.kernels._xbr_gathers`` (``cols [W + 4]``, ``{-2..2: [OH]}``
    int64 row maps) on tex's device, the four parameters as scalars and
    whether the texture is on the k/255 grid → ``S [B, 19, OH, W]`` f32 on
    tex's device. A CUDA tensor launches the kernel; a CPU tensor takes
    the plain version."""
    if not isinstance(tex, torch.Tensor) or tex.dtype != torch.float32:
        raise TypeError(f"xbr_front: tex must be a float32 tensor, got {getattr(tex, 'dtype', type(tex))}")
    if tex.dim() != 4 or tex.shape[3] < 3:
        raise ValueError(f"xbr_front: tex must be [B, H, W, >=3], got {tuple(tex.shape)}")
    if tex.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"xbr_front: no kernel for device {tex.device}")
    cols, rows = gathers
    rows = tuple(rows[k] for k in (-2, -1, 0, 1, 2))
    oh = rows[2].shape[0]
    checks = [("cols", cols, tex.shape[2] + 4)] + [(f"rows[{k}]", r, oh) for k, r in zip(range(-2, 3), rows)]
    for name, ix, n in checks:
        if not isinstance(ix, torch.Tensor) or ix.dtype != torch.int64 or ix.dim() != 1 or ix.shape[0] != n:
            raise ValueError(f"xbr_front: {name} must be an int64 tensor [{n}], got "
                             f"{getattr(ix, 'dtype', type(ix))} {tuple(getattr(ix, 'shape', ()))}")
        if ix.device != tex.device:
            raise ValueError(f"xbr_front: {name} is on {ix.device}, tex on {tex.device}")
    return _xbr_front_op(tex, cols, *rows, float(eq_thr), float(lv2_cf), float(small), float(y_weight),
                         bool(quantized))
