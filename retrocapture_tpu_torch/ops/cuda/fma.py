"""The contracted multiply-adds of the reference's jitted fusions: one CUDA
operator and its plain versions.

XLA's CPU code contracts ``a*b + c`` inside a fusion. The port models that
as ``policy.fma32`` (the f32 product exact in f64, one f64 add, narrowed
once) and, where the reference's gather or dot executes a true FMA, as
``policy.fmaf32`` (one rounding). In eager torch those are several full
passes over the broadcast shape, in f64 at twice the bytes; the kernel
(``csrc/fma.cu``: policy's f64 formula or ``__fmaf_rn``) reads
each operand once and writes one f32 result. It replaces no TPU kernel.

``fma32`` and ``fmaf32`` take what ``policy``'s take: f32 tensors whose
shapes broadcast against each other, 0-d tensors among them (traced
parameters, FrameCount), and Python or numpy scalars, rounded to f32 here
as ``policy`` rounds them. At least one operand is a tensor, and every
tensor operand lies on one device. A CUDA tensor launches the kernel; a CPU
tensor takes the plain version. The kernel reads a broadcast operand
through its strides and a 0-d tensor from device memory when it runs, so
a CUDA graph's replay reads the 0-d buffer's value of its time. Anything
else (another dtype, a CPU tensor beside CUDA operands) raises a
``TypeError``.

Two routes reach the kernel, both through ``_fma_call``. A plain call on
CUDA tensors launches it directly (``_launch``), since the ``torch.library``
dispatcher costs more host time than the launch. Under a functorch
transform, a dispatch mode (fake or proxy tensors), ``torch.compile``, or
on the CPU, the call goes through the operator ``rctpu::fma``, whose
batching rule applies it to the whole batch (one launch for a batched
walk) and whose fake kernel gives the result's shape. ``_launch`` takes
its plan of the launch (the broadcast shape, the path, the merged
geometry) from a cache keyed by the operands' shapes and strides.
``LAUNCHES`` counts kernel launches, ``general_launches()`` those that took
the kernel's general path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from retrocapture_tpu_torch import policy
from retrocapture_tpu_torch.ops.cuda import _build

__all__ = ["fma32", "fmaf32", "fma_plain", "general_launches", "LAUNCHES"]

LAUNCHES = 0
_GENERAL_LAUNCHES = 0

# The kernel's most dimensions after merging and its most elements.
_MAX_DIMS = 8
_MAX_NUMEL = 2**31 - 1

# The kernel's paths and operand kinds (csrc/fma.cu), and its tile: 32
# pixels of up to 4 channels.
DENSE, TILE, GENERAL = 0, 1, 2
VALUE, SCALAR, DENSE_OP, STRIDED, ROW, COL, LINE, GATHER, TILE_OP = range(9)
PATH_NAMES = ("dense", "tile", "general")
KIND_NAMES = ("value", "scalar", "dense", "strided", "row", "column", "line", "gather", "transposed")
_TILE_PX = 32
_TILE_C = 4
_MAX_BATCH = 65535  # a grid row each
_MAX_TILES = 2  # transposed operands a tile launch stages
_MAX_OFFSET = 2**31  # the tile path's offsets are 32-bit

# The raw current-stream query of CUDA builds of torch (absent from CPU
# builds, where no launch gets that far).
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def fma_plain(a, b, c, mode: int) -> torch.Tensor:
    """The plain version of mode ``mode`` (0 ``fma32``, 1 ``fmaf32``): the
    ``policy`` function."""
    return (policy.fma32 if mode == 0 else policy.fmaf32)(a, b, c)


def general_launches(reset: bool = False) -> int:
    """The kernel launches since the last reset that took the general path
    (a form outside the dense and tile paths). ``reset`` zeroes the
    count."""
    global _GENERAL_LAUNCHES
    n = _GENERAL_LAUNCHES
    if reset:
        _GENERAL_LAUNCHES = 0
    return n


def _geometry(shape, tensors):
    """The result's dimensions with size-1 ones dropped and neighbours merged
    where every operand allows, and each operand's element strides over
    them (0 where broadcast; all 0 for a missing operand)."""
    nd = len(shape)
    full = []
    for t in tensors:
        st = [0] * nd
        if t is not None:
            off = nd - t.dim()
            for j in range(t.dim()):
                if t.shape[j] != 1:
                    st[off + j] = t.stride(j)
        full.append(st)
    sizes, strides = [], [[], [], []]
    for j in range(nd):
        if shape[j] == 1:
            continue
        if sizes and all(s[-1] == f[j] * shape[j] for s, f in zip(strides, full)):
            sizes[-1] *= shape[j]
            for s, f in zip(strides, full):
                s[-1] = f[j]
        else:
            sizes.append(shape[j])
            for s, f in zip(strides, full):
                s.append(f[j])
    return sizes, strides


def _plane_dims(sizes, strides):
    """A merged geometry of 1 to 3 dimensions as [R, Q, C] (rows, pixels,
    C <= 4 channels) and each operand's (row, pixel, channel) strides, or
    None. A flat result folds into rows of 32 four-channel pixels, a narrow
    one ([R, N <= 4]) into rows of 32 pixels of N channels, a wide one
    splits its rows into four-channel pixels where every operand reads its
    rows contiguously or not at all; [R, Q, C <= 4] stays."""
    d = len(sizes)
    if d == 1:
        (n,) = sizes
        r = -(-n // (_TILE_PX * _TILE_C))
        return (r, _TILE_PX, _TILE_C), [(s * _TILE_PX * _TILE_C, s * _TILE_C, s) for (s,) in strides]
    if d == 2:
        r, n = sizes
        if n <= _TILE_C:
            return (-(-r // _TILE_PX), _TILE_PX, n), [(sr * _TILE_PX, sr, sn) for sr, sn in strides]
        if n % _TILE_C == 0 and all(sn in (0, 1) for _, sn in strides):
            return (r, n // _TILE_C, _TILE_C), [(sr, sn * _TILE_C, sn) for sr, sn in strides]
        return (r, n, 1), [(sr, sn, 0) for sr, sn in strides]
    if d == 3 and sizes[2] <= _TILE_C:
        return tuple(sizes), [tuple(st) for st in strides]
    return None


def _tile_dims(sizes, strides):
    """The merged geometry as the tile path's [B, R, Q, C] and each operand's
    (batch, row, pixel, channel) strides, or None: a plane of
    ``_plane_dims`` (B = 1), or a batch in front of one that does not
    merge with it (a stream's frames, under ``apply_streams``'s vmap):
    [B, R, Q, C <= 4] or [B, R, N > 4]."""
    d = len(sizes)
    if d == 4 and sizes[3] <= _TILE_C or d == 3 and sizes[2] > _TILE_C:
        if sizes[0] > _MAX_BATCH:
            return None
        plane = _plane_dims(sizes[1:], [st[1:] for st in strides])
        return (sizes[0],) + plane[0], [(st[0],) + s for st, s in zip(strides, plane[1])]
    plane = _plane_dims(sizes, strides)
    if plane is None:
        return None
    return (1,) + plane[0], [(0,) + s for s in plane[1]]


def _tile_kind(dims, st):
    """The tile path's kind of a tensor operand with strides ``st`` over
    ``dims``: a column (the same in every row), a line (each pixel's
    channels at r * sr + q * C), a row (one value a row), a transposed operand
    (its pixels' rows contiguous), or a gather."""
    c = dims[3]
    _, sr, sq, sc = st
    if sr == 0:
        return COL
    if sq == c and (sc == 1 or c == 1):
        return LINE
    if sq == 0 and (sc == 0 or c == 1):
        return ROW
    if sr == c and (sc == 1 or c == 1):
        return TILE_OP
    return GATHER


def _classify(sizes, strides, present):
    """The kernel's path for a merged geometry (``_geometry``) and which
    operands are tensors: (path, dims, kinds, strides over dims). Dense
    where every tensor operand is laid out as the result (one dimension
    after merging) or is one value; the tile path where the result fits
    [B, R, Q, C <= 4] with 32-bit offsets and at most two transposed
    operands; else the general path. A pure function of shapes and
    strides."""
    scalar = [not p or all(s == 0 for s in st) for p, st in zip(present, strides)]
    base = [VALUE if not p else SCALAR for p in present]
    n = int(np.prod(sizes)) if sizes else 1
    if len(sizes) <= 1 and all(sc or st == [1] for sc, st in zip(scalar, strides)):
        kinds = [b if sc else DENSE_OP for b, sc in zip(base, scalar)]
        return DENSE, [n], kinds, [[0 if sc else 1] for sc in scalar]
    small = all(sum((z - 1) * s for z, s in zip(sizes, st)) < _MAX_OFFSET for st in strides)
    tile = _tile_dims(sizes, strides) if small else None
    if tile is not None:
        dims, st3 = tile
        kinds = [b if sc else _tile_kind(dims, st) for b, sc, st in zip(base, scalar, st3)]
        if kinds.count(TILE_OP) <= _MAX_TILES:
            return TILE, list(dims), kinds, [list(s) for s in st3]
    kinds = [b if sc else STRIDED for b, sc in zip(base, scalar)]
    return GENERAL, list(sizes), kinds, [list(st) for st in strides]


class _Plan(NamedTuple):
    shape: torch.Size  # the result's
    numel: int
    path: int
    geometry: object  # the kernel's geometry argument, a ctypes array


_PLANS: dict = {}
_MAX_PLANS = 4096


def _plan(tensors) -> _Plan:
    """The launch plan of operands of these shapes and strides (None: a host
    value), from the cache or made and kept."""
    key = tuple(None if t is None else (t.shape, t.stride()) for t in tensors)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    shape = torch.broadcast_shapes(*(t.shape for t in tensors if t is not None))
    numel = shape.numel()
    if numel > _MAX_NUMEL:
        raise ValueError(f"fma: {numel} elements, the kernel takes at most {_MAX_NUMEL}")
    sizes, strides = _geometry(tuple(shape), tensors)
    if len(sizes) > _MAX_DIMS:
        raise ValueError(f"fma: {len(sizes)} dimensions after merging, the kernel takes at most {_MAX_DIMS}")
    path, dims, kinds, st = _classify(sizes, strides, [t is not None for t in tensors])
    geometry = (ctypes.c_longlong * (5 + 4 * len(dims)))(numel, len(dims), *dims, *kinds, *st[0], *st[1], *st[2])
    if len(_PLANS) >= _MAX_PLANS:
        _PLANS.clear()
    plan = _PLANS[key] = _Plan(shape, numel, path, geometry)
    return plan


def _launch(a, b, c, sa: float, sb: float, sc: float, mode: int) -> torch.Tensor:
    """The kernel on the operands' card: no fallback, it raises where it
    cannot build or launch."""
    global LAUNCHES, _GENERAL_LAUNCHES
    plan = _plan((a, b, c))
    t = a if a is not None else b if b is not None else c
    out = torch.empty(plan.shape, dtype=torch.float32, device=t.device)
    if plan.numel == 0:
        return out
    fn = _build._ENTRIES.get("fma") or _build.load("fma")
    stream = _raw_stream(t.get_device()) if _raw_stream is not None else torch.cuda.current_stream(t.device).cuda_stream
    rc = fn(None if a is None else a.data_ptr(), None if b is None else b.data_ptr(),
            None if c is None else c.data_ptr(), sa, sb, sc, out.data_ptr(), plan.path, plan.geometry, mode, stream)
    if rc != 0:
        raise RuntimeError(f"fma kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    _GENERAL_LAUNCHES += plan.path == GENERAL
    return out


@torch.library.custom_op("rctpu::fma", mutates_args=(), device_types="cuda")
def _fma_op(a: Optional[torch.Tensor], b: Optional[torch.Tensor], c: Optional[torch.Tensor], sa: float, sb: float,
            sc: float, mode: int) -> torch.Tensor:
    """``a*b + c`` over f32 tensors (``None``: the f32 value ``sa``, ``sb``
    or ``sc``) that broadcast together → a contiguous f32 tensor of the
    broadcast shape: the kernel on a card."""
    return _launch(a, b, c, sa, sb, sc, mode)


@_fma_op.register_kernel("cpu")
def _fma_cpu(a, b, c, sa, sb, sc, mode):
    return fma_plain(sa if a is None else a, sb if b is None else b, sc if c is None else c, mode)


@_fma_op.register_fake
def _fma_fake(a, b, c, sa, sb, sc, mode):
    tensors = [t for t in (a, b, c) if t is not None]
    return tensors[0].new_empty(torch.broadcast_shapes(*(t.shape for t in tensors)), dtype=torch.float32)


@_fma_op.register_vmap
def _fma_vmap(info, in_dims, a, b, c, sa, sb, sc, mode):
    # Elementwise: the whole batch in one launch. Each batched operand's
    # batch dimension goes to the front, followed by size-1 dimensions up
    # to the result's logical rank, so that the batch never lines up with
    # a logical dimension of another operand ([B, 3] against [H, W, 3]
    # becomes [B, 1, 1, 3]).
    tensors = (a, b, c)
    dims = in_dims[:3]
    rank = max(t.dim() - (d is not None) for t, d in zip(tensors, dims) if t is not None)
    moved = []
    for t, d in zip(tensors, dims):
        if t is not None and d is not None:
            t = t.movedim(d, 0)
            t = t[(slice(None),) + (None,) * (rank + 1 - t.dim())]
        moved.append(t)
    return _fma_call(*moved, sa, sb, sc, mode), 0


def _direct(tensors) -> bool:
    """Whether a call may launch the kernel without the dispatcher: no
    functorch transform active, no dispatch mode on the stack (fake or
    proxy tensors), not compiling, and every tensor operand on a card."""
    return (not torch._C._are_functorch_transforms_active() and not torch._C._len_torch_dispatch_stack()
            and not torch.compiler.is_compiling() and all(t is None or t.is_cuda for t in tensors))


def _fma_call(a, b, c, sa: float, sb: float, sc: float, mode: int) -> torch.Tensor:
    """Both routes to the kernel: directly on a plain call, else through
    the operator. The one function that a recorder of the launches wraps."""
    if _direct((a, b, c)):
        return _launch(a, b, c, sa, sb, sc, mode)
    return _fma_op(a, b, c, sa, sb, sc, mode)


def _operand(x, name: str):
    """(tensor or None, f32 value as a float) of one operand."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.float32:
            raise TypeError(f"fma: {name} must be a float32 tensor or a scalar, got a {x.dtype} tensor")
        return x, 0.0
    if isinstance(x, (bool, int, float, np.generic)) or (isinstance(x, np.ndarray) and x.ndim == 0):
        return None, float(np.float32(x))
    raise TypeError(f"fma: {name} must be a float32 tensor or a scalar, got {type(x).__name__}")


def _fma(a, b, c, mode: int) -> torch.Tensor:
    (ta, sa), (tb, sb), (tc, sc) = _operand(a, "a"), _operand(b, "b"), _operand(c, "c")
    tensors = [t for t in (ta, tb, tc) if t is not None]
    if not tensors:
        raise TypeError("fma: at least one operand must be a tensor")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise TypeError(f"fma: operands on {sorted({str(t.device) for t in tensors})}; all must share one device")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"fma: no kernel for device {dev}")
    return _fma_call(ta, tb, tc, sa, sb, sc, mode)


def fma32(a, b, c) -> torch.Tensor:
    """``a*b + c`` rounded once to f32 through an f64 sum
    (``policy.fma32``)."""
    return _fma(a, b, c, 0)


def fmaf32(a, b, c) -> torch.Tensor:
    """``a*b + c`` as an f32 fused multiply-add (``policy.fmaf32``)."""
    return _fma(a, b, c, 1)
