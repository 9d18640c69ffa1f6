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
``TypeError``. Both sit behind the operator ``rctpu::fma``
(``torch.library``), whose batching rule applies it to the whole batch:
one launch for a batched walk. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from retrocapture_tpu_torch import policy

__all__ = ["fma32", "fmaf32", "fma_plain", "LAUNCHES"]

LAUNCHES = 0

# The kernel's modes (csrc/fma.cu), its most dimensions after merging and
# its most elements.
_MODES = {"fma32": 0, "fmaf32": 1}
_MAX_DIMS = 8
_MAX_NUMEL = 2**31 - 1


def fma_plain(a, b, c, mode: int) -> torch.Tensor:
    """The plain version of mode ``mode`` (0 ``fma32``, 1 ``fmaf32``): the
    ``policy`` function."""
    return (policy.fma32 if mode == 0 else policy.fmaf32)(a, b, c)


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


def _launch(a, b, c, sa: float, sb: float, sc: float, mode: int) -> torch.Tensor:
    """The kernel on the operands' card: no fallback, it raises where it
    cannot build or launch."""
    from retrocapture_tpu_torch.ops.cuda._build import load

    global LAUNCHES
    tensors = (a, b, c)
    dev = next(t.device for t in tensors if t is not None)
    shape = torch.broadcast_shapes(*(t.shape for t in tensors if t is not None))
    if shape.numel() > _MAX_NUMEL:
        raise ValueError(f"fma: {shape.numel()} elements, the kernel takes at most {_MAX_NUMEL}")
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    sizes, strides = _geometry(tuple(shape), tensors)
    if len(sizes) > _MAX_DIMS:
        raise ValueError(f"fma: {len(sizes)} dimensions after merging, the kernel takes at most {_MAX_DIMS}")
    geometry = (ctypes.c_longlong * (4 * len(sizes)))(*sizes, *strides[0], *strides[1], *strides[2])
    rc = load("fma")(
        *(None if t is None else t.data_ptr() for t in tensors), sa, sb, sc, out.data_ptr(),
        len(sizes), geometry, mode, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fma kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
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
    return _fma_op(*moved, sa, sb, sc, mode), 0


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
    ops = [_operand(x, n) for x, n in ((a, "a"), (b, "b"), (c, "c"))]
    tensors = [t for t, _ in ops if t is not None]
    if not tensors:
        raise TypeError("fma: at least one operand must be a tensor")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise TypeError(f"fma: operands on {sorted({str(t.device) for t in tensors})}; all must share one device")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"fma: no kernel for device {dev}")
    return _fma_op(ops[0][0], ops[1][0], ops[2][0], ops[0][1], ops[1][1], ops[2][1], mode)


def fma32(a, b, c) -> torch.Tensor:
    """``a*b + c`` rounded once to f32 through an f64 sum
    (``policy.fma32``)."""
    return _fma(a, b, c, _MODES["fma32"])


def fmaf32(a, b, c) -> torch.Tensor:
    """``a*b + c`` as an f32 fused multiply-add (``policy.fmaf32``)."""
    return _fma(a, b, c, _MODES["fmaf32"])
