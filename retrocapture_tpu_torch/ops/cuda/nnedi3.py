"""nnedi3's neural doubling pass: the CUDA kernel and its plain version.

Replaces no TPU kernel: the reference computes an nnedi3 pass
(``retrocapture_tpu/graph/kernels.py:_nnedi3_kernel``) as jnp code that XLA
fuses. The port's plain version is ``graph/kernels._nnedi3_plain`` (held to
the JAX engine in tests/test_torch_nnedi3.py): 32 tap planes of the
edge-clamped 8 x 4 window, the window's f64 sums, an f64 contraction with
the net, the ``expf32`` mirror, the softsign mix and the interleave, as eager
torch passes. The CUDA kernel (``csrc/nnedi3.cu``) reads the pass's input
once and writes its interleaved RGBA output ``[B, oh, ow, 4]`` f32 once. Its
predicted values are the plain version's bits but where a sum's order moves
an f32 rounding: the kernel sums in f64 in a fixed order, the plain
version's reductions and GEMM in theirs, and both round once to f32.

The net comes in as ``net``'s two arrays, kept on the device by the nnedi3
entry: ``wt`` f64 ``[2 nns, 32]`` and ``bias`` f32 ``[2 nns]``. The kernel's
form comes from the call: ``axis`` (0 doubles the rows, 1 the columns),
``comps`` (3 for the ``-rgb`` shaders, 1 for ``-luma``) and the net's nns,
each a template parameter of the kernel.

``nnedi3`` launches the kernel for a CUDA tensor through the operator
``rctpu::nnedi3``, whose batching rule launches once for a batch that shares
the net. A CPU tensor takes the plain version where it is called (inside a
batched walk, under the walk's vmap, as before the kernel); the operator's
CPU kernel is the plain version frame by frame. ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["nnedi3", "nnedi3_plain", "net", "NNS", "LAUNCHES"]

LAUNCHES = 0
NNS = (16, 32, 64)  # the neuron counts the kernel has a form for
_TAPS = 32


def net(w1, w2, b1, b2):
    """The kernel's net from ``_nnedi3_weights``' arrays (``W1``, ``W2 [32,
    nns]``, ``B1``, ``B2 [nns]`` f32): ``wt`` f64 ``[2 nns, 32]`` C-contiguous
    (row j < nns neuron j's sum1 weights, row nns + j its sum2 weights,
    column q = s*4 + c of the window) and ``bias`` f32 ``[2 nns]`` (b1, then
    b2), the layout the kernel stages in shared memory."""
    wt = np.ascontiguousarray(np.concatenate([w1, w2], axis=1).T, dtype=np.float64)
    return wt, np.concatenate([b1, b2]).astype(np.float32)


def _out_hw(h: int, w: int, axis: int):
    return (2 * h, w) if axis == 0 else (h, 2 * w)


def nnedi3_plain(tex, wt, bias, axis: int, comps: int):
    """Plain torch version on the operator's arguments: ``tex [..., h, w,
    C]`` f32 → ``[..., oh, ow, 4]`` f32, ``_nnedi3_plain`` frame by frame."""
    from retrocapture_tpu_torch.graph.kernels import _nnedi3_plain

    if tex.dim() == 3:
        return _nnedi3_plain(tex, wt, bias, axis, comps)
    frames = tex.reshape((-1,) + tuple(tex.shape[-3:]))
    out = torch.stack([_nnedi3_plain(f, wt, bias, axis, comps) for f in frames])
    return out.reshape(tuple(tex.shape[:-3]) + tuple(out.shape[1:]))


@torch.library.custom_op("rctpu::nnedi3", mutates_args=(), device_types="cuda")
def _nnedi3_op(tex: torch.Tensor, wt: torch.Tensor, bias: torch.Tensor, axis: int, comps: int) -> torch.Tensor:
    """``tex [..., h, w, C]`` → ``[..., oh, ow, 4]``: the kernel on a card."""
    from retrocapture_tpu_torch.ops.cuda._build import load

    global LAUNCHES
    h, w, c = (int(d) for d in tex.shape[-3:])
    oh, ow = _out_hw(h, w, axis)
    out = torch.empty(tuple(tex.shape[:-3]) + (oh, ow, 4), dtype=torch.float32, device=tex.device)
    if out.numel() == 0:
        return out
    frames = tex.reshape(-1, h, w, c)  # a view where the strides allow
    wt, bias = wt.contiguous(), bias.contiguous()
    rc = load("nnedi3")(frames.data_ptr(), *frames.stride(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(),
                        frames.shape[0], h, w, axis, comps, wt.shape[0] // 2,
                        torch.cuda.current_stream(tex.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nnedi3 kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


@_nnedi3_op.register_kernel("cpu")
def _nnedi3_cpu(tex, wt, bias, axis, comps):
    return nnedi3_plain(tex, wt, bias, axis, comps)


@_nnedi3_op.register_fake
def _nnedi3_fake(tex, wt, bias, axis, comps):
    return tex.new_empty(tuple(tex.shape[:-3]) + _out_hw(tex.shape[-3], tex.shape[-2], axis) + (4,))


@_nnedi3_op.register_vmap
def _nnedi3_vmap(info, in_dims, tex, wt, bias, axis, comps):
    if in_dims[1] is None and in_dims[2] is None:
        # One net for the batch (so the frames are what is batched): one launch.
        return _nnedi3_op(tex.movedim(in_dims[0], 0), wt, bias, axis, comps), 0
    outs = [
        _nnedi3_op(*(x if d is None else x.select(d, i) for x, d in zip((tex, wt, bias), in_dims[:3])), axis, comps)
        for i in range(info.batch_size)
    ]
    return torch.stack(outs), 0


def _check(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor) or x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"nnedi3: {name} must be a {dtype} tensor {list(shape)}, got "
                         f"{getattr(x, 'dtype', type(x))} {tuple(getattr(x, 'shape', ()))}")
    if x.device != device:
        raise ValueError(f"nnedi3: {name} is on {x.device}, tex on {device}")


def nnedi3(tex, wt, bias, *, axis: int, comps: int):
    """One nnedi3 pass: ``tex [(B,) h, w, C]`` f32 (C >= ``comps``), the net
    ``wt`` f64 ``[2 nns, 32]`` and ``bias`` f32 ``[2 nns]`` (``net``) on tex's
    device, ``axis`` 0 (double the rows) or 1 (the columns), ``comps`` 3 or 1
    → RGBA ``[(B,) oh, ow, 4]`` f32: the source texels and the predicted ones
    interleaved along the doubled axis, channels ``comps``..3 at 1. A CUDA
    tensor launches the kernel through the operator. A CPU tensor takes the
    plain version where it is called, so that a batched walk on the CPU runs
    it under the walk's vmap, the route the parity tests against the JAX
    engine hold."""
    if not isinstance(tex, torch.Tensor) or tex.dtype != torch.float32:
        raise TypeError(f"nnedi3: tex must be a float32 tensor, got {getattr(tex, 'dtype', type(tex))}")
    dev = tex.device
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"nnedi3: no kernel for device {dev}")
    if axis not in (0, 1) or comps not in (1, 3):
        raise ValueError(f"nnedi3: axis must be 0 or 1 and comps 1 or 3, got {axis}, {comps}")
    if tex.dim() not in (3, 4) or tex.shape[-1] < comps:
        raise ValueError(f"nnedi3: tex must be [h, w, >={comps}] or [B, h, w, >={comps}], got {tuple(tex.shape)}")
    nns = getattr(bias, "shape", (0,))[0] // 2
    if nns not in NNS:
        raise ValueError(f"nnedi3: the net must have {' or '.join(map(str, NNS))} neurons, got "
                         f"{tuple(getattr(bias, 'shape', ()))} biases")
    _check("wt", wt, torch.float64, (2 * nns, _TAPS), dev)
    _check("bias", bias, torch.float32, (2 * nns,), dev)
    if dev.type == "cpu":
        return nnedi3_plain(tex, wt, bias, axis, comps)
    return _nnedi3_op(tex, wt, bias, axis, comps)
