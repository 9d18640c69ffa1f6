"""crt-mattias's epilogue: the CUDA kernel and its plain version.

Replaces no TPU kernel: the reference computes the tail of crt-mattias.glsl
(``retrocapture_tpu/graph/kernels.py:_mattias_kernel``) as jnp code that
XLA fuses. The port's plain version is ``graph/kernels._mattias_epilogue_plain``
(held to the JAX engine in tests/test_torch_mattias.py): the blur's three
planes through the contrast, vignette, tint and saturation, the scanline
and its pow, the flicker, the comb mask, the three hashes, the output pow
and the inside test, to RGBA, as eager torch passes, rctpu::fma and the
mirrors. The CUDA kernel (``csrc/mattias_epilogue.cu``) reads the planes
where the blur wrote them, the six per-pixel maps once a batch, and writes
RGBA ``[B, OH, OW, 4]`` f32 once, bit-equal to the plain version.

The maps are those that ``_mattias_warp`` and ``_mattias_geometry`` build:
``bv``, ``uv_u``, ``uv_v [OH, OW]`` and ``vig``, ``comb``, ``inside [OH,
OW, 1]``. FrameCount is the f32 ``fcf`` (0-d, or one a frame), read on the
device. The kernel's branch comes from the call: a traced SCANSPEED (an f32
0-d device tensor) is read on the device when the kernel runs, a constant
one folded into the constants on the host.

``mattias_epilogue`` launches the kernel for a CUDA tensor through the
operator ``rctpu::mattias_epilogue``, whose batching rule launches once
for a batch whose maps are shared, and once a frame otherwise. A CPU
tensor takes the plain version where it is called (inside a batched walk,
under the walk's vmap, as before the kernel); the operator's CPU kernel is
the plain version frame by frame. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["mattias_epilogue", "mattias_epilogue_plain", "LAUNCHES"]

LAUNCHES = 0

_F = np.float32
_MAPS = ("bv", "uv_u", "uv_v", "vig", "comb", "inside")


def _constants(oh: int, scanspeed: Optional[float]):
    """The kernel's constants (``csrc/mattias_epilogue.cu``'s ``Narrow`` and
    ``Wide``, in order) as an f32 and an f64 array, each the f32 value the
    plain version uses: a Python scalar as torch and ``fma32`` round it, a
    folded product as numpy rounds it. ``Wide`` holds the multiply-adds'
    constant factors and addends, widened here. ``scanspeed`` is a
    constant SCANSPEED, or None for a traced one."""
    from retrocapture_tpu_torch.graph.kernels import _MATTIAS_GROUPS

    posts = [0.0, 0.0, 0.0]
    for ch, *_, post in _MATTIAS_GROUPS:
        posts[ch] += post
    t60 = _F(1.0) / _F(60.0)

    def folded_pow(p):  # graph/kernels._glsl_pow's constant
        return _F(_F(_F(p) * _F(1.0 / np.log(2.0))) * _F(np.log(2.0)))

    scan_k = _F(0.0) if scanspeed is None else _F(_F(t60 * _F(scanspeed)) * _F(3.5))
    narrow = [
        *posts, 0.95, 1.05, 0.95, 0.0, 0.3, 0.5,  # post, tint, off
        0.6, folded_pow(0.9), folded_pow(0.45), t60, 3.5, scan_k, 3.8,  # k06, c09, c045, t60, k35, scan_k, k38
        _F(300.0) * t60, 0.0015, _F(t60 * _F(0.0001)),  # flick_k, k0015, drift_k
        _F(78.233), _F(1.0) / _F(3.14), _F(43758.5453),  # k78233, inv314, k43758
    ]
    wide = [0.4, 0.3, _F(_F(oh) * _F(1.5)), 0.15, 0.35, 12.9898, -3.14, -0.25]  # k04 .. km025
    return (np.array([_F(v) for v in narrow], np.float32),
            np.array([_F(v) for v in wide], np.float32).astype(np.float64))


def mattias_epilogue_plain(p0, p1, p2, bv, uv_u, uv_v, vig, comb, inside, fcf, scanspeed_t, scanspeed: float):
    """Plain torch version on the operator's arguments: planes ``[(B,) OH,
    OW]`` f32, the maps, ``fcf`` f32 0-d or ``[B]`` (one a frame), a traced
    SCANSPEED's 0-d tensor or None and a constant one → ``[(B,) OH, OW,
    4]`` f32: ``_mattias_epilogue_plain`` frame by frame."""
    from retrocapture_tpu_torch.graph.kernels import _mattias_epilogue_plain

    oh, ow = bv.shape
    ss = scanspeed_t if scanspeed_t is not None else _F(scanspeed)

    def one(q0, q1, q2, f):
        return _mattias_epilogue_plain({0: q0, 1: q1, 2: q2}, bv, uv_u, uv_v, vig, comb, inside, f, ss, oh, ow)

    if p0.dim() == 2:
        return one(p0, p1, p2, fcf)
    return torch.stack([one(p0[i], p1[i], p2[i], fcf[i] if fcf.dim() else fcf) for i in range(p0.shape[0])])


@torch.library.custom_op("rctpu::mattias_epilogue", mutates_args=(), device_types="cuda")
def _mattias_epilogue_op(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor, bv: torch.Tensor,
                         uv_u: torch.Tensor, uv_v: torch.Tensor, vig: torch.Tensor, comb: torch.Tensor,
                         inside: torch.Tensor, fcf: torch.Tensor, scanspeed_t: Optional[torch.Tensor],
                         scanspeed: float) -> torch.Tensor:
    """The planes ``[(B,) OH, OW]`` and the maps → RGBA ``[(B,) OH, OW, 4]``:
    the kernel on a card."""
    from retrocapture_tpu_torch.ops.cuda._build import load

    global LAUNCHES
    oh, ow = bv.shape
    lead = tuple(p0.shape[:-2])
    out = torch.empty(lead + (oh, ow, 4), dtype=torch.float32, device=p0.device)
    if out.numel() == 0:
        return out
    # A frame's plane is read contiguous, the frames through the batch
    # stride (0 for a plane every frame shares).
    planes = [p if (p[0] if lead else p).is_contiguous() else p.contiguous() for p in (p0, p1, p2)]
    strides = [p.stride(0) if lead else 0 for p in planes]
    maps = [x.contiguous() for x in (bv, uv_u, uv_v, vig, comb, inside, fcf)]
    narrow, wide = _constants(oh, None if scanspeed_t is not None else scanspeed)
    rc = load("mattias_epilogue")(
        *(p.data_ptr() for p in planes), *strides, *(m.data_ptr() for m in maps), int(fcf.dim() > 0),
        None if scanspeed_t is None else scanspeed_t.data_ptr(), narrow.ctypes.data, narrow.size, wide.ctypes.data,
        wide.size, out.data_ptr(), lead[0] if lead else 1, oh * ow,
        torch.cuda.current_stream(p0.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"mattias_epilogue kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


@_mattias_epilogue_op.register_kernel("cpu")
def _mattias_epilogue_cpu(p0, p1, p2, bv, uv_u, uv_v, vig, comb, inside, fcf, scanspeed_t, scanspeed):
    return mattias_epilogue_plain(p0, p1, p2, bv, uv_u, uv_v, vig, comb, inside, fcf, scanspeed_t, scanspeed)


@_mattias_epilogue_op.register_fake
def _mattias_epilogue_fake(p0, p1, p2, bv, *args):
    return p0.new_empty(tuple(p0.shape[:-2]) + tuple(bv.shape) + (4,))


@_mattias_epilogue_op.register_vmap
def _mattias_epilogue_vmap(info, in_dims, p0, p1, p2, bv, uv_u, uv_v, vig, comb, inside, fcf, scanspeed_t,
                           scanspeed):
    n = info.batch_size
    if all(d is None for d in in_dims[3:9]) and in_dims[10] is None:
        # The maps shared by the batch: its planes and FrameCounts in one
        # launch. A plane or a FrameCount that every frame shares is read
        # with a stride of 0.
        planes = [p.movedim(d, 0) if d is not None else p.expand((n,) + tuple(p.shape))
                  for p, d in zip((p0, p1, p2), in_dims[:3])]
        lead = tuple(planes[0].shape[:-2])
        f = fcf
        if in_dims[9] is not None:  # a FrameCount a frame of this level, broadcast over the planes' own frames
            f = fcf.movedim(in_dims[9], 0)
            f = f.reshape(tuple(f.shape) + (1,) * (len(lead) - f.dim()))
        if f.dim() or len(lead) > 1:
            f = f.expand(lead).reshape(-1)
        flat = [p.reshape((-1,) + tuple(p.shape[-2:])) for p in planes]
        out = _mattias_epilogue_op(*flat, bv, uv_u, uv_v, vig, comb, inside, f, scanspeed_t, scanspeed)
        return out.reshape(lead + tuple(out.shape[1:])), 0
    args = (p0, p1, p2, bv, uv_u, uv_v, vig, comb, inside, fcf, scanspeed_t)
    outs = [
        _mattias_epilogue_op(*(x if d is None else x.select(d, i) for x, d in zip(args, in_dims)), scanspeed)
        for i in range(n)
    ]
    return torch.stack(outs), 0


def _check(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor) or x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"mattias_epilogue: {name} must be a {dtype} tensor {list(shape)}, got "
                         f"{getattr(x, 'dtype', type(x))} {tuple(getattr(x, 'shape', ()))}")
    if x.device != device:
        raise ValueError(f"mattias_epilogue: {name} is on {x.device}, the planes on {device}")


def mattias_epilogue(planes, bv, uv_u, uv_v, vig, comb, inside, fcf, scanspeed):
    """crt-mattias's epilogue: ``planes`` the blur's ``{channel: [(B,) OH,
    OW]}`` f32 for channels 0-2, the maps of ``_mattias_warp`` and
    ``_mattias_geometry`` (``bv``, ``uv_u``, ``uv_v [OH, OW]`` f32; ``vig``,
    ``comb [OH, OW, 1]`` f32; ``inside [OH, OW, 1]`` bool), ``fcf`` the f32
    FrameCount (0-d, or ``[B]``) and ``scanspeed`` SCANSPEED (a constant, or
    a traced parameter's f32 0-d tensor), all on one device → RGBA ``[(B,)
    OH, OW, 4]`` f32. A CUDA tensor launches the kernel through the
    operator. A CPU tensor takes the plain version where it is called, so
    that a batched walk on the CPU runs it under the walk's vmap, the route
    the parity tests against the JAX engine hold."""
    p0, p1, p2 = (planes[ch] for ch in range(3))
    if not isinstance(p0, torch.Tensor) or p0.dtype != torch.float32:
        raise TypeError(f"mattias_epilogue: the planes must be float32 tensors, got {getattr(p0, 'dtype', type(p0))}")
    dev = p0.device
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"mattias_epilogue: no kernel for device {dev}")
    if p0.dim() not in (2, 3):
        raise ValueError(f"mattias_epilogue: a plane must be [OH, OW] or [B, OH, OW], got {tuple(p0.shape)}")
    oh, ow = p0.shape[-2:]
    for ch, p in ((1, p1), (2, p2)):
        _check(f"planes[{ch}]", p, torch.float32, p0.shape, dev)
    for name, x in zip(_MAPS, (bv, uv_u, uv_v, vig, comb, inside)):
        _check(name, x, torch.bool if name == "inside" else torch.float32,
               (oh, ow) if name in ("bv", "uv_u", "uv_v") else (oh, ow, 1), dev)
    per_frame = p0.dim() == 3 and isinstance(fcf, torch.Tensor) and fcf.dim() > 0
    _check("fcf", fcf, torch.float32, p0.shape[:1] if per_frame else (), dev)
    traced = isinstance(scanspeed, torch.Tensor)
    if traced:
        _check("scanspeed", scanspeed, torch.float32, (), dev)
    args = (p0, p1, p2, bv, uv_u, uv_v, vig, comb, inside, fcf, scanspeed if traced else None,
            0.0 if traced else float(_F(scanspeed)))
    if dev.type == "cpu":
        return mattias_epilogue_plain(*args)
    return _mattias_epilogue_op(*args)
