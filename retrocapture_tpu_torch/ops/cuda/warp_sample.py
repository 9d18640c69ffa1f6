"""Warped texture() tap: the CUDA kernel and its plain version.

Replaces ``retrocapture_tpu/ops/pallas/warp_sample.py:warp_sample_pallas``.
Every ``texture()`` whose coordinates are not separable over the output
grid (every CRT-curvature shader) lands here. The kernel
(``csrc/warp_sample.cu``) is one thread per output pixel that computes its
taps once and samples every texture of the batch at them, reading at most
four texels a frame through L1, with the reference's gather index math bit
for bit; it has no texture-size limit. An RGBA texture (C = 4) at a
16-byte-aligned address takes float4 loads and stores; any other takes a
channel at a time, counted in ``general_launches()``.

``warp_sample`` launches the kernel for a CUDA tensor and takes the plain
version (``sampling.sample2d_gather``, the reference's gather path) only
for a CPU tensor. ``LAUNCHES`` counts kernel launches.

Both sit behind the operator ``rctpu::warp_sample`` (``torch.library``),
whose batching rule is the reference's ``custom_vmap`` rule
(warp_sample.py:225-248): under ``torch.func.vmap`` a batched texture
with coordinates shared by the batch is one launch over the whole batch;
any other combination launches once per frame (the reference's
``lax.map``).
"""

from __future__ import annotations

import torch

from retrocapture_tpu_torch.ops.sampling import sample2d_gather

__all__ = ["warp_sample", "warp_sample_plain", "general_launches", "LAUNCHES"]

LAUNCHES = 0
_GENERAL_LAUNCHES = 0

_MODE = {"clamp_to_edge": 0, "clamp_to_border": 1, "repeat": 2, "mirrored_repeat": 3}

warp_sample_plain = sample2d_gather


@torch.library.custom_op("rctpu::warp_sample", mutates_args=(), device_types="cuda")
def _warp_sample_op(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor, filter_linear: bool,
                    wrap_mode: str) -> torch.Tensor:
    """``tex [B, H, W, C]`` f32, ``u, v [HO, WO]`` f32 on tex's device →
    ``[B, HO, WO, C]``: the kernel on a card."""
    from retrocapture_tpu_torch.ops.cuda._build import load

    global LAUNCHES, _GENERAL_LAUNCHES
    t4 = tex.contiguous()
    uu, vv = u.contiguous(), v.contiguous()
    b, h, w, c = t4.shape
    ho, wo = u.shape
    out = torch.empty((b, ho, wo, c), dtype=torch.float32, device=t4.device)
    if out.numel() == 0:
        return out
    vec = c == 4 and t4.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    rc = load("warp_sample")(
        t4.data_ptr(), uu.data_ptr(), vv.data_ptr(), out.data_ptr(),
        b, h, w, c, ho * wo, int(bool(filter_linear)), _MODE[wrap_mode], int(vec),
        torch.cuda.current_stream(t4.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"warp_sample kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    _GENERAL_LAUNCHES += not vec
    return out


def general_launches(reset: bool = False) -> int:
    """The kernel launches since the last reset that took the channel-at-a-
    time path (C other than 4, or a texture not 16-byte aligned).
    ``reset`` zeroes the count."""
    global _GENERAL_LAUNCHES
    n = _GENERAL_LAUNCHES
    if reset:
        _GENERAL_LAUNCHES = 0
    return n


@_warp_sample_op.register_kernel("cpu")
def _warp_sample_cpu(tex, u, v, filter_linear, wrap_mode):
    return sample2d_gather(tex, u, v, filter_linear=filter_linear, wrap_mode=wrap_mode)


@_warp_sample_op.register_fake
def _warp_sample_fake(tex, u, v, filter_linear, wrap_mode):
    return tex.new_empty((tex.shape[0],) + tuple(u.shape) + (tex.shape[-1],))


@_warp_sample_op.register_vmap
def _warp_sample_vmap(info, in_dims, tex, u, v, filter_linear, wrap_mode):
    td, ud, vd = in_dims[:3]
    if ud is None and vd is None:
        # Shared coordinates: the batch's textures in one launch.
        t = tex.movedim(td, 0)
        out = _warp_sample_op(t.reshape((-1,) + tuple(t.shape[2:])), u, v, filter_linear, wrap_mode)
        return out.reshape(tuple(t.shape[:2]) + tuple(out.shape[1:])), 0
    outs = [
        _warp_sample_op(*(x if d is None else x.select(d, i) for x, d in ((tex, td), (u, ud), (v, vd))),
                        filter_linear, wrap_mode)
        for i in range(info.batch_size)
    ]
    return torch.stack(outs), 0


def warp_sample(tex, u, v, *, filter_linear: bool, wrap_mode: str = "clamp_to_edge"):
    """``tex [H, W, C]`` or ``[B, H, W, C]`` f32, ``u, v [HO, WO]`` f32
    normalized coords → ``[..., HO, WO, C]`` with GL semantics. A CUDA
    tensor launches the kernel; a CPU tensor takes the plain gather."""
    if tex.dtype != torch.float32:
        raise TypeError(f"warp_sample: tex must be float32, got {tex.dtype}")
    if tex.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"warp_sample: no kernel for device {tex.device}")
    squeeze = tex.dim() == 3
    t4 = tex[None] if squeeze else tex
    if t4.dim() != 4:
        raise ValueError(f"warp_sample: tex must be [H,W,C] or [B,H,W,C], got {tuple(tex.shape)}")
    if u.shape != v.shape or u.dim() != 2:
        raise ValueError(f"warp_sample: u, v must share one [HO, WO] shape, got {tuple(u.shape)}, {tuple(v.shape)}")
    uu = u.to(device=t4.device, dtype=torch.float32)
    vv = v.to(device=t4.device, dtype=torch.float32)
    out = _warp_sample_op(t4, uu, vv, bool(filter_linear), wrap_mode)
    return out[0] if squeeze else out
