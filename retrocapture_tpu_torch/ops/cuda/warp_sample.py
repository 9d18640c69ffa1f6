"""Warped texture() tap: the CUDA kernel and its plain version.

Replaces ``retrocapture_tpu/ops/pallas/warp_sample.py:warp_sample_pallas``.
Every ``texture()`` whose coordinates are not separable over the output
grid (every CRT-curvature shader) lands here. The kernel
(``csrc/warp_sample.cu``) is one thread per output pixel reading at most
four texels per channel through L1, with the reference's gather index
math bit for bit; it takes a batch of textures natively and has no
texture-size limit.

``warp_sample`` launches the kernel for a CUDA tensor and takes the plain
version (``sampling.sample2d_gather``, the reference's gather path) only
for a CPU tensor. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from retrocapture_tpu_torch.ops.sampling import sample2d_gather

__all__ = ["warp_sample", "warp_sample_plain", "LAUNCHES"]

LAUNCHES = 0

_MODE = {"clamp_to_edge": 0, "clamp_to_border": 1, "repeat": 2, "mirrored_repeat": 3}

warp_sample_plain = sample2d_gather


def _launch(tex, u, v, filter_linear: bool, wrap_mode: str):
    from retrocapture_tpu_torch.ops.cuda._build import load

    global LAUNCHES
    if tex.dtype != torch.float32:
        raise TypeError(f"warp_sample: tex must be float32, got {tex.dtype}")
    squeeze = tex.dim() == 3
    t4 = tex[None] if squeeze else tex
    if t4.dim() != 4:
        raise ValueError(f"warp_sample: tex must be [H,W,C] or [B,H,W,C], got {tuple(tex.shape)}")
    if u.shape != v.shape or u.dim() != 2:
        raise ValueError(f"warp_sample: u, v must share one [HO, WO] shape, got {tuple(u.shape)}, {tuple(v.shape)}")
    t4 = t4.contiguous()
    dev = t4.device
    uu = u.to(device=dev, dtype=torch.float32).contiguous()
    vv = v.to(device=dev, dtype=torch.float32).contiguous()
    b, h, w, c = t4.shape
    ho, wo = u.shape
    out = torch.empty((b, ho, wo, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out[0] if squeeze else out
    fn = load("warp_sample")
    rc = fn(
        t4.data_ptr(), uu.data_ptr(), vv.data_ptr(), out.data_ptr(),
        b, h, w, c, ho * wo, int(bool(filter_linear)), _MODE[wrap_mode],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"warp_sample kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out[0] if squeeze else out


def warp_sample(tex, u, v, *, filter_linear: bool, wrap_mode: str = "clamp_to_edge"):
    """``tex [H, W, C]`` or ``[B, H, W, C]`` f32, ``u, v [HO, WO]`` f32
    normalized coords → ``[..., HO, WO, C]`` with GL semantics. A CUDA
    tensor launches the kernel; a CPU tensor takes the plain gather."""
    if tex.is_cuda:
        return _launch(tex, u, v, filter_linear, wrap_mode)
    if tex.device.type != "cpu":
        raise RuntimeError(f"warp_sample: no kernel for device {tex.device}")
    return sample2d_gather(tex, u, v, filter_linear=filter_linear, wrap_mode=wrap_mode)
