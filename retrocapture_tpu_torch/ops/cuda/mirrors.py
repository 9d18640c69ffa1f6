"""The numerics mirrors: one elementwise CUDA kernel and its plain versions.

The reference's jitted XLA fusions compute ``sin``, ``log``, ``log2`` and
``exp`` inline on the CPU (libm's ``sinf``; XLA's own Cephes ``log`` and
``exp``), and a GLSL ``pow`` as ``exp(log(x) * c)``. The port repeats them
bit for bit in ``policy.sinf32``, ``logf32``, ``log2f32`` and ``expf32``
as float64 and int64 tensor passes: those are the plain versions, and
what a CPU tensor runs. ``csrc/mirrors.cu`` computes the same bits in one
pass over the tensor on a card. It replaces no TPU kernel: the reference
has no Pallas kernel for these functions.

``sinf32``, ``logf32``, ``log2f32``, ``expf32`` and ``powf32`` launch the
kernel for a CUDA tensor and take the plain version only for a CPU
tensor. Every one sits behind the operator ``rctpu::mirror``
(``torch.library``), whose batching rule applies it to the whole batch
(it is elementwise): one launch for a batched walk. ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from retrocapture_tpu_torch import policy

__all__ = ["sinf32", "logf32", "log2f32", "expf32", "powf32", "mirror_plain", "LAUNCHES"]

LAUNCHES = 0

# The kernel's op codes (csrc/mirrors.cu).
_OPS = {"sin": 0, "log": 1, "log2": 2, "exp": 3, "pow": 4}


def mirror_plain(x: torch.Tensor, op: str, c: float = 0.0) -> torch.Tensor:
    """The plain version of op ``op`` on f32 ``x``: the ``policy`` function
    (``pow``: ``expf32(logf32(x) * c)``, c an f32 value)."""
    if op == "sin":
        return policy.sinf32(x)
    if op == "log":
        return policy.logf32(x)
    if op == "log2":
        return policy.log2f32(x)
    if op == "exp":
        return policy.expf32(x)
    if op == "pow":
        return policy.expf32(policy.logf32(x) * c)
    raise ValueError(f"mirror: unknown op {op!r}")


def _launch(x: torch.Tensor, op: str, c: float) -> torch.Tensor:
    """The kernel on ``x``'s card: no fallback, it raises where it cannot
    build or launch."""
    from retrocapture_tpu_torch.ops.cuda._build import load

    global LAUNCHES
    fn = load("mirrors")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    if out.numel() == 0:
        return out
    rc = fn(xc.data_ptr(), out.data_ptr(), xc.numel(), _OPS[op], c,
            torch.cuda.current_stream(xc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mirrors kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


@torch.library.custom_op("rctpu::mirror", mutates_args=(), device_types="cuda")
def _mirror_op(x: torch.Tensor, op: str, c: float) -> torch.Tensor:
    """f32 ``x`` of any shape → op(x), same shape: the kernel on a card."""
    return _launch(x, op, c)


@_mirror_op.register_kernel("cpu")
def _mirror_cpu(x, op, c):
    return mirror_plain(x, op, c)


@_mirror_op.register_fake
def _mirror_fake(x, op, c):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@_mirror_op.register_vmap
def _mirror_vmap(info, in_dims, x, op, c):
    # Elementwise: the whole batch in one launch, its batch dimension kept.
    return _mirror_op(x, op, c), in_dims[0]


def _mirror(x: torch.Tensor, op: str, c: float = 0.0) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise TypeError(f"mirror {op}: x must be a float32 tensor, got {getattr(x, 'dtype', type(x))}")
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"mirror {op}: no kernel for device {x.device}")
    if op not in _OPS:
        raise ValueError(f"mirror: unknown op {op!r}")
    return _mirror_op(x, op, float(c))


def sinf32(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``sinf`` of f32 ``x`` (``policy.sinf32``)."""
    return _mirror(x, "sin")


def logf32(x: torch.Tensor) -> torch.Tensor:
    """XLA's inline f32 ``log`` (``policy.logf32``)."""
    return _mirror(x, "log")


def log2f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log2`` (``policy.log2f32``)."""
    return _mirror(x, "log2")


def expf32(x: torch.Tensor) -> torch.Tensor:
    """XLA's inline f32 ``exp`` (``policy.expf32``)."""
    return _mirror(x, "exp")


def powf32(x: torch.Tensor, c: float) -> torch.Tensor:
    """``expf32(logf32(x) * c)`` in one pass, ``c`` an f32 value: the GLSL
    pow as jitted XLA folds it (graph/kernels._glsl_pow)."""
    return _mirror(x, "pow", c)
