"""The card's peaks and the roofline bound.

Kept under the benchmark's own directory, so that a change to the
program or to its tools cannot move the yardstick. The peaks are NVIDIA's
data sheet for one H100 SXM at its 700 W limit: 3.35 TB/s of HBM, 67
TFLOP/s of f32 outside the tensor cores. A run prints the card's power
limit beside its numbers.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` and do ``flops`` f32 operations."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(shape, itemsize: int) -> int:
    """Bytes of a tensor of ``shape`` and element size ``itemsize``."""
    n = itemsize
    for d in shape:
        n *= int(d)
    return n
