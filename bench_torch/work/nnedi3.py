"""The work of a chain's nnedi3 passes, at each pass's shapes.

Counted as the net's own work, whatever computes it (today the entry's
eager passes; one fused kernel later reads the same work): each pass
predicts one value a texel and channel of its input (R, G and B of the
``-rgb`` shaders), each value ``2 nns`` dot products of the 32 window
terms, a multiply and an add a term; the pass's input texels read once
and its output texels written once, RGBA8 at 4 bytes. The mean, the
variance, ``exp`` and the softsign mix are left out.
"""

from __future__ import annotations

import re

WINDOW = 32  # the 8 x 4 window's terms
CHANNELS = 3
TEXEL_BYTES = 4  # RGBA8

_NNS = re.compile(r"^nnedi3-nns(\d+)-win8x4-pass[12]-")


def stages(config: dict, src_hw, sizes) -> list:
    """``[(nns, (h, w), (oh, ow)), ...]``: each nnedi3 pass of ``config``
    with its neurons, input and output, from the chain's pass ``sizes``
    (``work/passes.py``) over the source ``src_hw``."""
    out, hw = [], tuple(src_hw)
    for entry, size in zip(config["passes"], sizes):
        m = _NNS.match(entry["shader"])
        if m:
            out.append((int(m.group(1)), hw, tuple(size)))
        hw = tuple(size)
    return out


def work(batch: int, stages: list):
    """(bytes, operations) of the ``stages`` over ``batch`` frames."""
    moved = ops = 0
    for nns, (h, w), (oh, ow) in stages:
        ops += CHANNELS * h * w * 2 * nns * WINDOW * 2
        moved += TEXEL_BYTES * (h * w + oh * ow)
    return batch * moved, batch * ops
