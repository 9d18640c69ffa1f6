"""Inputs of crt-mattias's epilogue (``rctpu::mattias_epilogue``) for the
CPU and card tests: the blur planes, the six per-pixel maps and the
FrameCounts.

``maps`` builds the maps as the crt-mattias hand kernel does
(``_mattias_warp`` at a CURVATURE, ``_mattias_comb``), at any output size.
``planes`` gives blur planes of values around [0, 1], with NaN, +inf and
-inf in some pixels where ``specials``. ``FRAME_COUNTS`` are the FrameCounts
the tests take in turn: 0, 59, 2^20 and 2^24 - 1 (the last that f32 holds
exactly).
"""

import numpy as np
import torch

from retrocapture_tpu_torch.graph import kernels as tk

FRAME_COUNTS = (0.0, 59.0, 2.0**20, 2.0**24 - 1)


def maps(oh, ow, device, curvature=0.5):
    """(bv, uv_u, uv_v, vig, comb, inside) at output size (ow, oh)."""
    uv_u, uv_v, _, bv, vig, inside = tk._mattias_warp(ow, oh, curvature, device)
    return bv, uv_u, uv_v, vig, tk._mattias_comb(ow, oh, device), inside


def planes(rng, b, oh, ow, device, specials=False):
    """{channel: [b, oh, ow]} f32 in [-0.1, 1.3); with ``specials`` NaN,
    +inf and -inf each in about 1 pixel of 300."""
    out = {}
    for ch in range(3):
        p = rng.random((b, oh, ow), np.float32) * np.float32(1.4) - np.float32(0.1)
        if specials:
            u = rng.random((b, oh, ow))
            p = np.where(u < 0.003, np.nan, np.where(u > 0.997, np.inf, np.where(u > 0.994, -np.inf, p)))
        out[ch] = torch.from_numpy(np.ascontiguousarray(p.astype(np.float32))).to(device)
    return out


def frame_counts(b, device, start=0):
    """[b] f32: FRAME_COUNTS in turn from ``start``."""
    return torch.tensor([FRAME_COUNTS[(start + i) % len(FRAME_COUNTS)] for i in range(b)], dtype=torch.float32,
                        device=device)
