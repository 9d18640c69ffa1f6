"""Inputs of the xbr-lv2 front section (``rctpu::xbr_front``) for the
tests and chip_smoke.py: textures and the index tensors of
``graph.kernels._xbr_gathers``.

``texture`` gives textures on the k/255 grid (``quantized``, what the u8
chain input and RGBA8 pass outputs hold) or off it, with NaN and +-inf in
some texels, and flat runs so that the edge rules' equalities hold
somewhere. ``row_maps`` gives the 5 row-index maps of an output height:
NEAREST at the ratio oh / h, as the rasterizer's y taps are, or scattered.
"""

import numpy as np

from retrocapture_tpu_torch.graph.kernels import _xbr_gathers


def texture(rng, b, h, w, c=4, quantized=True, specials=True):
    """[b, h, w, c] f32: levels k/255 (``quantized``) or uniform values in
    [-0.1, 1.1); 2x2 flat cells over half the frame; with ``specials``,
    NaN, +inf and -inf each in about 1 texel of 500."""
    if quantized:
        t = (rng.integers(0, 256, (b, h, w, c)).astype(np.float32) * np.float32(1.0 / 255.0)).astype(np.float32)
    else:
        t = (rng.random((b, h, w, c), np.float32) * np.float32(1.2) - np.float32(0.1)).astype(np.float32)
    flat = np.repeat(np.repeat(t[:, ::2, ::2], 2, axis=1), 2, axis=2)[:, :h, :w]
    t = np.where(np.arange(w)[None, None, :, None] < w // 2, flat, t)
    if specials:
        u = rng.random((b, h, w, c))
        t = np.where(u < 0.002, np.nan, np.where(u > 0.998, np.inf, np.where(u > 0.996, -np.inf, t)))
    return np.ascontiguousarray(t.astype(np.float32))


def row_maps(h, oh, kind="nearest", rng=None):
    """{dy: [oh] int64}, dy = -2..2: the base row of each output row plus
    dy (clamped later by ``_xbr_gathers``), NEAREST at oh / h, or for
    ``kind="random"`` any rows, with 5 independent maps."""
    if kind == "random":
        return {k: rng.integers(-3, h + 3, oh).astype(np.int64) for k in (-2, -1, 0, 1, 2)}
    base = ((np.arange(oh) + 0.5) * h / oh).astype(np.int64)
    return {k: base + k for k in (-2, -1, 0, 1, 2)}


def gathers(h, w, oh, device, kind="nearest", rng=None):
    """The front section's index tensors on ``device``."""
    return _xbr_gathers(row_maps(h, oh, kind, rng), h, w, device)
