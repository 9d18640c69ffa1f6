"""The work of crt-mattias's epilogue, ``rctpu::mattias_epilogue``, at a stage's shapes.

Counted from the stage's shapes: the blur's three planes ``[B, OH, OW]``
f32 read once, RGBA ``[B, OH, OW, 4]`` f32 written once, and the six
per-pixel maps read once for the batch (``bv``, ``uv_u``, ``uv_v``, the
vignette and the comb factor f32, the inside test one byte). Operations
are counted a pixel of a frame from the kernel's source
(``csrc/mattias_epilogue.cu``, ``shade``), a multiply-add as two and a
conversion or compare as none: 74 shared by the channels (the scanline's
phase 2, its sine 15, its multiply-add 2, pow 0.9 52, the 3.8 and the two
drifted coordinates 3) and 94 a channel (the post-add, the contrast's 4,
vignette, tint, the saturation's 4, scanline, flicker and comb, the hash's
12 and its sine 15, the noise's 3, pow 0.45 52). The bound is the bytes'.
"""

MAPS_F32 = 5  # bv, uv_u, uv_v, vig, comb
OPS_PER_PIXEL = 74 + 3 * 94


def work(batch: int, src_hw, out_hw):
    """(bytes, operations) of one launch over ``batch`` frames."""
    oh, ow = out_hw
    pixels = batch * oh * ow
    moved = (3 * 4 + 4 * 4) * pixels + (4 * MAPS_F32 + 1) * oh * ow
    return moved, OPS_PER_PIXEL * pixels
