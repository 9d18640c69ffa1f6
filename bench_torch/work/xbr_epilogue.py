"""The work of xbr-lv2's epilogue, ``rctpu::xbr_epilogue``, at a stage's shapes.

Counted as the port's kernel table counts it (PERF.md §6, row 6), from the
stage's shapes: the 19 planes ``S [B, 19, OH, w]`` f32 (the E, H, F, B, D
colours and 4 flag codes at output rows and source columns), the maps
``bx`` (int32) and ``fpx`` ``[OW]``, ``fpy [OH]`` and the 65-word ramp
table read once, ``[B, OH, OW, 4]`` f32 written once; 253 operations a
pixel.
"""

PLANES = 19
OPS_PER_PIXEL = 253


def work(batch: int, src_hw, out_hw):
    """(bytes, operations) of one launch over ``batch`` frames."""
    (_, w), (oh, ow) = src_hw, out_hw
    moved = 4 * (batch * PLANES * oh * w + 2 * ow + oh + 65) + 16 * batch * oh * ow
    return moved, OPS_PER_PIXEL * batch * oh * ow
