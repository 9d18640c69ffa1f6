"""The work of xbr-lv2's front section, ``rctpu::xbr_front``, at a stage's shapes.

Counted from the stage's shapes as the port's kernel table counts it
(PERF.md §6, row X): the source's 3 colour channels ``[B, H, W]`` f32 read
once, the index maps (the clamped columns ``[W + 4]`` and the 5 row maps ``[OH]``,
int64) read once, and ``S [B, 19, OH, W]`` f32 written once. Operations are
counted per S pixel: 93 a corner for the edge rules and the code (11
equality tests of 3, 6 inequalities, the two weighted sums of 30, the five
flags' 16, the code's 4 multiply-adds), 4 corners, and the 15 colour scales;
the lumas are work per source texel and left out.
"""

PLANES = 19
OPS_PER_PIXEL = 4 * 93 + 15


def work(batch: int, src_hw, out_hw):
    """(bytes, operations) of one launch over ``batch`` frames."""
    (h, w), (oh, _) = src_hw, out_hw
    moved = 12 * batch * h * w + 8 * (w + 4 + 5 * oh) + 4 * PLANES * batch * oh * w
    return moved, OPS_PER_PIXEL * batch * oh * w
