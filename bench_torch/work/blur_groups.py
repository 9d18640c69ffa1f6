"""The work of crt-mattias's blur, ``rctpu::blur_groups``, at a stage's shapes.

Counted as the port's kernel table counts it (PERF.md §6, row 4), from the
stage's shapes and not from the kernel's arguments: the texture ``[B, h,
w, 3]`` f32 and the coordinates ``u, v [OH, OW]`` f32 read once, one f32
plane a channel written once; 9 blur() groups x 25 NEAREST taps a pixel,
a multiply and an add a tap.
"""

GROUPS = 9  # the blur() calls of crt-mattias.glsl's main()
TAPS = 25  # 5 x 5 a call
CHANNELS = 3  # the groups write r, g and b


def work(batch: int, src_hw, out_hw):
    """(bytes, operations) of one launch over ``batch`` frames."""
    (h, w), (oh, ow) = src_hw, out_hw
    pixels = batch * oh * ow
    moved = 4 * (batch * h * w * 3 + 2 * oh * ow + CHANNELS * pixels)
    return moved, 2 * TAPS * GROUPS * pixels
