"""The work of the viewport blit with its u8 pack, ``resample_u8``, at a
stage's shapes.

Counted as the port's kernel table counts it (PERF.md §6, row 1): the f32 RGB input
``[B, H, W, 3]`` read once, the u8 output ``[B, OH, OW, 3]`` written once,
and two (index, weight) taps an output row and column; 4 taps x (mul,
add), the scale and the rounding an output value.
"""

CHANNELS = 3


def work(batch: int, src_hw, out_hw):
    """(bytes, operations) of one launch over ``batch`` frames: ``src_hw``
    (H, W) the blit's input, ``out_hw`` (OH, OW) the viewport."""
    (h, w), (oh, ow) = src_hw, out_hw
    values = batch * oh * ow * CHANNELS
    return 4 * batch * h * w * CHANNELS + values + 16 * (oh + ow), 10 * values
