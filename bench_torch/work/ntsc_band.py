"""The work of ntsc-pass2's 65-tap FIR with its decimation by 2, the band
product, at a stage's shapes.

Counted as the FIR's own work, whatever computes it (today a dense band
GEMM a channel, whose products are mostly by zero; a FIR kernel later
reads the same work): for each of the 3 channels the pass's input plane
``[B, h, W]`` f32 read once and its output plane ``[B, h, W / 2]`` f32
written once; 65 taps an output value, a multiply and an add a tap.
"""

CHANNELS = 3  # Y, I and Q
TAPS = 65


def work(batch: int, src_hw, out_hw):
    """(bytes, operations) over ``batch`` frames: ``src_hw`` (h, W) the
    FIR's input plane, ``out_hw`` (h, W / 2) its output plane."""
    (h, w), (oh, ow) = src_hw, out_hw
    moved = 4 * CHANNELS * batch * (h * w + oh * ow)
    return moved, 2 * TAPS * CHANNELS * batch * oh * ow
