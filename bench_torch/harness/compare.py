"""The comparison that decides ``correct``: the answers the window itself
produced, against the configuration's plain reference.

Each sampled answer (a u8 frame) is rendered again by the reference from
the same source frame and FrameCount. Two numbers are compared, each over
the worst sampled frame and each held to the limit that the
configuration's file states (``compare``):

* ``off_share``: the share of the frame's u8 values more than 2 levels
  from the reference's;
* ``mean_abs``: the frame's mean absolute difference, in u8 levels.

and ``frames``, the number of answers compared, is held to a least count.
"""

from __future__ import annotations

import torch

TOLERANCE_LEVELS = 2  # a value more than this far from the reference counts as off


def frame_numbers(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(off_share, mean_abs) of one u8 answer against the reference's."""
    if got.shape != want.shape or got.dtype != torch.uint8:
        return 1.0, 255.0
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    return float((d > TOLERANCE_LEVELS).float().mean()), float(d.float().mean())


def compare(cell, src, kept: dict, device) -> dict:
    """The compared numbers of the answers ``kept`` (frame -> u8 array),
    the reference computed in float32 on ``device``."""
    ref = cell.reference()
    vw, vh = cell.viewport
    off = mad = 0.0
    for g in sorted(kept):
        x = torch.from_numpy(src.frame(g)).to(device)
        want = ref.render(x, g, cell.config["parameters"], (vh, vw), torch.float32)
        got = torch.as_tensor(kept[g]).to(device)
        o, m = frame_numbers(got, want)
        off, mad = max(off, o), max(mad, m)
    return {"frames": len(kept), "off_share": off, "mean_abs": mad}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit], ...]): every number within its
    limit (``frames`` at least its limit, the others at most)."""
    rows, ok = [], True
    for name, value in numbers.items():
        limit = limits[name]
        ok &= value >= limit if name == "frames" else value <= limit
        rows.append([name, value, limit])
    return bool(ok), rows
