"""The comparison that decides ``correct``: the answers the window itself
produced, against the configuration's plain reference.

Each sampled answer (a u8 frame) is rendered again by the reference
(``rendered``, the only caller of a reference module). A stateless
reference renders frame ``g`` from the same source frame and FrameCount
alone (``render``). A reference whose module declares ``STATEFUL = True``
replays the whole sequence instead (``render_sequence``): every frame from
0, the engine's first, in order and from its own cold state, as the
engine's history and PassFeedback carry every frame into the next. Two
numbers are compared, each over the worst sampled frame and each held to
the limit that the configuration's file states (``compare``):

* ``off_share``: the share of the frame's u8 values more than 2 levels
  from the reference's;
* ``mean_abs``: the frame's mean absolute difference, in u8 levels.

and ``frames``, the number of answers compared, is held to a least count.
"""

from __future__ import annotations

import torch

TOLERANCE_LEVELS = 2  # a value more than this far from the reference counts as off
CHUNK_FRAMES = 256  # a stateful reference is handed the source this many frames at a time, at most


def frame_numbers(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(off_share, mean_abs) of one u8 answer against the reference's."""
    if got.shape != want.shape or got.dtype != torch.uint8:
        return 1.0, 255.0
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    return float((d > TOLERANCE_LEVELS).float().mean()), float(d.float().mean())


def is_stateful(ref) -> bool:
    """Whether the reference module ``ref`` replays a sequence."""
    return bool(getattr(ref, "STATEFUL", False))


def rendered(cell, src, gs, dtype, device):
    """The reference's answers for the frames ``gs``, computed in ``dtype``
    on ``device``: ``(g, u8 [vh, vw, 3])`` in ascending ``g``.

    A stateless reference renders each frame from ``src.frame(g)`` alone,
    one at a time as they are asked for: ``render(x, g, params, (vh, vw),
    dtype)``. A stateful one is called once: ``render_sequence(frames, gs,
    params, (vh, vw), dtype)``, where ``frames`` yields the source from
    frame 0 through ``max(gs)`` in order, as u8 tensors ``[n, h, w, 3]`` on
    ``device`` of at most ``CHUNK_FRAMES`` frames (``src.frames``), and it
    returns ``{g: u8 [vh, vw, 3]}`` for each ``g`` in ``gs``."""
    ref = cell.reference()
    vw, vh = cell.viewport
    params = cell.config["parameters"]
    gs = sorted(gs)
    if not is_stateful(ref):
        for g in gs:
            x = torch.from_numpy(src.frame(g)).to(device)
            yield g, ref.render(x, g, params, (vh, vw), dtype)
        return
    if not gs:
        return
    end = gs[-1] + 1

    def frames():
        for g0 in range(0, end, CHUNK_FRAMES):
            yield torch.from_numpy(src.frames(g0, min(CHUNK_FRAMES, end - g0))).to(device)

    out = ref.render_sequence(frames(), gs, params, (vh, vw), dtype)
    for g in gs:
        yield g, out[g]


def compare(cell, src, kept: dict, device) -> dict:
    """The compared numbers of the answers ``kept`` (frame -> u8 array),
    the reference computed in float32 on ``device``."""
    off = mad = 0.0
    for g, want in rendered(cell, src, kept, torch.float32, device):
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
