"""The one generator of every traffic mix: source frames, their due times
and the sample of answers that is compared, all from ``--seed``.

A mix is a data file (``traffic/<mix>.json``) of parameters:

* ``loop``: ``closed`` (one producer, the next batch when the queue takes
  it) or ``open`` (frame ``i`` due at ``i / rate_hz`` after the window
  opens, whatever the system does);
* ``batch``: frames an apply (0 or absent: the configuration's batch);
* ``rate_hz``: the open loop's frame rate;
* ``pool``, ``palette``, ``block``: the seeded pool of source frames:
  ``pool`` frames of pixel art, each a grid of ``block`` x ``block``
  cells coloured from a ``palette`` of random colours;
* ``sample_every``: one answer in about this many is compared with the
  reference, the frames drawn from the seed.

Frame ``g`` (counted from the first frame the engine sees, warm-up
included) is pool frame ``g % pool``, every byte xored with the ``g //
pool``-th entry of a seeded permutation of 0..255, so no two applies of a
run see the same input and the reference can rebuild any frame from its
index.
"""

from __future__ import annotations

import numpy as np

# The sample is drawn over this many frames: more than any run delivers
# (51 s at 5000 frames/s).
SAMPLE_SPAN = 1 << 18


def _seed(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


class FrameSource:
    """The frames, due times and sample of one mix at one source size."""

    def __init__(self, traffic: dict, src_hw, seed: int):
        h, w = src_hw
        rng = _seed(seed, 0)
        pool, palette, block = int(traffic["pool"]), int(traffic["palette"]), int(traffic["block"])
        colors = rng.integers(0, 256, (pool, palette, 3), dtype=np.uint8)
        cells = rng.integers(0, palette, (pool, -(-h // block), -(-w // block)))
        art = colors[np.arange(pool)[:, None, None], cells]  # [pool, cells high, cells wide, 3]
        self.pool = np.ascontiguousarray(art.repeat(block, 1).repeat(block, 2)[:, :h, :w])
        self.xor = rng.permutation(256).astype(np.uint8)
        self.sampled = _seed(seed, 1).random(SAMPLE_SPAN) < 1.0 / float(traffic["sample_every"])
        self.rate_hz = float(traffic.get("rate_hz", 0.0))

    def frames(self, g0: int, n: int) -> np.ndarray:
        """Frames ``g0 .. g0 + n - 1``, u8 ``[n, h, w, 3]``."""
        g = np.arange(g0, g0 + n)
        p = len(self.pool)
        return self.pool[g % p] ^ self.xor[(g // p) % 256][:, None, None, None]

    def frame(self, g: int) -> np.ndarray:
        return self.frames(g, 1)[0]

    def due(self, i: int) -> float:
        """Seconds after the window opens at which open-loop frame ``i`` is due."""
        return i / self.rate_hz

    def is_sampled(self, g: int) -> bool:
        return bool(self.sampled[g % SAMPLE_SPAN])
