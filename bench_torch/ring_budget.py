"""What replaying a history ring from frame 0 costs the comparison.

    python3 bench_torch/ring_budget.py [--frames N] [--seed S] [--dtype float32|bfloat16] [--cpu]

A stateful reference of the kind ``harness/compare.py`` replays
(``STATEFUL``, ``render_sequence``): a one-pass chain at the viewport's
size over a 7-deep ring of its own RGBA8 outputs, ``[vh, vw, 4]`` in
``dtype``, with libretro glsl-shaders motionblur-simple's blend: the
pass averages pairwise from the oldest frame forward, ``out = src/2 +
P0/4 + P1/8 + P2/16 + P3/32 + P4/64 + P5/128 + P6/128`` (``P0`` the frame
before), the source taken NEAREST to the viewport. The ring starts cold
as the engine's does, every slot the first frame as stored. The source
is the offline mix's (``traffic/offline.json``) at 320x240, fed by
``compare.rendered`` in its chunks; the frames compared are the ones the
mix samples among the first ``--frames``.

Prints one JSON line: the frames replayed, the seconds, the ms a frame,
and the card's name and power limit; also to
``chiprun_out/ring_budget.json``. It imports nothing of the program.
``--cpu`` rehearses it on the CPU at a 32x18 viewport.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import compare  # noqa: E402
from harness.frames import FrameSource  # noqa: E402
from harness.spec import BENCH, ROOT  # noqa: E402
from run import _power_limit  # noqa: E402

DEPTH = 7  # PrevTexture .. Prev6Texture


def _store(x):
    """The RGBA8 store: the nearest of the 256 levels."""
    return torch.round(x.clamp(0.0, 1.0) * 255.0) / 255.0


def _upscale(x, out_hw, dtype):
    """u8 ``[h, w, 3]`` taken NEAREST to ``out_hw``, RGBA in ``dtype``."""
    h, w = x.shape[0], x.shape[1]
    oh, ow = out_hw
    rows = (torch.arange(oh, device=x.device) * h) // oh
    cols = (torch.arange(ow, device=x.device) * w) // ow
    rgb = x[rows][:, cols].to(dtype) / 255.0
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)


class Ring:
    """The ring reference (a module's protocol, as a class)."""

    STATEFUL = True

    @staticmethod
    def render_sequence(frames, gs, params, out_hw, dtype=torch.float32):
        want, out, ring, head, g = set(gs), {}, None, 0, 0
        for chunk in frames:
            for x in chunk:
                src = _upscale(x, out_hw, dtype)
                if ring is None:
                    ring = [_store(src) for _ in range(DEPTH)]
                # ring[(head + k) % DEPTH] is P_k; the blend from P6 forward.
                c = ring[(head + DEPTH - 1) % DEPTH]
                for k in range(DEPTH - 2, -1, -1):
                    c = (c + ring[(head + k) % DEPTH]) * 0.5
                stored = _store((c + src) * 0.5)
                head = (head + DEPTH - 1) % DEPTH
                ring[head] = stored
                if g in want:
                    out[g] = torch.round(stored[..., :3].float() * 255.0).to(torch.uint8)
                g += 1
        return out


def budget(frames: int, seed: int, dtype, device: str, viewport=(1920, 1080)) -> dict:
    """Replay ``frames`` frames of the ring through ``compare.rendered``;
    the timing."""
    with open(BENCH / "traffic" / "offline.json") as f:
        traffic = json.load(f)
    src = FrameSource(traffic, (240, 320), seed)
    cell = SimpleNamespace(viewport=viewport, config={"parameters": {}}, reference=lambda: Ring)
    # The replay runs to the last frame asked for: ask for the last.
    gs = [g for g in range(frames - 1) if src.is_sampled(g)] + [frames - 1]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    got = dict(compare.rendered(cell, src, gs, dtype, device))
    sync()
    seconds = time.perf_counter() - t
    if sorted(got) != gs:
        raise RuntimeError(f"the ring reference answered {len(got)} of {len(gs)} frames")
    return {"frames": frames, "compared": len(gs), "seconds": seconds, "ms_per_frame": seconds / frames * 1e3,
            "dtype": str(dtype).replace("torch.", ""), "viewport": list(viewport)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("ring_budget.py: no CUDA device (--cpu runs on the CPU)", file=sys.stderr)
        return 3
    dtype = getattr(torch, args.dtype)
    viewport = (32, 18) if args.cpu else (1920, 1080)
    budget(min(args.frames, 300), args.seed + 1, dtype, device, viewport)  # warm-up
    row = budget(args.frames, args.seed, dtype, device, viewport)
    row["device"] = f"{torch.cuda.get_device_name()}, {_power_limit()}" if device == "cuda" else "cpu"
    if device == "cuda":
        row["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(row), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ring_budget.json").write_text(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
