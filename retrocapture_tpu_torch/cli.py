"""Command-line entry point — the equivalent of the reference's
``main()`` flag surface (src/main.cpp:222-712) for the frame-processing
core: pick a source, load a preset, set parameters, process frames, write
outputs.

    python -m retrocapture_tpu_torch --source test \
        --preset assets/presets/feedback-ghost.glslp \
        --width 320 --height 240 --viewport 1920x1080 --frames 60 \
        --output out/ghost

Frames are processed on the card (``cuda``); ``--cpu`` runs the same
program on the CPU. Without a card and without ``--cpu`` the Engine
raises: nothing falls back.

Out-of-scope reference flags (capture-card controls, streaming ports,
UI/window, cloudflared, chat) are intentionally absent: the graft is the
frame-processing core fed by host-side frame queues (BASELINE.json).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

DEFAULT_SHADER_ROOT = "shaders_glsl"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="retrocapture_tpu_torch",
        description="retro-shader video pipeline in PyTorch/CUDA",
    )
    ap.add_argument("--source", default="test", choices=["test", "npy", "png"],
                    help="frame source: synthetic test pattern, .npy batch, or PNG file")
    ap.add_argument("--input", default=None, help="input path for npy/png sources")
    ap.add_argument("--preset", default=None,
                    help=".glslp or .glsl path (absolute, relative to --shader-root, "
                    "or relative to the working directory)")
    ap.add_argument("--shader-root", default=DEFAULT_SHADER_ROOT)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--viewport", default=None, metavar="WxH",
                    help="output size (default: source size)")
    ap.add_argument("--logical-width", type=int, default=0)
    ap.add_argument("--logical-height", type=int, default=0)
    ap.add_argument("--overscan-x", type=float, default=0.0, metavar="PCT")
    ap.add_argument("--overscan-y", type=float, default=0.0, metavar="PCT")
    ap.add_argument("--brightness", type=float, default=1.0)
    ap.add_argument("--contrast", type=float, default=1.0)
    ap.add_argument("--flip-y", action="store_true")
    ap.add_argument("--maintain-aspect", action="store_true")
    ap.add_argument("--param", action="append", default=[], metavar="NAME=VALUE",
                    help="runtime shader parameter override (repeatable)")
    ap.add_argument("--list-parameters", action="store_true",
                    help="print the preset's parameters as JSON and exit")
    ap.add_argument("--list-presets", action="store_true",
                    help="recursively list .glslp under --shader-root and exit")
    ap.add_argument("--output", default=None,
                    help="output prefix: writes <prefix>.npy (and .png for single frames)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--stats", action="store_true",
                    help="print per-run timing/content stats as JSON")
    ap.add_argument("--param-mode", default="const", choices=["const", "traced"],
                    help="'traced': parameters are device scalars, set_parameter "
                    "applies next frame without recompiling (the reference's "
                    "glUniform semantics); 'const' folds them for max throughput")
    ap.add_argument("--max-resolution", default=None, metavar="WxH",
                    help="downscale larger sources before the chain "
                    "(ShaderEngine::setMaxShaderResolution, the low-power knob)")
    ap.add_argument("--save-state", default=None, metavar="PATH",
                    help="write temporal state (history/feedback/frame counters) "
                    "after processing")
    ap.add_argument("--load-state", default=None, metavar="PATH",
                    help="restore temporal state before processing")
    return ap


def _resolve_preset(args) -> str:
    p = Path(args.preset)
    if not p.is_absolute():
        rooted = Path(args.shader_root) / args.preset
        # A path that exists as given (relative to the working directory)
        # and not under the shader root is taken as given.
        if rooted.exists() or not p.exists():
            p = rooted
    return str(p)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_presets:
        root = Path(args.shader_root)
        for p in sorted(root.rglob("*.glslp")):
            print(p.relative_to(root))
        return 0

    from retrocapture_tpu_torch import Engine
    from retrocapture_tpu_torch.io.testpattern import TestPatternSource
    from retrocapture_tpu_torch.runtime.pipeline import FramePipeline, ImageSettings

    viewport = None
    if args.viewport:
        w, h = args.viewport.lower().split("x")
        viewport = (int(w), int(h))

    engine = Engine(viewport=viewport, device="cpu" if args.cpu else "cuda")
    if args.preset:
        if not engine.load_preset(_resolve_preset(args)):
            print(f"preset load failed: {engine.last_error}", file=sys.stderr)
            # degrade to passthrough, mirroring the reference

    if args.list_parameters:
        print(json.dumps(engine.get_parameters(), indent=1))
        return 0

    if args.param_mode != "const":
        engine.set_param_mode(args.param_mode)
    if args.max_resolution:
        w, h = args.max_resolution.lower().split("x")
        engine.set_max_shader_resolution(int(w), int(h))
    if args.load_state:
        engine.load_state(args.load_state)

    for kv in args.param:
        name, _, value = kv.partition("=")
        if not engine.set_parameter(name, float(value)):
            print(f"unknown parameter {name!r}", file=sys.stderr)

    logical = None
    if args.logical_width > 0 and args.logical_height > 0:
        logical = (args.logical_width, args.logical_height)
    pipeline = FramePipeline(
        engine,
        logical_resolution=logical,
        overscan_percent=(args.overscan_x, args.overscan_y),
        image=ImageSettings(
            brightness=args.brightness,
            contrast=args.contrast,
            flip_y=args.flip_y,
            maintain_aspect=args.maintain_aspect,
        ),
    )

    # -- source -------------------------------------------------------
    if args.source == "test":
        src = TestPatternSource(args.width, args.height)
        frames = src.capture_batch(args.frames)
    elif args.source == "npy":
        frames = np.load(args.input)
        if frames.ndim == 3:
            frames = frames[None]
    else:  # png
        from PIL import Image

        with Image.open(args.input) as im:
            frames = np.asarray(im.convert("RGB"))[None]

    # -- process ------------------------------------------------------
    outs = []
    t0 = time.time()
    for i in range(0, len(frames), args.batch):
        out = pipeline.process(frames[i : i + args.batch])
        outs.append(out.cpu().numpy())
    dt = time.time() - t0
    result = np.concatenate(outs) if len(outs) > 1 else outs[0]

    if args.save_state:
        engine.save_state(args.save_state)

    if args.stats:
        print(
            json.dumps(
                {
                    "frames": int(len(frames)),
                    "seconds": round(dt, 4),
                    "fps": round(len(frames) / dt, 1) if dt > 0 else None,
                    "output_shape": list(result.shape),
                    "mean": float(result.mean()),
                    "std": float(result.std()),
                    "shader_active": engine.shader_active,
                }
            )
        )

    if args.output:
        prefix = Path(args.output)
        prefix.parent.mkdir(parents=True, exist_ok=True)
        np.save(str(prefix) + ".npy", result)
        if result.ndim == 3 or result.shape[0] == 1:
            from PIL import Image

            img = result if result.ndim == 3 else result[0]
            Image.fromarray(
                np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)
            ).save(str(prefix) + ".png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
