#!/usr/bin/env python3
"""The operand forms of every ``rctpu::fma`` launch on the main paths.

    python3 tools/torch_fma_forms.py            (on the card, at full size)
    python3 tools/torch_fma_forms.py --cpu      (on the CPU, at a small size)

Walks one apply (``RCTPU_REPLAY=0``, after a first apply that also builds
what a program keeps) of each path that chip_smoke.py's phase 23 replays,
at its batch (feedback-ghost-nv12 const and traced, xbr-lv2, ntsc-320px,
crt-mattias traced, warp-curve traced), nnedi3 nns64 ``-rgb`` and one
``FramePipeline.process`` of a batch (phase 16's pipeline), and records each
launch of the kernel through ``fma._fma_call`` (both routes; a batched
walk's one launch of the batch, not vmap's one-frame views): each
operand's shape and strides, the mode, the launches an apply, the bytes a
launch moves (each operand's own bytes once, the result once) and the
kernel's path and operand kinds as the launch plan gives them. With
``--cpu`` the same walks run on the CPU at 192x108 from 60x80 sources,
batch 2 (the forms, not their sizes, carry over). Prints one line a form
and one JSON object, and writes the object to
``chiprun_out/fma_forms.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from retrocapture_tpu_torch import Engine  # noqa: E402
from retrocapture_tpu_torch.ops.cuda import fma as fm  # noqa: E402

def recorded(args):
    """One launch's record: operands, mode, path and kinds, bytes."""
    plan = fm._plan(args[:3])
    nd = plan.geometry[1]
    views = {(t.data_ptr(), tuple(t.shape), t.stride()): t for t in args[:3] if t is not None}
    return {
        "operands": [None if t is None else {"shape": list(t.shape), "strides": list(t.stride())} for t in args[:3]],
        "mode": "fma32" if args[6] == 0 else "fmaf32",
        "out": list(plan.shape),
        "path": fm.PATH_NAMES[plan.path],
        "kinds": [fm.KIND_NAMES[plan.geometry[2 + nd + k]] for k in range(3)],
        "bytes": sum(cs.own_bytes(t) for t in views.values()) + 4 * plan.numel,
    }


def walk(name, run):
    """The forms of the launches one call of ``run`` makes."""
    forms = {}
    orig = fm._fma_call

    def rec(*args):
        if not any(isinstance(a, torch.Tensor) and torch._C._functorch.is_batchedtensor(a) for a in args):
            key = json.dumps(recorded(args))
            forms[key] = forms.get(key, 0) + 1
        return orig(*args)

    fm._fma_call = rec
    try:
        run()
    finally:
        fm._fma_call = orig
    rows = [dict(json.loads(k), launches=n) for k, n in forms.items()]
    return {"path": name, "launches": sum(r["launches"] for r in rows),
            "bytes": sum(r["launches"] * r["bytes"] for r in rows), "forms": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="walk on the CPU at a small size")
    opts = ap.parse_args()
    if opts.cpu:
        dev, card = "cpu", "cpu"
        cs.VIEWPORT, cs.SRC_HW = (192, 108), (60, 80)
        batches = dict.fromkeys(("slice", "xbr", "ntsc", "mattias", "warp", "nnedi3", "pipeline"), 2)
        cs.NTSC_WIDTH = 4 * cs.SRC_HW[1]
    else:
        if not torch.cuda.is_available():
            raise SystemExit("torch_fma_forms: no card (use --cpu)")
        dev = "cuda"
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
        batches = {"slice": cs.SLICE_BATCH, "xbr": cs.XBR_BATCH, "ntsc": cs.NTSC_BATCH, "mattias": cs.MATTIAS_BATCH,
                   "warp": cs.WARP_BATCH, "nnedi3": cs.NNEDI3_BATCH, "pipeline": cs.STREAM_BATCH}
    h, w = cs.SRC_HW
    rng = np.random.default_rng(12)
    out = {"card": card, "viewport": list(cs.VIEWPORT), "source": [h, w], "paths": []}
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        from _nnedi3_standin import write_chain as write_nnedi3

        paths = [(name, path, fmt, param) for name, path, fmt, _, param in cs._replay_paths(tmp)]
        d64 = tmp / "nnedi3"
        d64.mkdir()
        paths.append(("nnedi3 nns64 -rgb", write_nnedi3(str(d64), 64, "rgb", height=2 * h), "rgb", None))
        keys = {"feedback-ghost-nv12": "slice", "feedback-ghost-nv12 traced": "slice", "xbr-lv2": "xbr",
                "ntsc-320px": "ntsc", "crt-mattias traced": "mattias", "warp-curve traced": "warp",
                "nnedi3 nns64 -rgb": "nnedi3"}
        for name, path, fmt, param in paths:
            batch = batches[keys[name]]
            shape = (batch, h * 3 // 2, w) if fmt == "nv12" else (batch, h, w, 3)
            frames = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
            e = Engine(viewport=cs.VIEWPORT, device=dev)
            assert e.load_preset(str(path)), e.last_error
            e.set_input_format(fmt)
            if param is not None:
                e.set_param_mode("traced")
            with cs.env(RCTPU_REPLAY="0"):
                e.apply(frames, output="u8")
                row = walk(name, lambda: e.apply(frames, output="u8"))
            row["batch"] = batch
            out["paths"].append(row)
            del e, frames
        p = cs._stream_pipeline(Engine, dev)
        from retrocapture_tpu_torch.io.testpattern import TestPatternSource

        src = TestPatternSource(w, h)
        frames = torch.from_numpy(np.stack([src.capture_frame() for _ in range(batches["pipeline"])])).to(dev)
        p.process(frames)
        row = walk("FramePipeline.process", lambda: p.process(frames))
        row["batch"] = batches["pipeline"]
        out["paths"].append(row)
    for row in out["paths"]:
        print(f"{row['path']} (batch {row['batch']}): {row['launches']} launches, {row['bytes'] / 1e6:.1f} MB an apply"
              f"  ({card})")
        for f in row["forms"]:
            ops = ", ".join("scalar" if o is None else f"{o['shape']} strides {o['strides']}" for o in f["operands"])
            print(f"  {f['launches']} x {f['mode']}({ops}) -> {f['out']}: {f['path']} {'/'.join(f['kinds'])}, "
                  f"{f['bytes'] / 1e6:.2f} MB a launch")
    d = REPO / "chiprun_out"
    d.mkdir(exist_ok=True)
    (d / "fma_forms.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
