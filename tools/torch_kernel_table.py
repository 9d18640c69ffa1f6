#!/usr/bin/env python3
"""The port's kernel table on one NVIDIA card: each hand kernel's time at
the shapes of PERF.md's kernel table, its roofline bound and share, the
PyTorch library call that computes the same function where there is one,
and how often the main paths launch and replay it.

    python3 tools/torch_kernel_table.py

Each main path (and the variants whose kernels the table times) runs
first at the benchmark's shapes through a walked engine
(``RCTPU_REPLAY=0``) and a replaying one, two applies each: a row's
``launches`` are its kernel's launch calls in both second applies, summed
over the paths, its ``graph_runs`` the kernel's runs inside the replayed
apply's CUDA graph (the benchmark's ``harness/trace.py`` profiler). The
walks record the xbr, crt-mattias epilogue and multiply-add inputs the
rows time; crt-mattias's old output pow and multiply-add (rows M and F)
and nnedi3's old exp (M'), which the epilogue and nnedi3 kernels compute
now, are timed on random inputs of their shapes, and the nnedi3 kernel
(row N) on random textures and nets at the benchmark cell's four passes,
beside its plain version.

A time is the mean of CUDA events around a window of many calls queued
behind a spin kernel, in turns with the library call (kernel, library,
library, kernel). The bound is ``bench_torch/harness/peaks.py``'s, on
``bench_torch/work/<kernel>.py``'s work where the benchmark has one;
``max_abs_err`` the largest difference from the plain version on the
same inputs. Prints a line a path and a row, the card's name and power
limit, and as its last line the table as JSON. It checks nothing
(``tests/test_torch_cuda.py`` does) and exits non-zero without a card.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench_torch"
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(BENCH)]

from harness import peaks  # noqa: E402
from harness.spec import load_module  # noqa: E402

VIEWPORT = (1920, 1080)  # (W, H)
SRC_HW = (240, 320)
FEEDBACK = ROOT / "assets" / "presets" / "feedback-ghost.glslp"
SPIN_CYCLES = 100_000_000  # ~50 ms of spin at the H100's SM clock: a window's launches queue up behind it
WINDOW_MS = 20.0  # the device time a window aims at

# Each kernel of the table: (its source under retrocapture_tpu_torch/csrc,
# the reference's TPU kernel it ports, or what it replaces where none).
KERNELS = {
    "resample_u8": ("resample_u8.cu", "retrocapture_tpu/ops/pallas/resample.py:290"),
    "resample_xphase": ("resample_xphase.cu", "retrocapture_tpu/ops/pallas/resample.py:220"),
    "warp_sample": ("warp_sample.cu", "retrocapture_tpu/ops/pallas/warp_sample.py:204"),
    "blur_groups_v2": ("blur_groups.cu", "retrocapture_tpu/ops/pallas/blur_groups.py:515"),
    "blur_groups_v1": ("blur_groups.cu", "retrocapture_tpu/ops/pallas/blur_groups.py:221"),
    "xbr_epilogue": ("xbr_epilogue.cu", "retrocapture_tpu/ops/pallas/xbr_epilogue.py:58"),
    "xbr_front": ("xbr_front.cu", "none, XLA's fusion of the front section of retrocapture_tpu/graph/kernels.py:340"),
    "mattias_epilogue": ("mattias_epilogue.cu",
                         "none, XLA's fusion of crt-mattias's epilogue, retrocapture_tpu/graph/kernels.py:189-226"),
    "nnedi3": ("nnedi3.cu", "none, XLA's fusion of nnedi3's pass, retrocapture_tpu/graph/kernels.py:_nnedi3_kernel"),
    "mirrors": ("mirrors.cu", "none, XLA's inline sin/log/exp in the reference's fusions"),
    "fma": ("fma.cu", "none, XLA's contracted multiply-adds in the reference's fusions"),
}


def work(kernel, batch, src_hw, out_hw):
    """(bytes, operations) of ``bench_torch/work/<kernel>.py``."""
    return load_module(BENCH / "work" / f"{kernel}.py").work(batch, src_hw, out_hw)


def warp_work(batch, src_hw, out_hw, c=4):
    """The warped tap: the texture and the coordinates read once, the
    output written once; 4 taps x C channels and the tap positions, 40
    operations a pixel at C = 4."""
    (h, w), (oh, ow) = src_hw, out_hw
    return 4 * (batch * h * w * c + 2 * oh * ow + batch * oh * ow * c), 40 * batch * oh * ow


def mirror_work(x, ops):
    """An elementwise f32 map: read once, written once; ``ops`` f32
    operations an element (log 11 FFMA, 5 FADD, 3 FMUL; exp 9, 1, 2; the
    pow log, an FMUL and exp, an FFMA counted as two)."""
    return 8 * x.numel(), ops * x.numel()


def fma_work(args):
    """``rctpu::fma`` on its operator arguments: each distinct tensor
    operand's own bytes read once (a broadcast dimension counts once) and
    the result written once; two operations an element. Its f64 operations
    would bound it only at a seventh of the bytes' time."""
    import torch

    tensors = [t for t in args[:3] if t is not None]
    numel = torch.broadcast_shapes(*(t.shape for t in tensors)).numel()
    views = {(t.data_ptr(), tuple(t.shape), t.stride()): t for t in tensors}
    own = 0
    for t in views.values():
        n = 4
        for size, stride in zip(t.shape, t.stride()):
            n *= size if stride else 1
        own += n
    return own + 4 * numel, 2 * numel


def _window(fn, n):
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def in_turns(*fns):
    """Mean milliseconds a call of each of ``fns``, timed in turns (a, b,
    b, a), each window WINDOW_MS of calls after a warm-up."""
    counts = []
    for fn in fns:
        fn()
        counts.append(max(3, min(200, int(WINDOW_MS / max(_window(fn, 1), 1e-3)))))
    times = [[] for _ in fns]
    for k in list(range(len(fns))) + list(reversed(range(len(fns)))):
        times[k].append(_window(fns[k], counts[k]))
    return [sum(t) / len(t) for t in times]


def max_err(got, want):
    """The largest difference of two outputs, equal NaNs and infinities 0."""
    import torch

    got, want = got.float(), want.float()
    same = (got == want) | (got.isnan() & want.isnan())
    return float(torch.where(same, 0.0, (got - want).abs()).max())


def run_path(preset, fmt, batch, env, recorders=()):
    """A walked engine and then a replaying one, each given ``batch``
    random frames at 1080p twice. Returns the launch calls of the two
    second applies (the counters read just before each), the kernels' runs
    inside the replayed apply's graph, and what each of ``recorders``
    recorded in the walked second apply."""
    import torch

    import _card
    from retrocapture_tpu_torch import Engine

    h, w = SRC_HW
    shape = (batch, h * 3 // 2, w) if fmt == "nv12" else (batch, h, w, 3)
    frames = torch.randint(0, 256, shape, device="cuda", dtype=torch.uint8)
    for replay in ("0", "1"):
        with mock.patch.dict(os.environ, {**env, "RCTPU_REPLAY": replay}):
            e = Engine(viewport=VIEWPORT)
            if not e.load_preset(str(preset)):
                raise RuntimeError(f"{preset}: {e.last_error}")
            e.set_input_format(fmt)
            e.apply(frames, output="u8")
            torch.cuda.synchronize()
            before = _card.counts()
            with contextlib.ExitStack() as stack:
                recs = [stack.enter_context(r) for r in recorders] if replay == "0" else None
                e.apply(frames, output="u8")
                torch.cuda.synchronize()
            calls = _card.since(before)
            if replay == "0":
                walked, recorded = calls, recs
            else:
                runs = _card.kernel_runs(lambda: e.apply(frames, output="u8"), walked)
            del e
            gc.collect()
            torch.cuda.empty_cache()
    launches = {k: walked[k] + calls[k] for k in walked}
    graph_runs = {k: runs[k] - calls[k] for k in runs}
    blur = "blur_groups_v1" if env.get("RCTPU_BLUR") == "v1" else "blur_groups_v2"
    for d in (launches, graph_runs):
        d[blur] = d.pop("blur_groups")
    return launches, graph_runs, recorded


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_table: no CUDA card")
    import numpy as np
    import torch.nn.functional as F

    import _card
    import _nnedi3_cases as nnedi3_cases
    from _mattias_standin import write_standin as write_mattias
    from _nnedi3_standin import write_chain as write_nnedi3
    from _ntsc_standin import write_chain as write_ntsc
    from _presets import write_xphase_preset
    from _xbr_standin import write_standin as write_xbr
    from retrocapture_tpu_torch.graph.kernels import _F, mattias_groups, mattias_uv
    from retrocapture_tpu_torch.ops.cuda import blur_groups as bg
    from retrocapture_tpu_torch.ops.cuda import fma as fm
    from retrocapture_tpu_torch.ops.cuda import mattias_epilogue as me
    from retrocapture_tpu_torch.ops.cuda import mirrors as mr
    from retrocapture_tpu_torch.ops.cuda import nnedi3 as nn
    from retrocapture_tpu_torch.ops.cuda import resample as rs
    from retrocapture_tpu_torch.ops.cuda import warp_sample as ws
    from retrocapture_tpu_torch.ops.cuda import xbr_epilogue as xe
    from retrocapture_tpu_torch.ops.cuda import xbr_front as xf

    torch.manual_seed(20261018)
    (h, w), (vw, vh) = SRC_HW, VIEWPORT
    launches, graph_runs = dict.fromkeys(KERNELS, 0), dict.fromkeys(KERNELS, 0)
    paths, recorded = {}, {}
    with tempfile.TemporaryDirectory() as td:
        def own(name):
            d = Path(td) / name
            d.mkdir()
            return str(d)

        # name: (preset, input format, batch, environment, recorders)
        mattias = write_mattias(own("crt-mattias"))
        for name, (preset, fmt, batch, env, recorders) in {
            "feedback-ghost-nv12": (FEEDBACK, "nv12", 128, {}, (_card.fma_forms,)),
            "feedback-ghost-nv12 RCTPU_XPHASE=on": (write_xphase_preset(Path(own("xphase")), FEEDBACK.with_suffix(
                ".glsl"), w, h), "nv12", 128, {"RCTPU_XPHASE": "on"}, ()),
            "crt-mattias": (mattias, "rgb", 32, {}, (lambda: _card.launched(me, "_mattias_epilogue_op"),)),
            "crt-mattias RCTPU_BLUR=v1": (mattias, "rgb", 32, {"RCTPU_BLUR": "v1"}, ()),
            "crt-mattias RCTPU_MATTIAS=preconv": (mattias, "rgb", 32, {"RCTPU_MATTIAS": "preconv"}, ()),
            "xbr-lv2": (write_xbr(own("xbr-lv2")), "rgb", 64, {}, (lambda: _card.launched(xe, "_xbr_epilogue_op"),
                                                                  lambda: _card.launched(xf, "_xbr_front_op"))),
            "ntsc-320px": (write_ntsc(own("ntsc-320px"), 4 * w), "rgb", 128, {}, ()),
            "nnedi3 nns64 -rgb": (write_nnedi3(own("nnedi3"), 64, "rgb", height=2 * h), "rgb", 32, {}, ()),
        }.items():
            path_launches, path_graph_runs, recorded[name] = run_path(preset, fmt, batch, env,
                                                                      [r() for r in recorders])
            paths[name] = {"batch": batch, "launches": path_launches, "graph_runs": path_graph_runs}
            for k in path_launches:
                launches[k] += path_launches[k]
                graph_runs[k] += path_graph_runs[k]
            print(f"{name} [{batch}]: launch calls {path_launches}; graph runs {path_graph_runs}", flush=True)

    rows = []

    def row(rid, kernel, shape, fn, plain, bound_work, library=None, library_fn=None, time_plain=False, err=None):
        """``err``: the largest difference from the plain version where
        ``fn()`` is not one output; ``time_plain``: time the plain version
        beside the kernel."""
        err = max_err(fn(), plain()) if err is None else err
        ms = in_turns(*[f for f in (fn, library_fn, plain if time_plain else None) if f])
        b_ms, b_by = peaks.bound(*bound_work)
        source, replaces = KERNELS[kernel]
        rows.append({"row": rid, "name": kernel, "route": "cuda", "source": f"retrocapture_tpu_torch/csrc/{source}",
                     "replaces": replaces, "shape": shape, "launches": launches[kernel],
                     "graph_runs": graph_runs[kernel], "in_graph": graph_runs[kernel] > 0, "max_abs_err": err,
                     "ms": ms[0], "bound_ms": b_ms, "bound_by": b_by, "share_pct": 100.0 * b_ms / ms[0],
                     "library": library, "library_ms": ms[1] if library_fn else None,
                     "plain_ms": ms[-1] if time_plain else None})
        r = rows[-1]
        print(f"{rid:>4} {kernel:<15} {shape:<58} {r['ms']:9.4f} ms  bound {b_ms:.4f} ({b_by}) "
              f"{r['share_pct']:5.1f}%  err {err:g}" + (f"  {library} {r['library_ms']:.4f} ms" if library_fn else "")
              + (f"  plain {r['plain_ms']:.4f} ms" if time_plain else ""), flush=True)

    # 1, 1', 3: the blit with its u8 pack, through blit_u8's cached tables.
    def interp(t):
        nchw = t.permute(0, 3, 1, 2).contiguous()
        return lambda: F.interpolate(nchw, size=(vh, vw), mode="bilinear", align_corners=False)

    def blit_plain(t):
        mats = rs.blit_matrices(*t.shape[1:3], vw, vh)
        return lambda: rs.resample_u8_plain(t, *(None if a is None else torch.from_numpy(a).cuda() for a in mats))

    tex = torch.rand((128, h, w, 3), device="cuda")
    full = torch.rand((128, vh, vw, 3), device="cuda")
    row("1", "resample_u8", "[128,240,320,3] -> u8 [128,1080,1920,3]", lambda: rs.blit_u8(tex, vw, vh),
        blit_plain(tex), work("resample_u8", 128, SRC_HW, (vh, vw)), "F.interpolate", interp(tex))
    row("1'", "resample_u8", "[128,1080,1920,3] -> same", lambda: rs.blit_u8(full, vw, vh), blit_plain(full),
        work("resample_u8", 128, (vh, vw), (vh, vw)), "F.interpolate", interp(full))
    del full
    with mock.patch.dict(os.environ, {"RCTPU_XPHASE": "on"}):
        row("3", "resample_xphase", "[128,240,320,3] -> u8 [128,1080,1920,3]", lambda: rs.blit_u8(tex, vw, vh),
            blit_plain(tex), work("resample_u8", 128, SRC_HW, (vh, vw)), "F.interpolate", interp(tex))
    del tex

    # 2, 2': the warped LINEAR clamp_to_border tap on the curvature warp.
    y = (torch.arange(vh, device="cuda", dtype=torch.float32) + 0.5) / vh - 0.5
    x = (torch.arange(vw, device="cuda", dtype=torch.float32) + 0.5) / vw - 0.5
    cy, cx = torch.meshgrid(y, x, indexing="ij")
    k = 1.0 + 0.25 * (cx * cx + cy * cy)
    u, v = (0.5 + cx * k).contiguous(), (0.5 + cy * k).contiguous()
    for rid, b in (("2", 8), ("2'", 1)):
        wtex = torch.rand((b, h, w, 4), device="cuda")
        grid = torch.stack([u * 2.0 - 1.0, v * 2.0 - 1.0], dim=-1)[None].expand(b, -1, -1, -1)
        nchw = wtex.permute(0, 3, 1, 2).contiguous()
        row(rid, "warp_sample", f"[{b},240,320,4] @ {b}x1080p LINEAR",
            lambda: ws._warp_sample_op(wtex, u, v, True, "clamp_to_border"),
            lambda: ws.warp_sample_plain(wtex, u, v, filter_linear=True, wrap_mode="clamp_to_border"),
            warp_work(b, SRC_HW, (vh, vw)), "F.grid_sample",
            lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=False))

    # 4, 4', 5, 5': crt-mattias's blur at its own coordinates, v2 and v1.
    btex = torch.rand((32, h, w, 3), device="cuda") ** 2.2
    bu, bv = mattias_uv(vw, vh, 0.5, "cuda", cross=True)
    groups = mattias_groups(vw, vh)
    blur_plain = _card.RECORDED["blur_groups"][2]
    for rid, mode in (("4", "v2"), ("5", "v1")):
        with mock.patch.dict(os.environ, {"RCTPU_BLUR": mode}), _card.launched(bg, "_blur_groups_op") as calls:
            bg.blur5x5_groups(btex, bu, bv, groups)
        for r, b in ((rid, 32), (rid + "'", 1)):
            one = (calls[0][0][:b],) + calls[0][1:]
            row(r, f"blur_groups_{mode}", f"{mode} [{b},240,320,3] -> 9 groups @ 1080p",
                lambda: bg._blur_groups_op(*one), lambda: blur_plain(*one), work("blur_groups", b, SRC_HW, (vh, vw)))
    del btex, one, calls

    # 6, 6', X: xbr-lv2's epilogue and front section, as its walk launched them.
    epi, front = recorded.pop("xbr-lv2")
    for r, b in (("6", 64), ("6'", 1)):
        a = (epi[0][0][:b],) + epi[0][1:]
        row(r, "xbr_epilogue", f"S [{b},19,1080,320] -> [{b},1080,1920,4]", lambda: xe._xbr_epilogue_op(*a),
            lambda: _card.RECORDED["xbr_epilogue"][2](*a), work("xbr_epilogue", b, SRC_HW, (vh, vw)))
    a = front[0]
    row("X", "xbr_front", "[64,240,320,4] -> S [64,19,1080,320]", lambda: xf._xbr_front_op(*a),
        lambda: _card.RECORDED["xbr_front"][2](*a), work("xbr_front", 64, SRC_HW, (vh, vw)))
    del epi, front, a

    # E: crt-mattias's epilogue, as its walk launched it.
    a = recorded.pop("crt-mattias")[0][0]
    row("E", "mattias_epilogue", "3 planes [32,1080,1920] -> RGBA [32,1080,1920,4]",
        lambda: me._mattias_epilogue_op(*a), lambda: me.mattias_epilogue_plain(*a),
        work("mattias_epilogue", 32, SRC_HW, (vh, vw)))
    del a

    # N: nnedi3's pass kernel at the benchmark cell's four passes, batch 16
    # (nns64 doubling 240x320 to 480x320 and then to 480x640, nns32 to
    # 960x640 and 960x1280, -rgb), random RGBA8 levels and nets; beside it
    # the plain version (the eager section the kernel replaced), frame by
    # frame. The bound is the benchmark's work formula (work/nnedi3.py).
    stages = [(64, (240, 320), (480, 320)), (64, (480, 320), (480, 640)), (32, (480, 640), (960, 640)),
              (32, (960, 640), (960, 1280))]
    nets = {nns: nnedi3_cases.net(nns, nns, "cuda") for nns in (64, 32)}
    passes = [(nnedi3_cases.texture(np.random.default_rng(k), (16,) + hw + (4,), "cuda"), nns, k % 2)
              for k, (nns, hw, _) in enumerate(stages)]
    err = 0.0
    for tex, nns, axis in passes:
        err = max(err, max_err(nn.nnedi3(tex, *nets[nns], axis=axis, comps=3),
                               nn.nnedi3_plain(tex, *nets[nns], axis, 3)))
    row("N", "nnedi3", "4 passes [16,240,320,4] -> [16,960,1280,4]",
        lambda: [nn.nnedi3(tex, *nets[nns], axis=axis, comps=3) for tex, nns, axis in passes],
        lambda: [nn.nnedi3_plain(tex, *nets[nns], axis, 3) for tex, nns, axis in passes],
        load_module(BENCH / "work" / "nnedi3.py").work(16, stages), time_plain=True, err=err)
    del passes, nets

    # M, M': the mirrors at crt-mattias's old output gamma (pow 0.45 of RGB
    # at [32, 1080, 1920]) and at nnedi3's old exp (the nns64 chain's second
    # pass at batch 32, before the kernel N computed it), random values.
    c045 = float(_F(_F(_F(0.45) * _F(1.0 / np.log(2.0))) * _F(np.log(2.0))))
    for rid, (xm, op, c), ops in (("M", (torch.rand((32, vh, vw, 3), device="cuda"), "pow", c045), 52),
                                  ("M'", (torch.rand((32, 64, 460800), device="cuda") * 12.0 - 8.0, "exp", 0.0),
                                   21)):
        row(rid, "mirrors", f"{op}{f' {c:.6g}' if op == 'pow' else ''} {list(xm.shape)}",
            lambda: mr._mirror_op(xm, op, c), lambda: mr.mirror_plain(xm, op, c), mirror_work(xm, ops))
        del xm

    # F - F''': rctpu::fma at crt-mattias's old saturation step fma32(col,
    # col, -col) over [32, 1080, 1920, 3] (random values) and at
    # feedback-ghost's mix and LINEAR axis sums, beside torch.addcmul.
    col = torch.rand((32, vh, vw, 3), device="cuda")
    picks = [("F", "crt-mattias col, col, -col", (col, col, -col, 0.0, 0.0, 0.0, 0))]
    del col
    forms = [f[1] for f in recorded.pop("feedback-ghost-nv12")[0].values()]
    for rid, what, shape in (("F'", "feedback-ghost mix", (4,)), ("F''", "feedback-ghost row weight", (vh, 1, 1)),
                             ("F'''", "feedback-ghost column weight", (1, vw, 1))):
        picks.append((rid, what, next(a for a in forms if any(t is not None and tuple(t.shape) == shape
                                                              for t in a[:3]))))
    del forms, recorded
    for rid, what, a in picks:
        ops = [s if t is None else t for t, s in zip(a[:3], a[3:6])]
        ta, tb, tc = (t if isinstance(t, torch.Tensor) else torch.tensor(t, device="cuda") for t in ops)
        shapes = ", ".join("scalar" if t is None else str(list(t.shape)) for t in a[:3])
        row(rid, "fma", f"{what}: {'fma32' if a[6] == 0 else 'fmaf32'}({shapes}) {fm.PATH_NAMES[fm._plan(a[:3]).path]}",
            lambda: fm._fma_call(*a), lambda: fm.fma_plain(*ops, a[6]), fma_work(a), "torch.addcmul",
            lambda: torch.addcmul(tc, ta, tb))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"card": card, "device": device, "paths": paths, "kernels": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
