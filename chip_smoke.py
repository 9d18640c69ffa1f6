#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``retrocapture_tpu_torch/csrc`` (into
``build/kernels/``), holds each against its plain torch version on the
card, drives the main path (``Engine.load_preset`` + ``Engine.apply``) at
full size for the feedback-ghost-nv12 slice and for a warped curvature
pass, compares both with the port's own CPU run, and times the kernels
(device time from torch.profiler, and per call with CUDA events) and the
slice. Prints one line per phase, the kernel
table as a JSON line, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the run
exits non-zero and prints no result; so does a machine without CUDA. It
imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PRESET = REPO / "assets" / "presets" / "feedback-ghost.glslp"
VIEWPORT = (1920, 1080)  # (W, H)
SRC_HW = (240, 320)
SLICE_BATCH = 128
WARP_BATCH = 8
DEV = "cuda"  # the card; the checks below never fall back to the CPU

WARP_GLSLP = """shaders = 1
shader0 = warp-curve.glsl
filter_linear0 = true
wrap_mode0 = clamp_to_border
scale_type0 = viewport
scale0 = 1.0
"""

WARP_GLSL = """#pragma parameter CURV "Curvature" 0.25 0.0 1.0 0.05

#if defined(VERTEX)

attribute vec4 VertexCoord;
attribute vec4 TexCoord;
varying vec2 vTexCoord;
uniform mat4 MVPMatrix;

void main()
{
    gl_Position = MVPMatrix * VertexCoord;
    vTexCoord = TexCoord.xy;
}

#elif defined(FRAGMENT)

varying vec2 vTexCoord;
uniform sampler2D Texture;

#ifdef PARAMETER_UNIFORM
uniform float CURV;
#else
#define CURV 0.25
#endif

void main()
{
    vec2 cc = vTexCoord - 0.5;
    float r2 = dot(cc, cc);
    gl_FragColor = texture2D(Texture, 0.5 + cc * (1.0 + CURV * r2));
}

#endif
"""

# (batch, src_h, src_w, dst_h, dst_w): the blit at the main path's own
# shape (the slice's batch), the same geometry at B=8, the other
# geometries of tests/test_kernels_resample.py, and x-only (src_h ==
# dst_h) and y-only (src_w == dst_w) cases.
RESAMPLE_GEOMETRIES = [
    (SLICE_BATCH, 240, 320, 1080, 1920),
    (8, 240, 320, 1080, 1920),
    (2, 240, 640, 1080, 1920),
    (2, 240, 320, 240, 1920),
    (2, 333, 640, 333, 1920),
    (2, 240, 320, 1077, 1920),
    (2, 96, 128, 192, 256),
    (2, 240, 320, 1080, 320),
]
TRUTH_CHUNK = 16  # frames per f64 truth computation (bounds its memory)


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def event_ms(fn, iters):
    """Mean milliseconds per call of fn over iters launches (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters):
    """Mean device milliseconds per call of fn: the summed duration of the
    device work (kernels and copies) that iters calls enqueue, from
    torch.profiler's CUDA activity. Host time between launches is not in
    it, so a wrapper's host-side set-up does not count as kernel time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        total_us += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
    check(total_us > 0, "torch.profiler recorded no device time")
    return total_us / 1e3 / iters


def in_turns(plain, kernel, iters, timer):
    """(plain_ms, kernel_ms) measured in turns: plain, kernel, kernel, plain."""
    for f in (plain, kernel):
        f()
    import torch

    torch.cuda.synchronize()
    p1 = timer(plain, iters)
    k1 = timer(kernel, iters)
    k2 = timer(kernel, iters)
    p2 = timer(plain, iters)
    return (p1 + p2) / 2, (k1 + k2) / 2


def knife_tex(gen, shape, device):
    """Random f32 texture, half of it exactly on the u8 grid (n/255), where
    a one-ulp difference flips the quantized output."""
    import torch

    t = torch.rand(shape, generator=gen, device=device)
    grid = torch.randint(0, 256, shape, generator=gen, device=device).float() / 255.0
    pick = torch.rand(shape, generator=gen, device=device) < 0.5
    return torch.where(pick, grid, t).contiguous()


def _truth_u8(tex, ay_t, ax_t):
    """The blit in f64 on the card: its quantized u8 codes and the mask
    of knife-edge values (within 1e-4 of a .5 code boundary)."""
    import torch

    t64 = tex.double()
    if ay_t is not None:
        t64 = torch.einsum("os,bshc->bohc", ay_t.double(), t64)
    if ax_t is not None:
        t64 = torch.einsum("pt,botc->bopc", ax_t.double(), t64)
    scaled = t64.clamp(0.0, 1.0) * 255.0
    edge = (scaled - torch.floor(scaled) - 0.5).abs() < 1e-4
    return torch.round(scaled).to(torch.int32), edge


def phase_resample(gen):
    import torch

    from retrocapture_tpu_torch.ops.cuda import resample as rs

    worst = 0
    for b, h, w, oh, ow in RESAMPLE_GEOMETRIES:
        ay, ax = rs.blit_matrices(h, w, ow, oh)
        tex = knife_tex(gen, (b, h, w, 3), DEV)
        got = rs.resample_u8(tex, ay, ax)
        ay_t = None if ay is None else torch.from_numpy(ay).to(DEV)
        ax_t = None if ax is None else torch.from_numpy(ax).to(DEV)
        plain = rs.resample_u8_plain(tex, ay_t, ax_t)
        check(got.shape == (b, oh, ow, 3) and got.dtype == torch.uint8, f"resample shape {tuple(got.shape)}")
        what = f"{b}x{h}x{w} -> {oh}x{ow}"
        for s in range(0, b, TRUTH_CHUNK):
            q64, edge = _truth_u8(tex[s : s + TRUTH_CHUNK], ay_t, ax_t)
            for label, out in (("kernel", got), ("plain", plain)):
                d = (out[s : s + TRUTH_CHUNK].to(torch.int32) - q64).abs()
                check(int(d.max()) <= 1, f"resample {label} {what}: {int(d.max())} steps from f64 truth")
                off = int((d[~edge] != 0).sum())
                check(off == 0, f"resample {label} {what}: {off} non-knife-edge pixels off the f64 truth")
            del q64, edge
        kd = int((got.to(torch.int32) - plain.to(torch.int32)).abs().max())
        worst = max(worst, kd)
        say("3", f"resample_u8 {what}: ok (kernel vs plain max {kd} step)")
        del got, plain, tex
    return worst


def curvature_uv(ho, wo, device, curv=0.25):
    import torch

    y = (torch.arange(ho, device=device, dtype=torch.float32) + 0.5) / ho
    x = (torch.arange(wo, device=device, dtype=torch.float32) + 0.5) / wo
    cy, cx = torch.meshgrid(y - 0.5, x - 0.5, indexing="ij")
    k = 1.0 + curv * (cx * cx + cy * cy)
    return (0.5 + cx * k).contiguous(), (0.5 + cy * k).contiguous()


def phase_warp(gen):
    import torch

    from retrocapture_tpu_torch.ops.cuda import warp_sample as ws
    from retrocapture_tpu_torch.ops.sampling import WRAP_MODES

    ho, wo = VIEWPORT[1], VIEWPORT[0]
    tex = torch.rand((SRC_HW[0], SRC_HW[1], 4), generator=gen, device=DEV)
    u, v = curvature_uv(ho, wo, DEV)
    # Out-of-range, NaN and +-inf coordinates in a few rows.
    noise_u = torch.rand((ho, wo), generator=gen, device=DEV) * 3.0 - 1.0
    noise_v = torch.rand((ho, wo), generator=gen, device=DEV) * 3.0 - 1.0
    rows = torch.arange(ho, device=DEV)[:, None] % 97 == 0
    u = torch.where(rows, noise_u, u)
    v = torch.where(rows, noise_v, v)
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e10, -1e10, 3e9], device=DEV)
    u[1, : len(specials)] = specials
    v[2, : len(specials)] = specials
    u[3, : len(specials)] = specials
    v[3, : len(specials)] = specials.flip(0)
    worst = 0.0
    for lin in (False, True):
        for mode in WRAP_MODES:
            got = ws.warp_sample(tex, u, v, filter_linear=lin, wrap_mode=mode)
            want = ws.warp_sample_plain(tex, u, v, filter_linear=lin, wrap_mode=mode)
            torch.cuda.synchronize()
            check(got.shape == (ho, wo, 4), f"warp shape {tuple(got.shape)}")
            nan_g, nan_w = torch.isnan(got), torch.isnan(want)
            check(bool((nan_g == nan_w).all()), f"warp {mode} linear={lin}: NaN positions differ")
            if not lin:
                check(bool(torch.equal(got, want)), f"warp NEAREST {mode}: not bit-equal")
                err = 0.0
            else:
                err = float((got - want).abs().masked_fill(nan_g, 0.0).max())
                check(err <= 2e-6, f"warp LINEAR {mode}: max |d| {err:.3e} > 2e-6")
            worst = max(worst, err)
            say("4", f"warp_sample {'LINEAR' if lin else 'NEAREST'} {mode}: ok (max |d| {err:.3e})")
    return worst, (tex, u, v)


def _cmp_u8(a, b, what):
    import torch

    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    frac = float((d != 0).float().mean())
    check(int(d.max()) <= 1, f"{what}: max |d| {int(d.max())} u8 steps (limit 1)")
    check(frac <= 1e-3, f"{what}: {frac:.2e} of values differ (limit 1e-3)")
    return int(d.max()), frac


def _engine_ok(e, what):
    check(e.shader_active is True, f"{what}: shader_active is {e.shader_active} ({e.last_error})")
    check(e.last_error is None, f"{what}: last_error {e.last_error}")


def phase_slice(gen, Engine):
    import torch

    from retrocapture_tpu_torch.ops.cuda import resample as rs

    h, w = SRC_HW
    frames = torch.randint(0, 256, (SLICE_BATCH, h * 3 // 2, w), generator=gen, device=DEV, dtype=torch.uint8)
    e = Engine(viewport=VIEWPORT, device=DEV)
    check(e.load_preset(str(PRESET)), f"load_preset: {e.last_error}")
    e.set_input_format("nv12")
    before = rs.LAUNCHES
    for i in range(3):
        out = e.apply(frames, output="u8")
        torch.cuda.synchronize()
        _engine_ok(e, f"slice apply {i}")
        check(tuple(out.shape) == (SLICE_BATCH, VIEWPORT[1], VIEWPORT[0], 3), f"slice shape {tuple(out.shape)}")
        check(out.dtype == torch.uint8 and out.device.type == torch.device(DEV).type, f"slice dtype {out.dtype} on {out.device}")
    check(rs.LAUNCHES > before, "slice: the resample_u8 kernel was not launched")
    check(int(e._states[(h, w) + VIEWPORT].frame_count) == 3 * SLICE_BATCH, "slice: frame count not carried")
    # The first 2 frames on a fresh CUDA engine against the port's CPU run.
    outs = []
    for dev in (DEV, "cpu"):
        e2 = Engine(viewport=VIEWPORT, device=dev)
        check(e2.load_preset(str(PRESET)), f"load_preset {dev}")
        e2.set_input_format("nv12")
        o = e2.apply(frames[:2].to(dev), output="u8")
        _engine_ok(e2, f"slice {dev} reference run")
        outs.append(o.cpu())
    dmax, frac = _cmp_u8(outs[0], outs[1], "slice cuda vs cpu")
    say("5", f"feedback-ghost-nv12 {SLICE_BATCH}x{h}x{w} nv12 -> {VIEWPORT[1]}x{VIEWPORT[0]} u8, 3 applies: ok "
        f"(cuda vs cpu on 2 frames: max {dmax} step, {frac:.2e} of values)")
    return e, frames


def phase_warp_pass(gen, Engine, tmp):
    import torch

    from retrocapture_tpu_torch.ops.cuda import warp_sample as ws

    (tmp / "warp-curve.glslp").write_text(WARP_GLSLP)
    (tmp / "warp-curve.glsl").write_text(WARP_GLSL)
    h, w = SRC_HW
    frames = torch.randint(0, 256, (WARP_BATCH, h, w, 3), generator=gen, device=DEV, dtype=torch.uint8)
    e = Engine(viewport=VIEWPORT, device=DEV)
    check(e.load_preset(str(tmp / "warp-curve.glslp")), f"load warp preset: {e.last_error}")
    before = ws.LAUNCHES
    for i in range(3):
        out = e.apply(frames, output="u8")
        torch.cuda.synchronize()
        _engine_ok(e, f"warp apply {i}")
        check(tuple(out.shape) == (WARP_BATCH, VIEWPORT[1], VIEWPORT[0], 3), f"warp pass shape {tuple(out.shape)}")
        check(out.dtype == torch.uint8, f"warp pass dtype {out.dtype}")
    check(ws.LAUNCHES > before, "warp pass: the warp_sample kernel was not launched")
    f32 = e.apply(frames[:1], output="f32")
    check(bool(torch.isfinite(f32).all()), "warp pass: non-finite f32 output")
    corner = f32[0, 0, 0]
    check(bool((corner == 0).all()), "warp pass: the clamp_to_border corner is not black")
    outs = []
    for dev in (DEV, "cpu"):
        e2 = Engine(viewport=VIEWPORT, device=dev)
        check(e2.load_preset(str(tmp / "warp-curve.glslp")), f"load warp preset {dev}")
        outs.append(e2.apply(frames[:2].to(dev), output="u8").cpu())
        _engine_ok(e2, f"warp {dev} reference run")
    dmax, frac = _cmp_u8(outs[0], outs[1], "warp pass cuda vs cpu")
    say("6", f"warp-curve {WARP_BATCH}x{h}x{w} rgb -> {VIEWPORT[1]}x{VIEWPORT[0]} u8, 3 applies: ok "
        f"(cuda vs cpu on 2 frames: max {dmax} step, {frac:.2e} of values)")
    return e, frames


def main() -> int:
    if not (REPO / "retrocapture_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke: retrocapture_tpu_torch is not beside this script")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU")
    sys.path.insert(0, str(REPO))

    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = smi.strip()
    say("1", f"card: {card}")
    say("1", f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    from retrocapture_tpu_torch import Engine
    from retrocapture_tpu_torch.ops.cuda import _build
    from retrocapture_tpu_torch.ops.cuda import resample as rs
    from retrocapture_tpu_torch.ops.cuda import warp_sample as ws

    # Phase 2: build.
    secs = _build.build_all()
    say("2", f"built {', '.join(_build.KERNELS)} into {_build.BUILD_DIR} in {secs:.2f} s")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("2", f"{name}: {line.strip()}")

    gen = torch.Generator(device=DEV)
    gen.manual_seed(20261016)

    # Phases 3-4: each kernel against its plain version.
    rs_err = phase_resample(gen)
    ws_err, (wtex, wu, wv) = phase_warp(gen)

    # Phases 5-6: the main path, counted from zero.
    rs.LAUNCHES = 0
    ws.LAUNCHES = 0
    eng, nv12 = phase_slice(gen, Engine)
    slice_launches = rs.LAUNCHES
    with tempfile.TemporaryDirectory() as td:
        weng, wframes = phase_warp_pass(gen, Engine, Path(td))
        launches = {"resample_u8": rs.LAUNCHES, "warp_sample": ws.LAUNCHES}
        check(slice_launches > 0 and launches["warp_sample"] > 0, f"main-path launches {launches}")
        say("5-6", f"main-path launches: {launches}")

        # Phase 7: timings, in turns, at the slice's shapes.
        h, w = SRC_HW
        tex = knife_tex(gen, (SLICE_BATCH, h, w, 3), DEV)
        ay, ax = rs.blit_matrices(h, w, VIEWPORT[0], VIEWPORT[1])
        ay_t, ax_t = torch.from_numpy(ay).to(DEV), torch.from_numpy(ax).to(DEV)
        rs_fns = (lambda: rs.resample_u8_plain(tex, ay_t, ax_t), lambda: rs.resample_u8(tex, ay, ax))
        rs_plain, rs_ms = in_turns(*rs_fns, 10, device_ms)
        rs_plain_ev, rs_ev = in_turns(*rs_fns, 10, event_ms)
        say("7", f"resample_u8 [{SLICE_BATCH},{h},{w},3] -> [{SLICE_BATCH},1080,1920,3]: device time kernel "
            f"{rs_ms:.3f} ms, plain {rs_plain:.3f} ms; per call (CUDA events, wrapper's host work included) "
            f"kernel {rs_ev:.3f} ms, plain {rs_plain_ev:.3f} ms  ({card})")
        wu0, wv0 = curvature_uv(VIEWPORT[1], VIEWPORT[0], DEV)
        ws_fns = (
            lambda: ws.warp_sample_plain(wtex, wu0, wv0, filter_linear=True, wrap_mode="clamp_to_border"),
            lambda: ws.warp_sample(wtex, wu0, wv0, filter_linear=True, wrap_mode="clamp_to_border"),
        )
        ws_plain, ws_ms = in_turns(*ws_fns, 100, device_ms)
        ws_plain_ev, ws_ev = in_turns(*ws_fns, 100, event_ms)
        say("7", f"warp_sample [{h},{w},4] @ [1080,1920] LINEAR: device time kernel {ws_ms:.4f} ms, plain "
            f"{ws_plain:.3f} ms; per call (CUDA events) kernel {ws_ev:.4f} ms, plain {ws_plain_ev:.3f} ms  ({card})")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_apply = 2
        for _ in range(n_apply):
            eng.apply(nv12, output="u8")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fps = n_apply * SLICE_BATCH / dt
        say("7", f"feedback-ghost-nv12 slice: {fps:.1f} frames/s at batch {SLICE_BATCH} "
            f"({dt / n_apply * 1e3:.1f} ms per apply)  ({card})")
        t0 = time.perf_counter()
        weng.apply(wframes, output="u8")
        torch.cuda.synchronize()
        wdt = time.perf_counter() - t0
        say("7", f"warp-curve pass: {WARP_BATCH / wdt:.1f} frames/s at batch {WARP_BATCH}  ({card})")

    kernels = [
        {
            "name": "resample_u8",
            "route": "cuda",
            "source": "retrocapture_tpu_torch/csrc/resample_u8.cu",
            "replaces": "retrocapture_tpu/ops/pallas/resample.py:290",
            "launches": launches["resample_u8"],
            "max_abs_err": rs_err,
            "ms": rs_ms,
            "plain_ms": rs_plain,
        },
        {
            "name": "warp_sample",
            "route": "cuda",
            "source": "retrocapture_tpu_torch/csrc/warp_sample.cu",
            "replaces": "retrocapture_tpu/ops/pallas/warp_sample.py:204",
            "launches": launches["warp_sample"],
            "max_abs_err": ws_err,
            "ms": ws_ms,
            "plain_ms": ws_plain,
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
