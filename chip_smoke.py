#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``retrocapture_tpu_torch/csrc`` (into
``build/kernels/``, one nvcc per source, in parallel), holds each against
its plain torch version on the card, drives the main path
(``Engine.load_preset`` + ``Engine.apply``) at full size for the
feedback-ghost-nv12 slice, a warped curvature pass, the crt-mattias hand
kernel (default blur, ``RCTPU_BLUR=v1`` and ``RCTPU_MATTIAS=preconv``),
feedback-ghost under ``RCTPU_XPHASE=on`` and the xbr-lv2 hand kernel,
the program's front door (a ``FramePipeline`` fed through the frame queue's
``stream``, ``apply_streams``, ``apply_u8`` and the max-resolution clamp, two
``mipmap_input`` presets, and the command line in process), and the ntsc
2-phase and nnedi3 entries of the kernel library through their stand-ins,
then each slice path replayed by CUDA graph against the uncaptured walk
(``RCTPU_REPLAY=0``; phase 23, bit for bit, parameters traced where a path
says so: a stateless path is one walk and one graph replay an apply, its
kernels launched once for the batch) and the command line with
``--param-mode traced`` (phase 24), then the batched branch (phase 25: each
stateless path's replayed batch against the CPU port, fc-period grouping
against ``RCTPU_FC_GROUP=0``, ``apply_streams`` against engines of their
own, each batched kernel launch against its plain version on its own
inputs), then the numerics mirrors' kernel (phase 26: every f32 bit pattern
of sin, log, log2 and exp and a sample of each pow against the plain
versions, and its main-path calls timed; from phase 5 to 25 no plain mirror
may run on the card), then the multiply-add operator ``rctpu::fma``
(phase 27: random bit patterns, the edges, the tie triple, every broadcast
form, vmap and a graph replay against ``policy.fma32`` / ``fmaf32``, and
its main-path calls timed; from phase 5 to 25 no plain ``fma32`` or
``fmaf32`` may run on the card but in the xbr epilogue's plain tail),
compares them with the port's own CPU run, counts the work that left
shared memory for global (the blur kernel's wide tiles, the blit's and the
xbr epilogue's general-path units, the warp kernel's channel-at-a-time
launches: none may at the main paths' geometries), and times the kernels
(device time per launch from CUDA events around it, and per call through
the wrapper) against their plain versions
(device time from torch.profiler),
one PyTorch library call computing the same function where there is one,
and their bound on the card; and the slices. Prints one line per phase,
the kernel table as a JSON line, and as its last line ``{"ok": true,
"device": {...}}``. Any failed check raises, so the run exits non-zero and
prints no result; so does a machine without CUDA. It imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import cProfile
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent
PRESET = REPO / "assets" / "presets" / "feedback-ghost.glslp"
VIEWPORT = (1920, 1080)  # (W, H)
SRC_HW = (240, 320)
SLICE_BATCH = 128
WARP_BATCH = 8
MATTIAS_BATCH = 32
XBR_BATCH = 64  # bench.py's xbr-lv2-1080p
STREAM_FRAMES = 128  # through io.queue.stream, in batches of STREAM_BATCH
STREAM_BATCH = 32
STREAMS = (4, 8)  # apply_streams: S streams of T frames
MIP_BATCH = 4
CLAMP_SRC_HW = (960, 1280)  # a source above the clamp ...
CLAMP_TO = (640, 480)  # ... of set_max_shader_resolution (W, H)
CLI_FRAMES = 16
WINDOWS = 3  # repeated timing windows of the stream and streams phases
NTSC_BATCH = 128
NTSC_WIDTH = 1280  # ntsc-320px's pass 0: 4 x 320 wide (bench.py:47)
NNEDI3_BATCH = 32
VARIANT_BATCH = 8  # one apply of each other variant of the two families
DEV = "cuda"  # the card; the checks below never fall back to the CPU

# The card's published peaks (H100 SXM, dense, at 700 W): a kernel's bound
# is the larger of its bytes over the memory rate and its f32 operations
# over the f32 rate.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_F64_MATMUL_S = 67e12  # FP64 on the tensor cores (the data sheet); what an f64 matmul runs on
# Elementwise f64 outside the tensor cores issues 64 adds, multiplies or
# FMAs a clock per SM (the data sheet's 34 TFLOP/s counts an FMA as two
# operations; an unfused add or multiply takes a whole issue slot). Main
# sets the rate from the card's SMs and maximum SM clock.
F64_PER_CLOCK_SM = 64
F64_ISSUE_S = None

# Phase 26, the numerics mirrors' kernel: every f32 bit pattern in chunks
# for sin, log, log2 and exp, a random sample for the pow at each exponent
# the port uses (crt-mattias's four, the ntsc gammas); the operations an
# element takes, for the bound: f64 adds and multiplies (sin: the least a
# non-tiny argument takes, 11 of 11-15) over the f64 issue rate, and f32
# operations (an FFMA two) over the f32 rate (log 11 FFMA, 5 FADD and 3
# FMUL; exp 9, 1 and 2; log2 an FMUL more than log; pow log, an FMUL and
# exp).
SWEEP_CHUNK = 1 << 27
POW_SAMPLE = 1 << 26
POW_EXPONENTS = (0.3, 2.2, 0.9, 0.45, 2.5, 2.0, 2.4)
MIRROR_OPS = {"sin": (11, 0), "log": (0, 30), "log2": (0, 31), "exp": (0, 21), "pow": (0, 52)}
MIRRORS_REPLACE = "none, XLA's inline sin/log/exp in the reference's fusions"

# Phase 27, the multiply-add operator rctpu::fma: random bit-pattern
# triples a mode against policy.fma32 / fmaf32.
FMA_SAMPLE = 1 << 26
FMA_REPLACE = "none, XLA's contracted multiply-adds in the reference's fusions"

# (src_h, src_w, viewport) of the xbr kernel checks beyond the main path's
# own shape: x ratios 2 and 3, an output width that is no integer ratio
# (64 -> 250), and y ratio 4.5.
XBR_GEOMETRIES = [(120, 160, (320, 240)), (80, 100, (300, 240)), (48, 64, (250, 144)), (60, 80, (480, 270))]

WARP_GLSLP = """shaders = 1
shader0 = warp-curve.glsl
filter_linear0 = true
wrap_mode0 = clamp_to_border
scale_type0 = viewport
scale0 = 1.0
"""

_VERTEX_GLSL = """#if defined(VERTEX)

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
"""

WARP_GLSL = """#pragma parameter CURV "Curvature" 0.25 0.0 1.0 0.05

""" + _VERTEX_GLSL + """
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

# Two presets whose input is mipmapped. mip-glow is the crt-hyllian-glow
# pattern: a pass at a fraction of the source size that blurs its input,
# whose taps are affine in the pixel, so the level of detail is one
# number (log2(1 / 0.3) = 1.74 at scale 0.3: a blend of levels 1 and 2).
MIP_GLOW_GLSLP = """shaders = 1
shader0 = mip-glow.glsl
filter_linear0 = true
mipmap_input0 = true
scale_type0 = source
scale0 = {scale}
"""

MIP_GLOW_GLSL = _VERTEX_GLSL + """
varying vec2 vTexCoord;
uniform sampler2D Texture;
uniform vec2 TextureSize;

void main()
{
    vec2 d = 1.0 / TextureSize;
    vec4 c = 0.41 * texture2D(Texture, vTexCoord);
    c += 0.1475 * texture2D(Texture, vTexCoord + vec2(d.x, 0.0));
    c += 0.1475 * texture2D(Texture, vTexCoord - vec2(d.x, 0.0));
    c += 0.1475 * texture2D(Texture, vTexCoord + vec2(0.0, d.y));
    c += 0.1475 * texture2D(Texture, vTexCoord - vec2(0.0, d.y));
    gl_FragColor = c;
}

#endif
"""

# mip-warp minifies through a curvature warp (ZOOM source widths across
# the output, more towards the corners), so the level of detail differs
# per pixel and crosses whole levels: one warped sample per pyramid level.
MIP_WARP_GLSLP = """shaders = 1
shader0 = mip-warp.glsl
filter_linear0 = {linear}
wrap_mode0 = repeat
mipmap_input0 = true
scale_type0 = viewport
scale0 = 1.0
"""

MIP_WARP_GLSL = """#pragma parameter ZOOM "Zoom out" 10.0 1.0 32.0 1.0

""" + _VERTEX_GLSL + """
varying vec2 vTexCoord;
uniform sampler2D Texture;

#ifdef PARAMETER_UNIFORM
uniform float ZOOM;
#else
#define ZOOM 10.0
#endif

void main()
{
    vec2 cc = vTexCoord - 0.5;
    float r2 = dot(cc, cc);
    gl_FragColor = texture2D(Texture, 0.5 + cc * (ZOOM * (1.0 + 0.5 * r2)));
}

#endif
"""


def write_mip_presets(tmp, scale=0.3, linear=True):
    """Write the two mipmapped presets under ``tmp``; their paths."""
    tmp = Path(tmp)
    (tmp / "mip-glow.glslp").write_text(MIP_GLOW_GLSLP.format(scale=scale))
    (tmp / "mip-glow.glsl").write_text(MIP_GLOW_GLSL)
    (tmp / "mip-warp.glslp").write_text(MIP_WARP_GLSLP.format(linear="true" if linear else "false"))
    (tmp / "mip-warp.glsl").write_text(MIP_WARP_GLSL)
    return str(tmp / "mip-glow.glslp"), str(tmp / "mip-warp.glslp")


# feedback-ghost with its pass at the source size (absolute scale), so
# that the viewport blit is a 320 -> 1920 (r = 6) upscale: the xphase path.
XPHASE_GLSLP = """shaders = 1
shader0 = {shader}
filter_linear0 = false
scale_type0 = absolute
scale_x0 = {w}
scale_y0 = {h}
"""

# (batch, src_h, src_w, dst_h, dst_w): the blit at the feedback-ghost
# slice's own shape (its pass renders at the viewport, and f32 coordinate
# rounding keeps the 1080p -> 1080p LINEAR blit from being the identity),
# the 320x240 -> 1080p upscale at the slice's batch (the xphase path's
# blit with RCTPU_XPHASE off) and at B=8, the other geometries of
# tests/test_kernels_resample.py, x-only (src_h == dst_h) and y-only
# (src_w == dst_w) cases, the 256x224 frame (x ratio 7.5) and a downscale.
RESAMPLE_GEOMETRIES = [
    (SLICE_BATCH, 1080, 1920, 1080, 1920),
    (SLICE_BATCH, 240, 320, 1080, 1920),
    (8, 240, 320, 1080, 1920),
    (2, 240, 640, 1080, 1920),
    (2, 240, 320, 240, 1920),
    (2, 333, 640, 333, 1920),
    (2, 240, 320, 1077, 1920),
    (2, 96, 128, 192, 256),
    (2, 240, 320, 1080, 320),
    (8, 224, 256, 1080, 1920),
    (2, 1080, 1920, 360, 640),
]
SNES_HW = (224, 256)  # a non-integer x ratio (7.5) to 1080p
TRUTH_CHUNK = 16  # frames per f64 truth computation (bounds its memory)
_SPIN = "spin_kernel"  # the kernel of torch.cuda._sleep
_SPIN_CYCLES = 1_000_000  # about 0.5 ms at the H100's SM clock


# (batch, src_h, src_w, dst_h, dst_w) of the phase-form blit: the xphase
# path's shape (phase 11), and the other integer-ratio geometries of
# tests/test_kernels_resample.py (r = 3, y identity, odd heights).
XPHASE_GEOMETRIES = [
    (SLICE_BATCH, 240, 320, 1080, 1920),
    (2, 240, 640, 1080, 1920),
    (2, 240, 320, 240, 1920),
    (2, 333, 640, 333, 1920),
    (2, 240, 320, 1077, 1920),
    (2, 96, 128, 192, 256),
]


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


_T0 = time.perf_counter()


def say(phase, msg):
    print(f"[{phase} +{time.perf_counter() - _T0:.0f}s] {msg}", flush=True)


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


# torch.profiler windows on the card were seen to come back with no device
# record at all (one in many windows of a run): such a window is profiled
# again, up to this many times in all.
PROFILE_TRIES = 4


def device_records(fn):
    """The CUDA activity records of one call of fn from torch.profiler,
    the trailing spin kernel left out. A window that holds no record is
    profiled again (PROFILE_TRIES in all); returns [] if every one was
    empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            # Windows on the card were seen to lose their last device
            # record when the profiler stops: a short trailing kernel, left
            # out of what is returned, stands last in its place.
            torch.cuda._sleep(_SPIN_CYCLES)
            torch.cuda.synchronize()
        records = [e for e in prof.events() if e.device_type == DeviceType.CUDA and _SPIN not in e.name]
        if records:
            return records
        say("--", f"torch.profiler recorded no device time in window {attempt + 1} of {PROFILE_TRIES}")
    return []


def device_ms(fn, iters):
    """Mean device milliseconds per call of fn: the summed duration of the
    device work (kernels and copies) that iters calls enqueue, from
    torch.profiler's CUDA activity. Host time between launches is not in
    it. Used for the plain versions (thousands of small kernels) and the
    device-busy time of an apply; a kernel of the port is timed by
    launch_ms, because profiler windows on the card were seen to lose a
    launch's record. Where every window came back empty, the time is the
    CUDA events' span of iters calls (event_ms), which holds the host's
    gaps too, and says so."""
    def calls():
        for _ in range(iters):
            fn()

    records = device_records(calls)
    if not records:
        ms = event_ms(fn, iters)
        say("--", f"device time from CUDA events instead: {ms:.4f} ms a call, host gaps included")
        return ms
    return sum(e.time_range.elapsed_us() for e in records) / 1e3 / iters


@contextlib.contextmanager
def bracketed(name):
    """Wrap kernel ``name``'s loaded entry point so that each launch runs
    between two CUDA events on the stream, behind a short spin kernel that
    keeps the stream busy while the host enqueues the events and the
    launch: each pair's interval is the kernel's own device time, without
    the wrapper's host work or the launch's latency. Yields the list of
    (start, stop) pairs, one per launch."""
    import torch

    from retrocapture_tpu_torch.ops.cuda import _build

    raw = _build.load(name)
    pairs = []

    def timed(*args):
        torch.cuda._sleep(_SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = raw(*args)
        stop.record()
        pairs.append((start, stop))
        return rc

    _build._ENTRIES[name] = timed
    try:
        yield pairs
    finally:
        _build._ENTRIES[name] = raw


def launch_ms(name, fn, iters):
    """Mean device milliseconds of kernel ``name`` per launch over iters
    calls of fn, each of which launches it once (see bracketed)."""
    import torch

    torch.cuda.synchronize()
    with bracketed(name) as pairs:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    check(len(pairs) == iters, f"{name}: {len(pairs)} launches in {iters} calls")
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def launch_timer(name):
    """launch_ms of kernel ``name`` as an in_turns timer."""
    return lambda fn, iters: launch_ms(name, fn, iters)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` and do ``flops`` f32 operations."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def blit_bound(tex, dst_h, dst_w):
    """bound() of a u8 blit of ``tex [B, H, W, 3]`` f32 to dst_h x dst_w:
    the texture, the u8 output and two (index, weight) taps per output row
    and column; 4 taps x (mul, add), the scale and the rounding per value."""
    values = tex.shape[0] * dst_h * dst_w * 3
    return bound(nbytes(tex) + values + 16 * (dst_h + dst_w), 10 * values)


@contextlib.contextmanager
def launched(module, op, shapes_only=False):
    """Record the arguments of every launch of the operator ``module.op``
    (``torch.library``; it still runs) for the duration of a block: the
    calls its batching rule makes with the whole batch, not the one-frame
    calls that ``torch.func.vmap`` hands it inside a batched walk.
    ``shapes_only``: the shape of each launch's first tensor alone."""
    import torch

    orig = getattr(module, op)
    calls = []

    def rec(*args):
        if not any(isinstance(a, torch.Tensor) and torch._C._functorch.is_batchedtensor(a) for a in args):
            first = next(a for a in args if isinstance(a, torch.Tensor))
            calls.append(tuple(first.shape) if shapes_only else args)
        return orig(*args)

    setattr(module, op, rec)
    try:
        yield calls
    finally:
        setattr(module, op, orig)


def walks_an_apply(e, batch):
    """The walks of one apply of ``batch`` frames of a stateless chain: one
    for the batch, or one a FrameCount position where the engine groups
    the batch by the chain's FrameCount period (``RCTPU_FC_GROUP`` on)."""
    m = e._program.fc_period()
    return m if m is not None and 2 <= m <= 8 and batch > 1 and batch % m == 0 else 1


def in_turns(plain, kernel, iters, timer, plain_iters=None, kernel_timer=None):
    """(plain_ms, kernel_ms) measured in turns: plain, kernel, kernel, plain.
    ``plain_iters`` (default ``iters``) shortens the windows of a slow
    plain version; ``kernel_timer`` (default ``timer``) times the kernel."""
    for f in (plain, kernel):
        f()
    import torch

    plain_iters = plain_iters or iters
    kernel_timer = kernel_timer or timer
    torch.cuda.synchronize()
    p1 = timer(plain, plain_iters)
    k1 = kernel_timer(kernel, iters)
    k2 = kernel_timer(kernel, iters)
    p2 = timer(plain, plain_iters)
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


def check_blit(tex, oh, ow, phase):
    """Hold resample_u8 on ``tex [B, H, W, 3]`` -> oh x ow against its plain
    version and both against the f64 truth; no unit of work may take the
    general path. Returns the kernel's largest distance from the plain
    version in u8 steps."""
    import torch

    from retrocapture_tpu_torch.ops.cuda import resample as rs

    b, h, w = tex.shape[:3]
    ay, ax = rs.blit_matrices(h, w, ow, oh)
    rs.general_blocks(reset=True)
    got = rs.resample_u8(tex, ay, ax)
    general = rs.general_blocks(reset=True)
    ay_t = None if ay is None else torch.from_numpy(ay).to(DEV)
    ax_t = None if ax is None else torch.from_numpy(ax).to(DEV)
    plain = rs.resample_u8_plain(tex, ay_t, ax_t)
    check(got.shape == (b, oh, ow, 3) and got.dtype == torch.uint8, f"resample shape {tuple(got.shape)}")
    what = f"{b}x{h}x{w} -> {oh}x{ow}"
    check(general == 0, f"resample {what}: {general} units of work took the general path")
    for s in range(0, b, TRUTH_CHUNK):
        q64, edge = _truth_u8(tex[s : s + TRUTH_CHUNK], ay_t, ax_t)
        for label, out in (("kernel", got), ("plain", plain)):
            d = (out[s : s + TRUTH_CHUNK].to(torch.int32) - q64).abs()
            check(int(d.max()) <= 1, f"resample {label} {what}: {int(d.max())} steps from f64 truth")
            off = int((d[~edge] != 0).sum())
            check(off == 0, f"resample {label} {what}: {off} non-knife-edge pixels off the f64 truth")
        del q64, edge
    kd = int((got.to(torch.int32) - plain.to(torch.int32)).abs().max())
    say(phase, f"resample_u8 {what}: ok (kernel vs plain max {kd} step, general-path units {general})")
    return kd


def phase_resample(gen):
    worst = 0
    for b, h, w, oh, ow in RESAMPLE_GEOMETRIES:
        worst = max(worst, check_blit(knife_tex(gen, (b, h, w, 3), DEV), oh, ow, "3"))
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
                check(err == 0.0, f"warp LINEAR {mode}: not bit-equal off the NaNs (max |d| {err:.3e})")
            worst = max(worst, err)
            say("4", f"warp_sample {'LINEAR' if lin else 'NEAREST'} {mode}: ok (max |d| {err:.3e})")
    # A batch of WARP_BATCH frames (the kernel samples every frame at one
    # pixel's taps), RGBA (the float4 path), RGB and an RGBA view off the
    # 16-byte grid (the general path), on the same coordinates.
    flat = torch.rand((WARP_BATCH * SRC_HW[0] * SRC_HW[1] * 4 + 1,), generator=gen, device=DEV)
    for label, btex, general in (
        ("RGBA", flat[:-1].view(WARP_BATCH, SRC_HW[0], SRC_HW[1], 4), 0),
        ("RGB", flat[:WARP_BATCH * SRC_HW[0] * SRC_HW[1] * 3].view(WARP_BATCH, SRC_HW[0], SRC_HW[1], 3), 1),
        ("RGBA 4 bytes off", flat[1:].view(WARP_BATCH, SRC_HW[0], SRC_HW[1], 4), 1),
    ):
        for lin in (False, True):
            ws.general_launches(reset=True)
            got = ws.warp_sample(btex, u, v, filter_linear=lin, wrap_mode="clamp_to_border")
            taken = ws.general_launches(reset=True)
            want = ws.warp_sample_plain(btex, u, v, filter_linear=lin, wrap_mode="clamp_to_border")
            torch.cuda.synchronize()
            check(taken == general, f"warp {label}: {taken} launches took the general path, want {general}")
            check(same_bits(got, want), f"warp {label} [{WARP_BATCH},...] linear={lin}: not bit-equal to plain")
        say("4", f"warp_sample [{WARP_BATCH},{SRC_HW[0]},{SRC_HW[1]},{btex.shape[-1]}] {label} @ {ho}x{wo}, both "
            f"filters: bit-equal to plain ({'general' if general else 'float4'} path)")
    return worst, (tex, u, v)


def same_bits(got, want):
    """Bit-equal where ``want`` is not NaN, NaN where it is."""
    import torch

    wn = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), wn)) and not bool(
        ((got.view(torch.int32) != want.view(torch.int32)) & ~wn).any())


def abs_err(got, want):
    """The largest |got - want| off ``want``'s NaNs: 0 where the bits
    agree, NaN where ``got`` alone is NaN."""
    import torch

    d = torch.where(got.view(torch.int32) == want.view(torch.int32), 0.0, (got - want).abs())
    d = torch.where(torch.isnan(want), 0.0, d)
    return float(d.max()) if d.numel() else 0.0


@contextlib.contextmanager
def env(**values):
    """Set environment variables for the duration of a block."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_xphase(gen):
    """The phase-form blit kernel: bit-equal to the dense blit kernel and
    to its own plain version, and within 1 step of the f64 truth (exact
    off knife edges)."""
    import torch

    from retrocapture_tpu_torch.ops.cuda import resample as rs

    worst = 0
    for b, h, w, oh, ow in XPHASE_GEOMETRIES:
        ay, ax = rs.blit_matrices(h, w, ow, oh)
        plan = rs._xphase_plan(ax, w, ow)
        check(plan is not None, f"xphase: no phase plan for {w} -> {ow}")
        tex = knife_tex(gen, (b, h, w, 3), DEV)
        got = rs.resample_u8_xphase(tex, ay, plan)
        dense = rs.resample_u8(tex, ay, ax)
        ytaps = None if ay is None else tuple(torch.from_numpy(t).to(DEV) for t in rs.axis_taps(ay))
        plain = rs.resample_u8_xphase_plain(tex, ytaps, plan)
        what = f"{b}x{h}x{w} -> {oh}x{ow}"
        check(got.shape == (b, oh, ow, 3) and got.dtype == torch.uint8, f"xphase shape {tuple(got.shape)}")
        check(bool(torch.equal(got, dense)), f"xphase {what}: not bit-equal to the resample_u8 kernel")
        check(bool(torch.equal(got, plain)), f"xphase {what}: not bit-equal to its plain version")
        ay_t = None if ay is None else torch.from_numpy(ay).to(DEV)
        ax_t = torch.from_numpy(ax).to(DEV)
        for s in range(0, b, TRUTH_CHUNK):
            q64, edge = _truth_u8(tex[s : s + TRUTH_CHUNK], ay_t, ax_t)
            d = (got[s : s + TRUTH_CHUNK].to(torch.int32) - q64).abs()
            check(int(d.max()) <= 1, f"xphase {what}: {int(d.max())} steps from f64 truth")
            off = int((d[~edge] != 0).sum())
            check(off == 0, f"xphase {what}: {off} non-knife-edge pixels off the f64 truth")
            worst = max(worst, int(d.max()))
            del q64, edge, d
        say("8", f"resample_u8_xphase {what} (r={plan[0]}): ok (== resample_u8 kernel, == plain, "
            f"<= 1 step of f64 truth)")
        del got, dense, plain, tex
    return worst


def phase_blur(gen):
    """The blur kernel, v2 and v1, against its plain version at the
    mattias slice's shape: bit-equal (same loop, same order, no
    contraction)."""
    import torch

    from retrocapture_tpu_torch.graph.kernels import mattias_groups, mattias_uv
    from retrocapture_tpu_torch.ops.cuda import blur_groups as bg

    h, w = SRC_HW
    vw, vh = VIEWPORT
    tex = torch.rand((MATTIAS_BATCH, h, w, 3), generator=gen, device=DEV) ** 2.2
    u, v = mattias_uv(vw, vh, 0.5, DEV)
    groups = mattias_groups(vw, vh)
    errs = {}
    for mode in ("v2", "v1"):
        bg.wide_tiles(reset=True)
        with env(RCTPU_BLUR=mode):
            got = bg.blur5x5_groups(tex, u, v, groups)
        wide = bg.wide_tiles(reset=True)
        check(wide == 0, f"blur {mode}: {wide} tiles took the wide path at the crt-mattias geometry")
        plain = bg.blur5x5_groups_plain(tex, u, v, groups, bg.weight_tables(groups, mode))
        torch.cuda.synchronize()
        err = 0.0
        for ch in (0, 1, 2):
            check(tuple(got[ch].shape) == (MATTIAS_BATCH, vh, vw), f"blur {mode} shape {tuple(got[ch].shape)}")
            check(bool(torch.isfinite(got[ch]).all()), f"blur {mode}: non-finite output")
            err = max(err, float((got[ch] - plain[ch]).abs().max()))
            check(bool(torch.equal(got[ch], plain[ch])), f"blur {mode} channel {ch}: not bit-equal to plain "
                  f"(max |d| {err:.3e})")
        errs[mode] = err
        say("9", f"blur5x5_groups {mode} [{MATTIAS_BATCH},{h},{w},3] -> {vh}x{vw} x 9 groups: ok "
            f"(bit-equal to plain, wide tiles {wide})")
        del got, plain
    return errs, (tex, u, v, groups)


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


def _mattias_engine(Engine, path, dev=None):
    e = Engine(viewport=VIEWPORT, device=dev or DEV)
    check(e.load_preset(str(path)), f"load mattias stand-in: {e.last_error}")
    return e


def phase_mattias(gen, Engine, tmp):
    """crt-mattias through Engine.apply, walked uncaptured (the caller sets
    RCTPU_REPLAY=0: one walk of the batch an apply, one blur launch of all
    its frames): 3 applies at batch 32 (blur kernel counted), CUDA against
    the port's CPU run on 2 frames; one
    apply under RCTPU_BLUR=v1 and one under RCTPU_MATTIAS=preconv, each
    counted on its own, its CUDA run against its CPU run and its warp
    launches against the plain version at their own inputs."""
    import torch

    from retrocapture_tpu_torch.graph.kernels import _glsl_pow, mattias_groups, mattias_uv
    from retrocapture_tpu_torch.ops.preconv_blur import group_samples
    from retrocapture_tpu_torch.ops.cuda import blur_groups as bg
    from retrocapture_tpu_torch.ops.cuda import mirrors as mr
    from retrocapture_tpu_torch.ops.cuda import resample as rs
    from retrocapture_tpu_torch.ops.cuda import warp_sample as ws

    # The stand-in for crt-mattias.glsl that the CPU tests drive too.
    from _mattias_standin import write_standin

    path = write_standin(tmp)
    h, w = SRC_HW
    frames = torch.randint(0, 256, (MATTIAS_BATCH, h, w, 3), generator=gen, device=DEV, dtype=torch.uint8)
    e = _mattias_engine(Engine, path)
    bg.wide_tiles(reset=True)
    bg.LAUNCHES = rs.LAUNCHES = rs.XPHASE_LAUNCHES = ws.LAUNCHES = mr.LAUNCHES = 0
    for i in range(3):
        out = e.apply(frames, output="u8")
        torch.cuda.synchronize()
        _engine_ok(e, f"mattias apply {i}")
        check(tuple(out.shape) == (MATTIAS_BATCH, VIEWPORT[1], VIEWPORT[0], 3), f"mattias shape {tuple(out.shape)}")
        check(out.dtype == torch.uint8 and out.device.type == torch.device(DEV).type, f"mattias dtype {out.dtype} on {out.device}")
    launches = {"blur_groups_v2": bg.LAUNCHES, "mirrors": mr.LAUNCHES}
    wide = bg.wide_tiles(reset=True)
    check(launches["blur_groups_v2"] == 3, f"mattias: blur kernel launches {bg.LAUNCHES}, want 3 (one an apply)")
    # Six mirrors a walk (the pows 2.2, 0.9, 0.45, the vignette's 0.3 in the
    # first walk of the const program, the scanline and hash sines).
    check(launches["mirrors"] == 3 * 5 + 1, f"mattias: mirror kernel launches {mr.LAUNCHES}, want 16")
    check(wide == 0, f"mattias: {wide} blur tiles took the wide path")
    check(int(out[:, 0, 0].max()) == 0 and float(out[:, VIEWPORT[1] // 2].float().mean()) > 5,
          "mattias: no curved black corner or no lit centre")
    outs = []
    for dev in (DEV, "cpu"):
        e2 = _mattias_engine(Engine, path, dev)
        outs.append(e2.apply(frames[:2].to(dev), output="u8").cpu())
        _engine_ok(e2, f"mattias {dev} reference run")
    dmax, frac = _cmp_u8(outs[0], outs[1], "mattias cuda vs cpu")
    say("10", f"crt-mattias {MATTIAS_BATCH}x{h}x{w} rgb -> {VIEWPORT[1]}x{VIEWPORT[0]} u8, 3 applies: ok "
        f"(blur launches {launches['blur_groups_v2']}, wide tiles {wide}, mirror launches {launches['mirrors']}; "
        f"cuda vs cpu on 2 frames: max {dmax} step, "
        f"{frac:.2e} of values)")
    base = outs[0]

    with env(RCTPU_BLUR="v1"):
        e1 = _mattias_engine(Engine, path)
        bg.LAUNCHES = 0
        o1 = e1.apply(frames[:2], output="u8")
        torch.cuda.synchronize()
        launches["blur_groups_v1"] = bg.LAUNCHES
    _engine_ok(e1, "mattias v1")
    check(launches["blur_groups_v1"] == 1, f"mattias v1: blur kernel launches {launches['blur_groups_v1']}, want 1")
    d1 = (o1.cpu().int() - base.int()).abs()
    check(int(d1.max()) <= 2, f"mattias v1 vs v2: max {int(d1.max())} steps")
    say("10", f"crt-mattias under RCTPU_BLUR=v1: ok (launches {launches['blur_groups_v1']}; vs v2 max "
        f"{int(d1.max())} steps, {float((d1 != 0).float().mean()):.2e} of values)")

    with env(RCTPU_MATTIAS="preconv"):
        ep = _mattias_engine(Engine, path)
        bg.LAUNCHES = ws.LAUNCHES = 0
        op = ep.apply(frames[:2], output="u8")
        torch.cuda.synchronize()
        pre = {"warp_sample": ws.LAUNCHES, "blur_groups": bg.LAUNCHES}
        ec = _mattias_engine(Engine, path, "cpu")
        cpu = ec.apply(frames[:2].cpu(), output="u8")
    _engine_ok(ep, "mattias preconv")
    _engine_ok(ec, "mattias preconv cpu reference run")
    check(pre["warp_sample"] == 9 and pre["blur_groups"] == 0, f"mattias preconv launches {pre}, want a warp "
          "launch a group for the batch")
    pmax, pfrac = _cmp_u8(op.cpu(), cpu, "mattias preconv cuda vs cpu")
    dp = (op.cpu().int() - base.int()).abs()
    check(float((dp > 5).float().mean()) < 5e-3, f"mattias preconv vs groups: {float((dp > 5).float().mean()):.2e} "
          "of values beyond 5 steps")
    say("10", f"crt-mattias under RCTPU_MATTIAS=preconv: ok (launches {pre}; cuda vs cpu on 2 frames: max {pmax} "
        f"step, {pfrac:.2e} of values; vs groups max {int(dp.max())} steps, "
        f"{float((dp > 5).float().mean()):.2e} of values beyond 5)")

    # The warp kernel at the preconv path's own inputs: frame 0's
    # pre-transformed texture, each group's single-channel Qfine and
    # subcell coordinates built as blur_preconv builds them, held
    # bit-equal (NEAREST) to the plain version.
    p = _glsl_pow(frames[0].float() * (1.0 / 255.0), 2.2)
    u, v = mattias_uv(VIEWPORT[0], VIEWPORT[1], 0.5, DEV, cross=True)  # the blur's own coordinates
    shapes = []
    for ch, q, u2, v2 in group_samples(p, u, v, mattias_groups(*VIEWPORT)):
        got = ws.warp_sample(q, u2, v2, filter_linear=False, wrap_mode="clamp_to_edge")
        want = ws.warp_sample_plain(q, u2, v2, filter_linear=False, wrap_mode="clamp_to_edge")
        torch.cuda.synchronize()
        check(tuple(got.shape) == (VIEWPORT[1], VIEWPORT[0], 1), f"preconv warp shape {tuple(got.shape)}")
        check(bool(torch.equal(got, want)), f"preconv warp, channel {ch}, Qfine {tuple(q.shape)}: not bit-equal "
              f"to plain (max |d| {float((got - want).abs().max()):.3e})")
        shapes.append(tuple(q.shape[:2]))
    say("10", f"warp_sample NEAREST clamp_to_edge on the 9 preconv textures (C=1, {min(shapes)}..{max(shapes)}) "
        f"-> {VIEWPORT[1]}x{VIEWPORT[0]}: ok (bit-equal to plain)")
    return e, frames, launches


def phase_xphase_slice(gen, Engine, tmp):
    """One feedback-ghost apply under RCTPU_XPHASE=on: the blit takes the
    phase-form kernel and writes the bytes of the default path. The
    preset's pass renders at 320x240 (absolute scale): with the shipped
    preset's source scale 1.0 the last pass renders at the viewport, and
    its 1080p -> 1080p blit has no integer phase structure (r = 1)."""
    import torch

    from retrocapture_tpu_torch.ops.cuda import resample as rs

    h, w = SRC_HW
    path = tmp / "feedback-ghost-320.glslp"
    path.write_text(XPHASE_GLSLP.format(shader=PRESET.with_suffix(".glsl"), w=w, h=h))
    frames = torch.randint(0, 256, (SLICE_BATCH, h * 3 // 2, w), generator=gen, device=DEV, dtype=torch.uint8)
    outs = []
    for mode in ("off", "on"):
        with env(RCTPU_XPHASE=mode):
            e = Engine(viewport=VIEWPORT, device=DEV)
            check(e.load_preset(str(path)), f"load_preset: {e.last_error}")
            e.set_input_format("nv12")
            rs.LAUNCHES = rs.XPHASE_LAUNCHES = 0
            outs.append(e.apply(frames, output="u8"))
            torch.cuda.synchronize()
            counts = (rs.LAUNCHES, rs.XPHASE_LAUNCHES)
        _engine_ok(e, f"feedback-ghost RCTPU_XPHASE={mode}")
        check(counts == ((1, 0) if mode == "off" else (0, 1)), f"RCTPU_XPHASE={mode}: launches "
              f"(resample_u8, xphase) {counts}")
    check(bool(torch.equal(outs[0], outs[1])), "feedback-ghost: RCTPU_XPHASE=on output differs from the default")
    say("11", f"feedback-ghost-nv12 (pass at {w}x{h}) {SLICE_BATCH} frames under RCTPU_XPHASE=on: ok "
        "(xphase launches 1, output == the default blit's)")
    return counts[1]


def _xbr_engine(Engine, path, viewport, small=0.0, dev=None):
    e = Engine(viewport=viewport, device=dev or DEV)
    check(e.load_preset(str(path)), f"load xbr stand-in: {e.last_error}")
    check(e.set_parameter("small_details", small), "xbr stand-in has no small_details")
    return e


def _xbr_kept_maps(e):
    """The epilogue maps (``EpilogueMaps``) that the engine's xbr-lv2 entry
    keeps for its one geometry."""
    (maps,) = [v[1] for p in e._programs.values() for k, v in p.walk.tables.items() if k[0] == "xbr-lv2"]
    return maps


def _xbr_plain_args(S, maps):
    """The plain version's arguments from an epilogue call's (S, the
    geometry's EpilogueMaps)."""
    return S, maps.bx, maps.fpx, maps.fpy


def phase_xbr_kernel(gen, Engine, path):
    """The xbr epilogue kernel against its plain version, bit-equal, on
    the front section's own S: one random frame at the main path's shape
    (240x320 -> 1080x1920) and at XBR_GEOMETRIES, small_details 0 and 1;
    no block may take the general path there. Returns the worst |d| and
    the main path's epilogue inputs (S, the geometry's maps)."""
    import torch

    from retrocapture_tpu_torch.ops.cuda import xbr_epilogue as xe

    worst, main = 0.0, None
    for small in (0.0, 1.0):
        for h, w, vp in [SRC_HW + (VIEWPORT,)] + XBR_GEOMETRIES:
            frame = torch.randint(0, 256, (1, h, w, 3), generator=gen, device=DEV, dtype=torch.uint8)
            e = _xbr_engine(Engine, path, vp, small)
            # The walk's own launch (a graph's capture launches it too).
            with launched(xe, "_xbr_epilogue_op") as calls, env(RCTPU_REPLAY="0"):
                e.apply(frame, output="u8")
            _engine_ok(e, f"xbr {h}x{w} -> {vp}")
            what = f"S {tuple(calls[0][0].shape) if calls else None} -> {vp[1]}x{vp[0]} small_details={small:g}"
            check(len(calls) == 1, f"xbr {h}x{w} -> {vp}: the hand kernel did not engage ({len(calls)} calls)")
            args = (calls[0][0], _xbr_kept_maps(e))
            xe.general_blocks(reset=True)
            got = xe.xbr_epilogue(*args)
            general = xe.general_blocks(reset=True)
            want = xe.xbr_epilogue_plain(*_xbr_plain_args(*args))
            torch.cuda.synchronize()
            check(general == 0, f"xbr epilogue {what}: {general} blocks took the general path")
            check(tuple(got.shape) == (1, vp[1], vp[0], 4), f"xbr epilogue {what}: shape {tuple(got.shape)}")
            err = float((got - want).abs().max())
            check(bool(torch.equal(got, want)), f"xbr epilogue {what}: not bit-equal to plain (max |d| {err:.3e})")
            worst = max(worst, err)
            if main is None:
                main = args
            say("13", f"xbr_epilogue {what}: ok (bit-equal to plain, general-path blocks {general})")
    return worst, main


def phase_xbr_slice(gen, Engine, path):
    """xbr-lv2 through Engine.apply, walked uncaptured (the caller sets
    RCTPU_REPLAY=0): 3 applies at batch 64 (epilogue kernel counted: one
    launch of the batch an apply), CUDA against the port's CPU run
    on 2 frames, and one apply with small_details = 1."""
    import torch

    from retrocapture_tpu_torch.ops.cuda import xbr_epilogue as xe

    h, w = SRC_HW
    vw, vh = VIEWPORT
    frames = torch.randint(0, 256, (XBR_BATCH, h, w, 3), generator=gen, device=DEV, dtype=torch.uint8)
    e = _xbr_engine(Engine, path, VIEWPORT)
    xe.LAUNCHES = 0
    xe.general_blocks(reset=True)
    for i in range(3):
        out = e.apply(frames, output="u8")
        torch.cuda.synchronize()
        _engine_ok(e, f"xbr apply {i}")
        check(tuple(out.shape) == (XBR_BATCH, vh, vw, 3), f"xbr shape {tuple(out.shape)}")
        check(out.dtype == torch.uint8 and out.device.type == torch.device(DEV).type, f"xbr dtype {out.dtype} on {out.device}")
    launches = xe.LAUNCHES
    general = xe.general_blocks(reset=True)
    check(launches == 3, f"xbr: epilogue kernel launches {launches}, want 3 (one an apply)")
    check(general == 0, f"xbr: {general} epilogue blocks took the general path")
    kept = [k for p in e._programs.values() for k in p.walk.tables if k[0] == "xbr-lv2"]
    check(len(kept) == 1, f"xbr: {len(kept)} geometries kept, want 1")
    # Not the stand-in's passthrough: xbr blends the NEAREST upscale at edges.
    ys = (torch.arange(vh, device=DEV) * h) // vh
    xs = (torch.arange(vw, device=DEV) * w) // vw
    moved = float((out[:2] != frames[:2][:, ys][:, :, xs]).float().mean())
    check(moved > 0.05, f"xbr: output equals the NEAREST upscale in {1 - moved:.3f} of values")
    outs = []
    for dev in (DEV, "cpu"):
        e2 = _xbr_engine(Engine, path, VIEWPORT, dev=dev)
        outs.append(e2.apply(frames[:2].to(dev), output="u8").cpu())
        _engine_ok(e2, f"xbr {dev} reference run")
    dmax, frac = _cmp_u8(outs[0], outs[1], "xbr cuda vs cpu")
    say("14", f"xbr-lv2 {XBR_BATCH}x{h}x{w} rgb -> {vh}x{vw} u8, 3 applies: ok (epilogue launches {launches}, "
        f"general-path blocks {general}, axis maps built once; "
        f"cuda vs cpu on 2 frames: max {dmax} step, {frac:.2e} of values; {moved:.3f} of values off the NEAREST upscale)")
    es = _xbr_engine(Engine, path, VIEWPORT, small=1.0)
    xe.LAUNCHES = 0
    out = es.apply(frames, output="u8")
    torch.cuda.synchronize()
    _engine_ok(es, "xbr small_details=1")
    check(xe.LAUNCHES == 1 and tuple(out.shape) == (XBR_BATCH, vh, vw, 3),
          f"xbr small_details=1: launches {xe.LAUNCHES}, shape {tuple(out.shape)}")
    d = (out.int() - e.apply(frames, output="u8").int()).abs()
    say("14", f"xbr-lv2 small_details=1, {XBR_BATCH} frames: ok (launches 1; differs from "
        f"small_details=0 in {float((d != 0).float().mean()):.2e} of values)")
    return e, frames, launches


def _quantized(x):
    """f32 frames in [0, 1] as u8 codes (round half to even)."""
    import torch

    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def _rates(label, n_frames, seconds, card):
    """One line with frames/s as min / median / max over the windows."""
    fps = sorted(n_frames / s for s in seconds)
    return (f"{label}: {fps[0]:.1f} / {fps[len(fps) // 2]:.1f} / {fps[-1]:.1f} frames/s (min / median / max of "
            f"{len(fps)} windows of {n_frames} frames)  ({card})")


def _stream_pipeline(Engine, dev):
    from retrocapture_tpu_torch.runtime.pipeline import FramePipeline, ImageSettings

    e = Engine(device=dev)
    check(e.load_preset(str(PRESET)), f"load_preset: {e.last_error}")
    return FramePipeline(
        e, logical_resolution=(160, 120), overscan_percent=(2.0, 2.0), window=VIEWPORT,
        image=ImageSettings(brightness=1.1, contrast=0.9, flip_y=True, maintain_aspect=True),
    )


def phase_stream(Engine, card):
    """TestPatternSource -> io.queue.stream -> FramePipeline.process over
    feedback-ghost (logical resolution 160x120, 2% overscan, brightness
    1.1, contrast 0.9, flip-Y, a pillarboxed 1920x1080 window): the frames
    come out in order and one batch late, equal to the same batches
    processed without the queue, and FrameStats counts them."""
    import numpy as np
    import torch

    from retrocapture_tpu_torch.io.queue import stream
    from retrocapture_tpu_torch.io.testpattern import TestPatternSource

    h, w = SRC_HW
    vw, vh = VIEWPORT
    src = TestPatternSource(w, h)
    frames = [src.capture_frame() for _ in range(STREAM_FRAMES)]
    n_batches = STREAM_FRAMES // STREAM_BATCH

    # The same batches without the queue, brought to the host one by one.
    direct_p = _stream_pipeline(Engine, DEV)
    direct = [direct_p.process(np.stack(frames[i * STREAM_BATCH:(i + 1) * STREAM_BATCH])).cpu().numpy()
              for i in range(n_batches)]
    _engine_ok(direct_p.engine, "stream (direct)")

    p = _stream_pipeline(Engine, DEV)
    processed = []

    def process(batch):
        check(batch.device.type == torch.device(DEV).type and batch.dtype == torch.uint8,
              f"stream: the feeder gave {batch.dtype} on {batch.device}")
        processed.append(batch.shape[0])
        return p.process(batch)

    n = 0
    for out in stream(iter(frames), process, batch=STREAM_BATCH, device=DEV):
        b = n // STREAM_BATCH
        # Frame n of batch b comes out when batch b + 1 is in (the last at the flush).
        check(len(processed) == min(b + 2, n_batches), f"stream: frame {n} came out after {len(processed)} batches")
        check(out.shape == (vh, vw, 3) and out.dtype == np.float32, f"stream: frame {n} is {out.dtype} {out.shape}")
        check(np.array_equal(out, direct[b][n % STREAM_BATCH]), f"stream: frame {n} is not frame {n} of the direct run")
        n += 1
    _engine_ok(p.engine, "stream")
    check(n == STREAM_FRAMES, f"stream: {n} frames came out of {STREAM_FRAMES}")
    check(p.stats.frames == STREAM_FRAMES and p.stats.batches == n_batches, f"stream: FrameStats {p.stats.snapshot()}")
    bars = max(float(direct[0][0][:, 0].max()), float(direct[0][0][:, -1].max()))
    check(bars == 0.0 and float(direct[0][0][:, vw // 2].mean()) > 0.0, "stream: no pillarbox bars or no content")
    cpu = _stream_pipeline(Engine, "cpu").process(np.stack(frames[:2]))
    dmax, frac = _cmp_u8(_quantized(torch.from_numpy(direct[0][:2])), _quantized(cpu), "stream cuda vs cpu")
    say("16", f"stream {STREAM_FRAMES} frames {h}x{w} in batches of {STREAM_BATCH} -> {vh}x{vw} f32 through "
        f"FramePipeline: ok (in order, one batch late, == the direct run, FrameStats {p.stats.frames}; cuda vs cpu "
        f"on 2 frames: max {dmax} step, {frac:.2e} of values)")
    del direct
    seconds = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sum(1 for _ in stream(iter(frames), p.process, batch=STREAM_BATCH, device=DEV))
        seconds.append(time.perf_counter() - t0)
        check(got == STREAM_FRAMES, f"stream window: {got} frames")
    say("16", _rates("stream phase, H2D and D2H included", STREAM_FRAMES, seconds, card))
    say("16", f"stream phase FrameStats (host time of process() up to its last enqueue: it reads the clock without "
        f"a synchronize): {p.stats.snapshot()}")
    # process() alone on a batch that is on the card already, to the end of
    # its device work; and the device's busy share of it.
    batch = torch.from_numpy(np.stack(frames[:STREAM_BATCH])).to(DEV)
    walls = []
    for _ in range(WINDOWS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p.process(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls = sorted(walls[1:])
    busy = device_ms(lambda: p.process(batch), 1)
    wall = walls[len(walls) // 2]
    say("16", f"FramePipeline.process of {STREAM_BATCH} frames with a synchronize: {walls[0]:.1f} / {wall:.1f} / "
        f"{walls[-1]:.1f} ms (min / median / max of {len(walls)}); device busy {busy:.1f} ms, idle "
        f"{100.0 * (1.0 - busy / wall):.1f}% of the median  ({card})")


def phase_streams(gen, Engine, card):
    """apply_streams on [S, T, 240, 320, 3]: stream s equals a fresh engine
    fed stream s alone, bit for bit on the card."""
    import torch

    s_n, t_n = STREAMS
    h, w = SRC_HW
    vw, vh = VIEWPORT
    frames = torch.randint(0, 256, (s_n, t_n, h, w, 3), generator=gen, device=DEV, dtype=torch.uint8)

    def engine(dev):
        e = Engine(viewport=VIEWPORT, device=dev)
        check(e.load_preset(str(PRESET)), f"load_preset: {e.last_error}")
        return e

    e = engine(DEV)
    out = e.apply(frames)  # the 5-D branch of apply
    torch.cuda.synchronize()
    _engine_ok(e, "apply_streams")
    check(tuple(out.shape) == (s_n, t_n, vh, vw, 3) and out.dtype == torch.float32, f"apply_streams: {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "apply_streams: non-finite output")
    st = e._states[(h, w, vw, vh, s_n, "const")]
    check(st.frame_count.tolist() == [t_n] * s_n, f"apply_streams: frame counts {st.frame_count.tolist()}")
    for i in range(s_n):
        own = engine(DEV).apply(frames[i])
        check(bool(torch.equal(out[i], own)), f"apply_streams: stream {i} differs from an engine of its own")
    cpu = engine("cpu").apply_streams(frames[:1, :2].cpu())
    dmax, frac = _cmp_u8(_quantized(engine(DEV).apply_streams(frames[:1, :2]).cpu()), _quantized(cpu), "apply_streams cuda vs cpu")
    say("17", f"apply_streams [{s_n},{t_n},{h},{w},3] -> [{s_n},{t_n},{vh},{vw},3] f32: ok (each stream == an engine "
        f"of its own; cuda vs cpu on 2 frames: max {dmax} step, {frac:.2e} of values)")
    del out
    seconds = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.apply_streams(frames)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    say("17", _rates("apply_streams", s_n * t_n, seconds, card))


def phase_apply_u8(gen, Engine):
    """apply_u8 against apply(output="u8") brought to the host, and one
    apply of a 1280x960 source under set_max_shader_resolution(640, 480)
    (CLAMP_SRC_HW, CLAMP_TO).
    Returns the resample_u8 launches of the two main runs."""
    import numpy as np
    import torch

    from retrocapture_tpu_torch.ops.cuda import resample as rs

    h, w = SRC_HW
    vw, vh = VIEWPORT

    def engine(dev, clamp=False):
        e = Engine(viewport=VIEWPORT, device=dev)
        check(e.load_preset(str(PRESET)), f"load_preset: {e.last_error}")
        if clamp:
            e.set_max_shader_resolution(*CLAMP_TO)
        return e

    frames = torch.randint(0, 256, (WARP_BATCH, h, w, 3), generator=gen, device=DEV, dtype=torch.uint8)
    rs.LAUNCHES = 0
    rs.general_blocks(reset=True)
    e = engine(DEV)
    got = e.apply_u8(frames)
    _engine_ok(e, "apply_u8")
    check(rs.LAUNCHES == 1, f"apply_u8: {rs.LAUNCHES} resample_u8 launches, want 1")
    check(isinstance(got, np.ndarray) and got.dtype == np.uint8 and got.shape == (WARP_BATCH, vh, vw, 3),
          f"apply_u8: {type(got).__name__} {getattr(got, 'dtype', None)} {getattr(got, 'shape', None)}")

    ch, cw = CLAMP_SRC_HW
    big = torch.randint(0, 256, (2, ch, cw, 3), generator=gen, device=DEV, dtype=torch.uint8)
    ec = engine(DEV, clamp=True)
    check(ec._clamped_source(cw, ch) == CLAMP_TO, f"clamp: {ec._clamped_source(cw, ch)}")
    clamped = ec.apply(big, output="u8")
    torch.cuda.synchronize()
    _engine_ok(ec, "clamped apply")
    launches = rs.LAUNCHES
    general = rs.general_blocks(reset=True)
    check(launches == 2, f"apply_u8 and the clamped apply: {launches} resample_u8 launches, want 2")
    check(general == 0, f"apply_u8 and the clamped apply: {general} resample_u8 units of work took the general path")
    check(tuple(clamped.shape) == (2, vh, vw, 3) and clamped.dtype == torch.uint8, f"clamp: {clamped.dtype} {tuple(clamped.shape)}")

    want = engine(DEV).apply(frames, output="u8").cpu().numpy()
    check(np.array_equal(got, want), "apply_u8 differs from apply(output='u8') brought to the host")
    dmax, frac = _cmp_u8(torch.from_numpy(got[:2]), engine("cpu").apply(frames[:2].cpu(), output="u8"), "apply_u8 cuda vs cpu")
    cmax, cfrac = _cmp_u8(clamped.cpu(), engine("cpu", clamp=True).apply(big.cpu(), output="u8"), "clamped apply cuda vs cpu")
    unclamped = engine(DEV).apply(big, output="u8")
    moved = float((unclamped != clamped).float().mean())
    check(moved > 0.01, f"clamp: the clamped output equals the unclamped one in {1 - moved:.3f} of values")
    say("18", f"apply_u8 {WARP_BATCH}x{h}x{w} -> numpy u8 {vh}x{vw}: ok (== apply(output='u8'); cuda vs cpu on 2 "
        f"frames: max {dmax} step, {frac:.2e}); {cw}x{ch} under set_max_shader_resolution{CLAMP_TO}: ok (cuda vs cpu "
        f"on 2 frames: max {cmax} step, {cfrac:.2e}; {moved:.3f} of values off the unclamped output); "
        f"resample_u8 launches {launches}, general-path units {general}")
    return launches


def phase_mip(gen, Engine, tmp):
    """The two mipmap_input presets: mip-glow (affine taps, one level of
    detail) and mip-warp (warped taps, one warp_sample launch per pyramid
    level for the batch). The inputs that the two runs give the blit and the
    warp kernel are recorded, and after the counts are read each kernel is
    held against its plain version on them: every pyramid level down to
    1x2 texels under the repeat wrap, and the blit from the glow pass's
    size. Returns the runs' (resample_u8, warp_sample) launches and the
    blit kernel's largest distance from its plain version in u8 steps (the
    warp kernel must equal its plain version bit for bit)."""
    import torch

    from retrocapture_tpu_torch.ops.cuda import resample as rs
    from retrocapture_tpu_torch.ops.cuda import warp_sample as ws
    from retrocapture_tpu_torch.ops.sampling import WRAP_MODES, _max_lod
    from retrocapture_tpu_torch.runtime import engine as engine_module

    glow, warp = write_mip_presets(tmp)
    h, w = SRC_HW
    vw, vh = VIEWPORT
    levels = _max_lod(h, w) + 1
    frames = torch.randint(0, 256, (MIP_BATCH, h, w, 3), generator=gen, device=DEV, dtype=torch.uint8)

    def engine(path, dev):
        e = Engine(viewport=VIEWPORT, device=dev)
        check(e.load_preset(path), f"load {path}: {e.last_error}")
        return e

    blit_calls = []
    blit_kernel = engine_module.blit_u8

    def blit_rec(tex, dst_w, dst_h):
        blit_calls.append(tex)
        return blit_kernel(tex, dst_w, dst_h)

    rs.LAUNCHES = ws.LAUNCHES = 0
    outs = {}
    engine_module.blit_u8 = blit_rec
    try:
        with launched(ws, "_warp_sample_op") as launches:
            for name, path in (("mip-glow", glow), ("mip-warp", warp)):
                e = engine(path, DEV)
                outs[name] = e.apply(frames, output="u8")
                torch.cuda.synchronize()
                _engine_ok(e, name)
                check(tuple(outs[name].shape) == (MIP_BATCH, vh, vw, 3) and outs[name].dtype == torch.uint8,
                      f"{name}: {outs[name].dtype} {tuple(outs[name].shape)}")
    finally:
        engine_module.blit_u8 = blit_kernel
    warp_calls = [(tex, u, v, {"filter_linear": lin, "wrap_mode": mode}) for tex, u, v, lin, mode in launches]
    counts = (rs.LAUNCHES, ws.LAUNCHES)
    check(counts[1] == levels, f"mip-warp: {counts[1]} warp_sample launches, want one a level ({levels}) for the "
          f"batch of {MIP_BATCH}")
    check(counts[0] == 2, f"mip presets: {counts[0]} resample_u8 launches, want 2")
    # The pyramid is in use: the glow pass loses the texture's fine detail.
    flat = float(outs["mip-glow"].float().std())
    check(flat < 0.6 * float(frames.float().std()), f"mip-glow: output std {flat:.1f} of input {float(frames.float().std()):.1f}")
    res = []
    for name, path in (("mip-glow", glow), ("mip-warp", warp)):
        cpu = engine(path, "cpu").apply(frames[:2].cpu(), output="u8")
        res.append(_cmp_u8(outs[name][:2].cpu(), cpu, f"{name} cuda vs cpu"))
    say("19", f"mipmap_input presets {MIP_BATCH}x{h}x{w} -> {vh}x{vw} u8: ok (mip-glow cuda vs cpu on 2 frames: max "
        f"{res[0][0]} step, {res[0][1]:.2e}; mip-warp: max {res[1][0]} step, {res[1][1]:.2e}; warp_sample launches "
        f"{counts[1]} = {levels} levels, each of the {MIP_BATCH} frames)")

    # Each kernel against its plain version on what the runs gave it (these
    # launches come after the counts were read). The end-to-end gate above
    # cannot see the upper levels: their blend weight is 0 where the level
    # of detail stays below them.
    check(len(warp_calls) == counts[1] and len(blit_calls) == counts[0], "mip: a launch went unrecorded")
    shapes = sorted({tuple(c[0].shape[1:3]) for c in warp_calls}, reverse=True)
    check(all(c[0].shape[0] == MIP_BATCH for c in warp_calls), "mip-warp: a level was not launched for the batch")
    want_shapes = [(max(h >> k, 1), max(w >> k, 1)) for k in range(levels)]
    check(shapes == want_shapes, f"mip-warp: sampled levels {shapes}, want {want_shapes}")
    for tex, u, v, kw in warp_calls:
        check(kw == {"filter_linear": True, "wrap_mode": "repeat"} and tuple(u.shape) == (vh, vw), f"mip-warp tap: {kw}")
        got, want = ws.warp_sample(tex, u, v, **kw), ws.warp_sample_plain(tex, u, v, **kw)
        check(bool(torch.equal(got, want)), f"mip-warp level {tuple(tex.shape)}: kernel not bit-equal to its plain "
              f"version (max |d| {float((got - want).abs().max()):.3e})")
    # The other wrap modes and NEAREST at every level's size, on the last
    # frame's pyramid and grid.
    for tex, u, v, _ in warp_calls[-levels:]:
        for lin in (False, True):
            for mode in WRAP_MODES:
                kw = {"filter_linear": lin, "wrap_mode": mode}
                got, want = ws.warp_sample(tex, u, v, **kw), ws.warp_sample_plain(tex, u, v, **kw)
                check(bool(torch.equal(got, want)), f"warp_sample {tuple(tex.shape)} {kw}: not bit-equal to its plain version")
    say("19", f"warp_sample at the {len(warp_calls)} recorded mip-warp taps (levels {shapes[0]} .. {shapes[-1]}, LINEAR "
        f"repeat @ {vh}x{vw}) and at every level x filter x wrap mode: bit-equal to its plain version")
    check(tuple(blit_calls[0].shape) == (MIP_BATCH, int(h * 0.3), int(w * 0.3), 3), f"mip-glow blit from {tuple(blit_calls[0].shape)}")
    return counts, max(check_blit(tex, vh, vw, "19") for tex in blit_calls)


def phase_cli(tmp):
    """python -m retrocapture_tpu_torch's main() in process, on the card:
    16 frames of the test pattern through feedback-ghost to 1080p."""
    import numpy as np

    from retrocapture_tpu_torch import cli

    prefix = Path(tmp) / "cli-out"
    rc = cli.main([
        "--source", "test", "--preset", "assets/presets/feedback-ghost.glslp", "--viewport",
        f"{VIEWPORT[0]}x{VIEWPORT[1]}", "--frames", str(CLI_FRAMES), "--batch", "8", "--stats", "--output", str(prefix),
    ] + (["--cpu"] if DEV == "cpu" else []))
    check(rc == 0, f"cli: main returned {rc}")
    out = np.load(str(prefix) + ".npy", mmap_mode="r")
    check(out.shape == (CLI_FRAMES, VIEWPORT[1], VIEWPORT[0], 3) and out.dtype == np.float32, f"cli: {out.dtype} {out.shape}")
    check(bool(np.isfinite(out[0]).all()) and float(out[-1].std()) > 0.05, "cli: empty or non-finite frames")
    check(not Path(str(prefix) + ".png").exists(), "cli: a PNG was written for a batch of frames")
    say("20", f"cli main(--source test --preset assets/presets/feedback-ghost.glslp --viewport 1920x1080 --frames "
        f"{CLI_FRAMES} --batch 8 --stats --output ...): ok (returned 0, .npy {list(out.shape)})")
    del out


@contextlib.contextmanager
def engaged(names):
    """Count, for the duration of a block, the calls of the kernel
    library's entries ``names`` that engaged (returned a frame) and that
    declined."""
    from retrocapture_tpu_torch.graph import kernels as tk

    counts = {"engaged": 0, "declined": 0}
    originals = {n: tk._REGISTRY[n] for n in names}

    def wrap(fn):
        def entry(ctx, sh):
            out = fn(ctx, sh)
            counts["engaged" if out is not None else "declined"] += 1
            return out

        return entry

    tk._REGISTRY.update({n: wrap(fn) for n, fn in originals.items()})
    try:
        yield counts
    finally:
        tk._REGISTRY.update(originals)


def _library_slice(gen, Engine, phase, label, path, names, batch, passes, variants):
    """A kernel-library family through Engine.apply at 1080p: 3 applies at
    ``batch`` (every pass through its entry in each walk of the batch, one
    blit launch an apply),
    CUDA against the port's CPU run on 2 frames, one apply at
    VARIANT_BATCH of each (label, preset) in ``variants`` (also against
    the CPU run). Returns the engine, the frames, the blit launches and
    the blit's source shape."""
    import torch

    from retrocapture_tpu_torch.ops.cuda import resample as rs

    h, w = SRC_HW
    vw, vh = VIEWPORT
    frames = torch.randint(0, 256, (batch, h, w, 3), generator=gen, device=DEV, dtype=torch.uint8)
    e = Engine(viewport=VIEWPORT, device=DEV)
    check(e.load_preset(str(path)), f"{label}: load_preset: {e.last_error}")
    blits = []
    blit_kernel = rs.blit_u8

    def blit_rec(tex, dst_w, dst_h):
        blits.append(tuple(tex.shape))
        return blit_kernel(tex, dst_w, dst_h)

    from retrocapture_tpu_torch.runtime import engine as engine_module

    rs.LAUNCHES = 0
    rs.general_blocks(reset=True)
    engine_module.blit_u8 = blit_rec
    try:
        with engaged(names) as calls:
            for i in range(3):
                out = e.apply(frames, output="u8")
                torch.cuda.synchronize()
                _engine_ok(e, f"{label} apply {i}")
                check(tuple(out.shape) == (batch, vh, vw, 3) and out.dtype == torch.uint8
                      and out.device.type == torch.device(DEV).type, f"{label}: {out.dtype} {tuple(out.shape)} on {out.device}")
    finally:
        engine_module.blit_u8 = blit_kernel
    launches, general = rs.LAUNCHES, rs.general_blocks(reset=True)
    walks = walks_an_apply(e, batch)
    check(calls == {"engaged": 3 * walks * passes, "declined": 0}, f"{label}: entries {calls}, want "
          f"{3 * walks * passes} engaged ({walks} walks an apply)")
    check(launches == 3 and len(blits) == 3, f"{label}: {launches} resample_u8 launches, want 3")
    check(general == 0, f"{label}: {general} resample_u8 units of work took the general path")
    check(int(e._states[(h, w) + VIEWPORT].frame_count) == 3 * batch, f"{label}: frame count not carried")
    check(float(out.float().std()) > 5.0, f"{label}: a flat output")
    res = {}
    for name, vpath, dev in [(label, path, DEV)] + [(n, vp, DEV) for n, vp in variants]:
        outs = []
        for d in (dev, "cpu"):
            ev = Engine(viewport=VIEWPORT, device=d)
            check(ev.load_preset(str(vpath)), f"{name} {d}: load_preset: {ev.last_error}")
            with engaged(names) as vcalls:
                n = VARIANT_BATCH if (d != "cpu" and name != label) else 2
                o = ev.apply(frames[:n].to(d), output="u8")
            _engine_ok(ev, f"{name} {d}")
            want = walks_an_apply(ev, n) * passes
            check(vcalls == {"engaged": want, "declined": 0}, f"{name} {d}: entries {vcalls}, want {want}")
            outs.append(o[:2].cpu())
        res[name] = _cmp_u8(outs[0], outs[1], f"{name} cuda vs cpu")
    say(phase, f"{label} {batch}x{h}x{w} rgb -> {vh}x{vw} u8, 3 applies: ok (entries engaged {calls['engaged']}: "
        f"{walks} walk(s) an apply, {passes} passes; "
        f"blit from {blits[0][1:3]}, resample_u8 launches {launches}, general-path units {general}; cuda vs cpu on 2 "
        f"frames: " + "; ".join(f"{n} max {d} step, {f:.2e}" for n, (d, f) in res.items())
        + f"; variants at batch {VARIANT_BATCH})")
    return e, frames, launches, blits[0]


def _slice_rate(phase, label, e, frames, card):
    """frames/s over 2 applies after warm-up, the device's busy time of one
    apply (torch.profiler) and its idle share."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        e.apply(frames, output="u8")
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 2
    dev_ms = device_ms(lambda: e.apply(frames, output="u8"), 1)
    say(phase, f"{label} slice: {len(frames) / dt:.1f} frames/s at batch {len(frames)} ({dt * 1e3:.1f} ms per apply; "
        f"device busy {dev_ms:.1f} ms of it, idle {100.0 * (1.0 - dev_ms / (dt * 1e3)):.1f}%)  ({card})")


def _host_profile(phase, label, e, frames):
    """The four functions with the most own host time in an 8-frame apply
    (cProfile), per frame."""
    import torch

    prof = cProfile.Profile()
    prof.enable()
    e.apply(frames[:8], output="u8")
    torch.cuda.synchronize()
    prof.disable()
    top = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:4]
    say(phase, f"{label} host profile of an 8-frame apply, by own time: " + "; ".join(
        f"{fn[2]} ({Path(fn[0]).name}:{fn[1]}) {st[2] * 1e3 / 8:.1f} ms/frame" for fn, st in top))


def _product_ms(fn, iters=50):
    fn()
    return (event_ms(fn, iters) + event_ms(fn, iters)) / 2


# Phase 23: each slice path replayed by CUDA graph against the uncaptured
# walk (RCTPU_REPLAY=0): (name, preset, input format, batch, traced
# parameter and the values it takes before the second and third apply).
REPLAY_APPLIES = 3  # counted applies of each mode, a parameter change between them
REPLAY_F32_BATCH = 8  # the f32 apply of each mode


def _replay_paths(tmp):
    from _mattias_standin import write_standin as write_mattias
    from _ntsc_standin import write_chain as write_ntsc
    from _xbr_standin import write_standin as write_xbr

    (tmp / "warp-curve.glslp").write_text(WARP_GLSLP)
    (tmp / "warp-curve.glsl").write_text(WARP_GLSL)
    return [
        ("feedback-ghost-nv12", PRESET, "nv12", SLICE_BATCH, None),
        ("feedback-ghost-nv12 traced", PRESET, "nv12", SLICE_BATCH, ("GHOST", (0.8, 0.2))),
        ("xbr-lv2", write_xbr(str(tmp)), "rgb", XBR_BATCH, None),
        ("ntsc-320px", write_ntsc(str(tmp), NTSC_WIDTH), "rgb", NTSC_BATCH, None),
        ("crt-mattias traced", write_mattias(str(tmp)), "rgb", MATTIAS_BATCH, ("CURVATURE", (0.8, 0.3))),
        ("warp-curve traced", tmp / "warp-curve.glslp", "rgb", WARP_BATCH, ("CURV", (0.5, 0.1))),
    ]


# The kernel wrappers' launch counters, by the kernel's name in the JSON
# line, and the name of the kernel's __global__ function (csrc/*.cu) in
# torch.profiler's CUDA activity.
_COUNTERS = {
    "resample_u8": ("resample", "LAUNCHES", "resample_u8_kernel"),
    "resample_xphase": ("resample", "XPHASE_LAUNCHES", "resample_xphase_kernel"),
    "warp_sample": ("warp_sample", "LAUNCHES", "warp_sample_kernel"),
    "blur_groups_v2": ("blur_groups", "LAUNCHES", "blur_groups_kernel"),
    "xbr_epilogue": ("xbr_epilogue", "LAUNCHES", "xbr_epilogue_kernel"),
    "mirrors": ("mirrors", "LAUNCHES", "mirror_kernel"),
    "fma": ("fma", "LAUNCHES", "::fma_"),
}


def _counts(reset=False):
    """The wrappers' launch calls since their last reset."""
    import importlib

    out = {}
    for name, (mod, attr, _) in _COUNTERS.items():
        m = importlib.import_module(f"retrocapture_tpu_torch.ops.cuda.{mod}")
        out[name] = getattr(m, attr)
        if reset:
            setattr(m, attr, 0)
    return out


def kernel_runs(fn):
    """How many times the device ran each of the port's kernels during one
    call of fn (inside a CUDA graph or not): its executions in
    torch.profiler's CUDA activity, by the kernel's function name."""
    names = [e.name for e in device_records(fn)]
    return {k: sum(fname in n for n in names) for k, (_, _, fname) in _COUNTERS.items()}


# The operators whose launches phase 23 records the shapes of (module under
# retrocapture_tpu_torch.ops.cuda, operator), by the kernel's JSON name.
_OPS = {
    "warp_sample": ("warp_sample", "_warp_sample_op"),
    "blur_groups_v2": ("blur_groups", "_blur_groups_op"),
    "xbr_epilogue": ("xbr_epilogue", "_xbr_epilogue_op"),
    "mirrors": ("mirrors", "_mirror_op"),
    "fma": ("fma", "_fma_op"),
}


@contextlib.contextmanager
def launch_shapes():
    """The shapes of the launches of the operators of _OPS in a block, by
    kernel name."""
    import importlib

    with contextlib.ExitStack() as stack:
        yield {
            k: stack.enter_context(launched(importlib.import_module(f"retrocapture_tpu_torch.ops.cuda.{m}"), op, True))
            for k, (m, op) in _OPS.items()
        }


@contextlib.contextmanager
def kept_launches():
    """The wrappers' launch calls, by kernel name, made in a block while a
    walk builds what its program keeps in its tables
    (``graph/kernels._kept``: crt-mattias's comb mask is an fma launch).
    Only the first walk of a program builds them; a build that is not kept
    (no program, or ``keep`` false) is part of every walk and not counted."""
    from retrocapture_tpu_torch.graph import kernels as tk

    made = dict.fromkeys(_COUNTERS, 0)
    kept = tk._kept

    def counting(key, build, keep=True):
        if not keep or tk.walk_program() is None:
            return kept(key, build, keep)

        def counted():
            before = _counts()
            try:
                return build()
            finally:
                for k, n in _counts().items():
                    made[k] += n - before[k]

        return kept(key, counted, keep)

    tk._kept = counting
    try:
        yield made
    finally:
        tk._kept = kept


def phase_replay(gen, Engine, tmp, card):
    """Each slice path at 1080p through an engine that replays its chain by
    CUDA graph and one that walks it (RCTPU_REPLAY=0): bit-equal in u8 on
    every counted apply (a traced parameter changed between them) and in
    f32 on one more; the replaying engine walks nothing uncaptured; a
    stateless path is one walk and one graph replay an apply (the batched
    branch), a temporal one a replay a frame; each mode's frames/s over 3
    windows, device busy and idle share, first-apply seconds and peak
    device memory, and the shapes of the kernels' launches. In one more
    replayed apply of each path the device runs each kernel as often as the
    walk launches it in an apply, and the wrappers launch none but the blit
    (torch.profiler's count of the kernel's executions). Writes the paths'
    results to chiprun_out/replay.json. Returns the replaying runs' launch
    calls (the first walk, the capture and the blits) and the kernels'
    executions inside the graphs, summed over the paths."""
    import torch

    h, w = SRC_HW
    vw, vh = VIEWPORT
    launches = dict.fromkeys(_COUNTERS, 0)
    in_graph = dict.fromkeys(_COUNTERS, 0)
    record = {"card": card, "paths": []}
    for name, path, fmt, batch, param in _replay_paths(tmp):
        shape = (batch, h * 3 // 2, w) if fmt == "nv12" else (batch, h, w, 3)
        frames = [torch.randint(0, 256, shape, generator=gen, device=DEV, dtype=torch.uint8)
                  for _ in range(REPLAY_APPLIES)]
        engines, outs, first_s, windows, counted, peak, first_counted = {}, {}, {}, {}, {}, {}, {}
        first_kept, kept = {}, {}
        for mode in ("1", "0"):
            e = Engine(viewport=VIEWPORT, device=DEV)
            check(e.load_preset(str(path)), f"23 {name}: load_preset: {e.last_error}")
            e.set_input_format(fmt)
            if param is not None:
                e.set_param_mode("traced")
            engines[mode] = e
            with env(RCTPU_REPLAY=mode), kept_launches() as kept[mode]:
                _counts(reset=True)
                got, seconds = [], []
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()  # what the run holds before this mode's first apply
                for k in range(REPLAY_APPLIES):
                    if k and param is not None:
                        check(e.set_parameter(param[0], param[1][k - 1]), f"23 {name}: set_parameter")
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with launch_shapes() if (mode, k) == ("0", 0) else contextlib.nullcontext() as shapes:
                        got.append(e.apply(frames[k], output="u8"))
                    torch.cuda.synchronize()
                    seconds.append(time.perf_counter() - t0)
                    if k == 0:
                        first_counted[mode], first_kept[mode] = _counts(), dict(kept[mode])
                    if (mode, k) == ("0", 0):
                        # {kernel: {launch shape: launches}} of a walked apply.
                        kernel_shapes = {n: {str(list(sh)): v.count(sh) for sh in dict.fromkeys(v)}
                                         for n, v in shapes.items() if v}
                peak[mode] = (torch.cuda.max_memory_allocated() - held) / 2**30
                # The first apply walks (and captures); the later ones are
                # timing windows.
                first_s[mode], windows[mode] = seconds[0], seconds[1:]
                counted[mode] = _counts()
                outs[mode] = got
            _engine_ok(e, f"23 {name} RCTPU_REPLAY={mode}")
        for k in range(REPLAY_APPLIES):
            check(torch.equal(outs["1"][k], outs["0"][k]), f"23 {name}: apply {k} replayed differs from the walk")
        f32 = {}
        for mode, e in engines.items():
            with env(RCTPU_REPLAY=mode):
                f32[mode] = e.apply(frames[0][:REPLAY_F32_BATCH], output="f32")
        check(torch.equal(f32["1"], f32["0"]), f"23 {name}: the f32 apply replayed differs from the walk")
        del outs, f32
        rp = engines["1"]
        temporal = rp._program.uses_history() or rp._program.uses_feedback()
        stats = rp.replay_stats()
        check(stats["uncaptured_applies"] == 0, f"23 {name}: {stats['uncaptured_applies']} applies walked uncaptured")
        # A temporal chain's frame step is one graph; a stateless chain's
        # batch is one, per batch size (the f32 apply above is another).
        want_graphs = 1 if temporal or batch == REPLAY_F32_BATCH else 2
        check(stats["graphs_captured"] == want_graphs,
              f"23 {name}: {stats['graphs_captured']} graphs captured, want {want_graphs}")
        # The walk launches each kernel the same number of times an apply,
        # but for what the first apply builds for the program's tables and
        # later applies read back (crt-mattias's comb mask); a replayed
        # apply must run it as often on the device, with no launch call but
        # the blit's.
        check(kept["0"] == first_kept["0"], f"23 {name}: walked applies after the first built kept tables, "
              f"{kept['0']} launches against the first's {first_kept['0']}")
        per_apply = {}
        for k, n in counted["0"].items():
            later, first = n - first_counted["0"][k], first_counted["0"][k] - first_kept["0"][k]
            check(later == first * (REPLAY_APPLIES - 1),
                  f"23 {name}: {k} launched {first} times in the first walked apply (less {first_kept['0'][k]} for "
                  f"the kept tables), {later} in the {REPLAY_APPLIES - 1} after it")
            per_apply[k] = first
        _counts(reset=True)
        replays0 = rp.replay_stats()["replays"]
        runs = kernel_runs(lambda: rp.apply(frames[0], output="u8"))
        calls = _counts()
        replays = rp.replay_stats()["replays"] - replays0
        check(replays == (batch if temporal else 1), f"23 {name}: {replays} graph replays in an apply of {batch}, "
              f"want {batch if temporal else 1}")
        check(runs == per_apply, f"23 {name}: a replayed apply ran {runs} on the device, the walk launches {per_apply}")
        graph_runs = {k: runs[k] - calls[k] for k in runs}
        check(calls["resample_u8"] == 1 and sum(calls.values()) == 1,
              f"23 {name}: launch calls in a replayed apply {calls}, want the blit's alone")
        for k in launches:
            launches[k] += counted["1"][k]
            in_graph[k] += graph_runs[k]
        # Rates (the counted applies after the first, and more windows up to
        # WINDOWS), device busy and idle share of each mode.
        modes = {}
        for mode, e in engines.items():
            with env(RCTPU_REPLAY=mode):
                seconds = windows[mode]
                while len(seconds) < WINDOWS:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    e.apply(frames[0], output="u8")
                    torch.cuda.synchronize()
                    seconds.append(time.perf_counter() - t0)
                busy = device_ms(lambda: e.apply(frames[0], output="u8"), 1)
            wall = sorted(seconds)[len(seconds) // 2] * 1e3
            fps = sorted(batch / t for t in seconds)
            modes[mode] = {"frames_per_s": fps, "device_busy_ms": busy, "median_apply_ms": wall,
                           "idle_pct": 100.0 * (1.0 - busy / wall), "first_apply_s": first_s[mode],
                           "peak_memory_gib": peak[mode], "launch_calls": counted[mode]}
            say("23", f"{name} batch {batch}, RCTPU_REPLAY={mode}: " + _rates("", batch, seconds, card).lstrip(": ")
                + f"; device busy {busy:.1f} ms an apply, idle {modes[mode]['idle_pct']:.1f}% of the median "
                f"{wall:.1f} ms; first apply {first_s[mode]:.2f} s; peak memory {peak[mode]:.2f} GiB above what "
                "the run held before")
        stats = rp.replay_stats()
        record["paths"].append({"name": name, "batch": batch, "temporal": temporal, "replay": modes["1"],
                                "walk": modes["0"], "replay_stats": stats, "replays_an_apply": replays,
                                "kernel_runs_replayed_apply": runs, "graph_runs_replayed_apply": graph_runs,
                                "kernel_launch_shapes": kernel_shapes})
        say("23", f"{name}: replay == walk in u8 ({REPLAY_APPLIES} applies of {batch}"
            + (f", {param[0]} set between them" if param else "") + f") and f32 ({REPLAY_F32_BATCH} frames); "
            f"replay_stats {stats}; graph replays an apply {replays} ({'a frame' if temporal else 'the batch'}); "
            f"launch calls {counted['1']}; one replayed apply ran {runs} on the device, {graph_runs} of them inside "
            f"the graph; kernel launch shapes {kernel_shapes}")
        del engines, frames
        torch.cuda.empty_cache()
    # The blit runs once a batch after the replays. Its alternative, inside
    # each frame's graph, launches it once a frame: the same kernel at batch
    # 1, B times, against one launch at batch B (feedback-ghost's 1080p ->
    # 1080p and a 240x320 -> 1080p pass).
    from retrocapture_tpu_torch.ops.cuda import resample as rs

    for bh, bw, b in ((vh, vw, SLICE_BATCH), (h, w, SLICE_BATCH)):
        tex = knife_tex(gen, (b, bh, bw, 3), DEV)
        one = tex[:1].contiguous()
        rs.blit_u8(one, vw, vh)
        batched = (event_ms(lambda: rs.blit_u8(tex, vw, vh), 5) + event_ms(lambda: rs.blit_u8(tex, vw, vh), 5)) / 2
        # b launches at batch 1 in one graph, as a frame's graph would hold them.
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(b):
                rs.blit_u8(one, vw, vh)
        per_frame = (event_ms(graph.replay, 2) + event_ms(graph.replay, 2)) / 2
        del graph
        record.setdefault("blit", []).append({"shape": [b, bh, bw, 3], "once_a_batch_ms": batched,
                                              "once_a_frame_in_graph_ms": per_frame})
        say("23", f"blit [{b},{bh},{bw},3] -> {vh}x{vw} u8: once a batch {batched:.3f} ms; once a frame (as inside each "
            f"frame's graph: {b} launches at batch 1 in one graph) {per_frame:.3f} ms  ({card})")
        del tex, one
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "replay.json").write_text(json.dumps(record, indent=1))
    say("23", f"wrote {out / 'replay.json'}")
    return launches, in_graph


# Phase 25: the batched kernel launches of the stateless paths, each held to
# its plain version on its own recorded inputs: (kernel, phase-23 path,
# module under retrocapture_tpu_torch.ops.cuda, operator).
BATCHED_LAUNCHES = [
    ("warp_sample", "warp-curve traced", "warp_sample", "_warp_sample_op"),
    ("blur_groups_v2", "crt-mattias traced", "blur_groups", "_blur_groups_op"),
    ("xbr_epilogue", "xbr-lv2", "xbr_epilogue", "_xbr_epilogue_op"),
]
STREAMS_25 = (4, 32)  # apply_streams of feedback-ghost: S streams of T frames
XBR_PLAIN_CHUNK = 8  # frames a call of the plain xbr epilogue (bounds its memory)


def _path_engine(Engine, path, fmt, param, dev=DEV):
    e = Engine(viewport=VIEWPORT, device=dev)
    check(e.load_preset(str(path)), f"25: load {path}: {e.last_error}")
    e.set_input_format(fmt)
    if param is not None:
        e.set_param_mode("traced")
    return e


def phase_batched(gen, Engine, tmp, card):
    """The batched branch of the stateless chains on the card:

    * each stateless phase-23 path's batch replayed by its CUDA graph (a
      warm apply, ``reset_state``, the apply that replays) against the
      port's CPU run of its first 2 frames: at most 1 u8 step in at most
      0.1% of values;
    * ntsc-320px at batch 128, fc-period grouped against
      ``RCTPU_FC_GROUP=0``, two applies each: bit-equal;
    * ``apply_streams`` of feedback-ghost on [4, 32, 240, 320, 3] (one
      graph of the 4 streams' step, replayed 32 times) against four
      engines, two calls: bit-equal;
    * each batched kernel launch of the paths (BATCHED_LAUNCHES), recorded
      in a walked apply, against its plain version on the same inputs, bit
      for bit, timed in turns beside it, with its bound and, for the warp,
      F.grid_sample over the same batch.

    Returns {kernel: its batched launch's shape, |d|, times and bound}."""
    import importlib

    import torch
    import torch.nn.functional as F

    h, w = SRC_HW
    vw, vh = VIEWPORT
    paths = {name: (path, fmt, batch, param) for name, path, fmt, batch, param in _replay_paths(tmp)}
    for name, (path, fmt, batch, param) in paths.items():
        e = _path_engine(Engine, path, fmt, param)
        if e._program.uses_history() or e._program.uses_feedback():
            continue
        frames = torch.randint(0, 256, (batch, h, w, 3), generator=gen, device=DEV, dtype=torch.uint8)
        e.apply(frames, output="u8")
        e.reset_state()  # the programs stay: the next apply replays from FrameCount 0
        replays = e.replay_stats()["replays"]
        out = e.apply(frames, output="u8")
        torch.cuda.synchronize()
        _engine_ok(e, f"25 {name}")
        check(e.replay_stats()["replays"] == replays + 1, f"25 {name}: the apply did not replay the batch's graph")
        cpu = _path_engine(Engine, path, fmt, param, "cpu").apply(frames[:2].cpu(), output="u8")
        dmax, frac = _cmp_u8(out[:2].cpu(), cpu, f"25 {name} batched graph vs cpu")
        say("25", f"{name}: the batch of {batch} replayed by one graph vs the port's CPU run of its first 2 frames: "
            f"max {dmax} step, {frac:.2e} of values")
        del e, out, frames
        torch.cuda.empty_cache()

    path, fmt, batch, _ = paths["ntsc-320px"]
    frames = [torch.randint(0, 256, (batch, h, w, 3), generator=gen, device=DEV, dtype=torch.uint8) for _ in range(2)]
    got = {}
    for group in ("1", "0"):
        e = _path_engine(Engine, path, fmt, None)
        with env(RCTPU_FC_GROUP=group):
            got[group] = [e.apply(f, output="u8") for f in frames]
        _engine_ok(e, f"25 ntsc RCTPU_FC_GROUP={group}")
        groups = {k[-1] for k in e._programs}
        check(groups == ({(2, 0)} if group == "1" else {None}), f"25 ntsc RCTPU_FC_GROUP={group}: programs {groups}")
    for k in range(2):
        check(torch.equal(got["1"][k], got["0"][k]), f"25 ntsc apply {k}: grouped differs from RCTPU_FC_GROUP=0")
    say("25", f"ntsc-320px at batch {batch}, two applies: fc-period grouped (2 walks of {batch // 2}, one host "
        f"FrameCount each) == RCTPU_FC_GROUP=0, bit for bit")
    del got, frames
    torch.cuda.empty_cache()

    s_n, t_n = STREAMS_25
    streams = [torch.randint(0, 256, (s_n, t_n, h, w, 3), generator=gen, device=DEV, dtype=torch.uint8)
               for _ in range(2)]
    e = Engine(viewport=VIEWPORT, device=DEV)
    check(e.load_preset(str(PRESET)), f"25 streams: load_preset: {e.last_error}")
    seconds, outs = [], []
    for f in streams:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(e.apply_streams(f))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    _engine_ok(e, "25 streams")
    stats = e.replay_stats()
    check(stats["graphs_captured"] == 1 and stats["uncaptured_applies"] == 0, f"25 streams: replay_stats {stats}")
    for i in range(s_n):
        own = Engine(viewport=VIEWPORT, device=DEV)
        check(own.load_preset(str(PRESET)), "25 streams: load_preset")
        for k, f in enumerate(streams):
            check(torch.equal(outs[k][i], own.apply(f[i])), f"25 streams: stream {i}, call {k} differs from an "
                  "engine of its own")
    say("25", f"apply_streams feedback-ghost [{s_n},{t_n},{h},{w},3], two calls: each stream == an engine of its own "
        f"(bit for bit); one graph of the {s_n} streams' step, replay_stats {stats}; second call "
        f"{s_n * t_n / seconds[1]:.1f} frames/s  ({card})")
    del outs, streams, e
    torch.cuda.empty_cache()

    results = {}
    for kernel, pname, mod, op in BATCHED_LAUNCHES:
        m = importlib.import_module(f"retrocapture_tpu_torch.ops.cuda.{mod}")
        path, fmt, batch, param = paths[pname]
        frames = torch.randint(0, 256, (batch, h, w, 3), generator=gen, device=DEV, dtype=torch.uint8)
        e = _path_engine(Engine, path, fmt, param)
        with env(RCTPU_REPLAY="0"), launched(m, op) as calls:
            e.apply(frames, output="u8")
        _engine_ok(e, f"25 {pname}")
        check(len(calls) == 1, f"25 {pname}: {len(calls)} {kernel} launches in a walked apply, want 1")
        args = calls[0]
        check(args[0].shape[0] == batch, f"25 {pname}: {kernel} launched over {args[0].shape[0]} frames, want {batch}")
        op_fn = getattr(m, op)
        if kernel == "warp_sample":
            tex, u, v, lin, mode = args
            plain = lambda: m.warp_sample_plain(tex, u, v, filter_linear=lin, wrap_mode=mode)  # noqa: E731
            in_bytes = nbytes(tex, u, v)
            out_bytes = tex.shape[0] * u.numel() * tex.shape[-1] * 4
            flops = 40 * tex.shape[0] * u.numel()  # 4 taps x 4 channels and the tap positions, per pixel
            grid = torch.stack([u * 2.0 - 1.0, v * 2.0 - 1.0], dim=-1)[None].expand(tex.shape[0], -1, -1, -1)
            t_nchw = tex.permute(0, 3, 1, 2).contiguous()
            check(lin and mode == "clamp_to_border", f"25 warp: {lin} {mode}")
            lib = lambda: F.grid_sample(t_nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=False)  # noqa: E731
        elif kernel == "blur_groups_v2":
            tex, u, v, params, chan, channels = args
            plain = lambda: m._plain(tex, u, v, params, channels)  # noqa: E731
            in_bytes = nbytes(tex, u, v)
            out_bytes = len(set(channels)) * tex.shape[0] * u.numel() * 4
            flops = 2 * 25 * len(channels) * tex.shape[0] * u.numel()
            lib = None
        else:
            S, bx, fpx, fpy = args[:4]

            def plain():
                return torch.cat([m.xbr_epilogue_plain(S[i:i + XBR_PLAIN_CHUNK], bx, fpx, fpy)
                                  for i in range(0, S.shape[0], XBR_PLAIN_CHUNK)])

            in_bytes = nbytes(S, bx, fpx, fpy) + 4 * 65
            out_bytes = S.shape[0] * S.shape[2] * bx.shape[0] * 16
            flops = 253 * S.shape[0] * S.shape[2] * bx.shape[0]
            lib = None
        got = op_fn(*args)
        want = plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.equal(got, want)), f"25 {kernel} at {tuple(args[0].shape)}: not bit-equal to its plain "
              f"version (max |d| {err:.3e})")
        del got, want
        plain_ms, k_ms = in_turns(plain, lambda: op_fn(*args), 10, device_ms,
                                  kernel_timer=launch_timer(kernel.rsplit("_v", 1)[0]), plain_iters=1)
        b_ms, b_by = bound(in_bytes + out_bytes, flops)
        lib_ms = None if lib is None else _product_ms(lib, 10)
        results[kernel] = {"shape": list(args[0].shape), "max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        say("25", f"{kernel} launched once over the batch of {pname} ({tuple(args[0].shape)}): bit-equal to its "
            f"plain version; kernel {k_ms:.4f} ms ({k_ms / batch:.4f} a frame), plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})" + ("" if lib_ms is None else f", F.grid_sample {lib_ms:.4f} ms") + f"  ({card})")
        del calls, args, e, frames
        torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def plain_mirror_calls():
    """Count, for the duration of a block, the calls of the mirrors' plain
    versions (``policy.sinf32``, ``logf32``, ``log2f32``, ``expf32``) on a
    CUDA tensor, wherever a module of the port holds them. On the card the
    operator ``rctpu::mirror`` runs the kernel and never a plain version,
    so every such call is a call site that bypasses the kernel. Yields the
    list of the functions' names, one a call."""
    import torch

    from retrocapture_tpu_torch import policy

    calls = []
    originals = {n: getattr(policy, n) for n in ("sinf32", "logf32", "log2f32", "expf32")}

    def counting(name, fn):
        def f(x, *args, **kwargs):
            if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                calls.append(name)
            return fn(x, *args, **kwargs)

        return f

    patched = [(m, n, fn) for key, m in list(sys.modules.items()) if key.startswith("retrocapture_tpu_torch")
               for n, fn in originals.items() if getattr(m, n, None) is fn]
    for m, n, fn in patched:
        setattr(m, n, counting(n, fn))
    try:
        yield calls
    finally:
        for m, n, fn in patched:
            setattr(m, n, fn)


def mirror_bound(x, op):
    """(bound_ms, bound_by) of the mirror kernel's op on ``x``: 8 bytes an
    element over the memory rate, or its operations (MIRROR_OPS): f64 over
    the f64 issue rate (F64_ISSUE_S), f32 over the f32 rate."""
    t_bytes = 8 * x.numel() / PEAK_BYTES_S * 1e3
    f64, f32 = MIRROR_OPS[op]
    t_ops = x.numel() * max(f64 / F64_ISSUE_S, f32 / PEAK_F32_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_mirrors(gen, Engine, tmp, card):
    """Phase 26, the numerics mirrors' kernel (csrc/mirrors.cu) against its
    plain versions on the card:

    * sin, log, log2 and exp over all 2^32 f32 bit patterns, in chunks of
      SWEEP_CHUNK; the pow at every exponent of POW_EXPONENTS over
      POW_SAMPLE random bit patterns: bit-equal where the plain version is
      not NaN, NaN where it is;
    * the kernel at the main paths' own calls, recorded in a walked apply:
      crt-mattias's largest pow (the output gamma over the batch's 1080p
      planes) and nnedi3's largest exp, bit-equal to the plain version on
      the same inputs and timed in turns beside it, with their bound.

    Returns (the sweep's description, {path: the call's numbers}, the
    largest absolute difference from plain over all it compared)."""
    import numpy as np
    import torch

    from _mattias_standin import write_standin
    from _nnedi3_standin import write_chain
    from retrocapture_tpu_torch.ops.cuda import mirrors as mr

    t0 = time.perf_counter()
    worst = 0.0
    for op in ("sin", "log", "log2", "exp"):
        for s in range(0, 1 << 32, SWEEP_CHUNK):
            x = torch.arange(s - 2**31, s - 2**31 + SWEEP_CHUNK, dtype=torch.int64, device=DEV)
            x = x.to(torch.int32).view(torch.float32)
            got, want = mr._mirror(x, op), mr.mirror_plain(x, op)
            check(same_bits(got, want), f"26 mirror {op}: not bit-equal to its plain version in the chunk at {s:#x}")
            worst = max(worst, abs_err(got, want))
    for p in POW_EXPONENTS:
        c = float(np.float32(np.float32(np.float32(p) * np.float32(1.0 / np.log(2.0))) * np.float32(np.log(2.0))))
        x = torch.randint(-2**31, 2**31 - 1, (POW_SAMPLE,), generator=gen, device=DEV, dtype=torch.int32)
        x = x.view(torch.float32)
        got, want = mr.powf32(x, c), mr.mirror_plain(x, "pow", c)
        check(same_bits(got, want), f"26 mirror pow {p}: not bit-equal to plain")
        worst = max(worst, abs_err(got, want))
    del x, got, want
    torch.cuda.empty_cache()
    sweep = (f"sin, log, log2, exp: all 2^32 f32 bit patterns; pow at {list(POW_EXPONENTS)}: "
             f"{POW_SAMPLE} random bit patterns each")
    say("26", f"mirror kernel vs its plain version: {sweep}; bit-equal off the NaNs, NaN where plain gives NaN "
        f"({time.perf_counter() - t0:.1f} s)")

    h, w = SRC_HW
    d64 = Path(tmp) / "nnedi3-26"
    d64.mkdir(exist_ok=True)
    paths = {
        "crt-mattias": (write_standin(tmp), MATTIAS_BATCH, "pow"),
        "nnedi3": (write_chain(str(d64), 64, "rgb", height=2 * h), NNEDI3_BATCH, "exp"),
    }
    results = {}
    for name, (path, batch, want_op) in paths.items():
        frames = torch.randint(0, 256, (batch, h, w, 3), generator=gen, device=DEV, dtype=torch.uint8)
        e = Engine(viewport=VIEWPORT, device=DEV)
        check(e.load_preset(str(path)), f"26 {name}: load_preset: {e.last_error}")
        with env(RCTPU_REPLAY="0"), launched(mr, "_mirror_op") as calls:
            e.apply(frames, output="u8")
        _engine_ok(e, f"26 {name}")
        shapes = [f"{op} {list(x.shape)}" for x, op, _ in calls]
        x, op, c = max((a for a in calls if a[1] == want_op), key=lambda a: a[0].numel())
        del calls, e, frames
        torch.cuda.empty_cache()
        got, want = mr._mirror_op(x, op, c), mr.mirror_plain(x, op, c)
        torch.cuda.synchronize()
        check(same_bits(got, want), f"26 {name}: the mirror kernel's {op} {list(x.shape)} is not bit-equal to plain")
        worst = max(worst, abs_err(got, want))
        del got, want
        plain_ms, k_ms = in_turns(lambda: mr.mirror_plain(x, op, c), lambda: mr._mirror_op(x, op, c), 10, device_ms,
                                  kernel_timer=launch_timer("mirrors"), plain_iters=1)
        b_ms, b_by = mirror_bound(x, op)
        call = f"{op}{'' if op != 'pow' else f' {c:.6g}'} {list(x.shape)}"
        results[name] = {"call": call, "ms": k_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
        say("26", f"{name}: a walked apply of {batch} launches the mirror kernel as {shapes}; at its largest, {call}: "
            f"bit-equal to plain; kernel {k_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})  "
            f"({card})")
        del x
        torch.cuda.empty_cache()
    return sweep, results, worst


@contextlib.contextmanager
def plain_fma_calls():
    """Count, for the duration of a block, the calls of ``policy.fma32`` and
    ``policy.fmaf32`` with a CUDA tensor among their operands, wherever a
    module of the port holds them, but inside two kernels' plain versions,
    which keep policy's formula and run on the card only where a phase
    compares them: the xbr epilogue's plain tail (``ops/cuda/
    xbr_epilogue.py``) and ``warp_sample_plain`` (the gather's lerps). On
    the card every call site of the main paths goes through the operator
    ``rctpu::fma``, so every such call is a call site that bypasses its
    kernel. Yields the list of the calls, one entry (the function's name
    and its caller) a call."""
    import torch

    from retrocapture_tpu_torch import policy
    from retrocapture_tpu_torch.ops.cuda import warp_sample as ws

    calls = []
    originals = {n: getattr(policy, n) for n in ("fma32", "fmaf32")}

    plain_tail = "retrocapture_tpu_torch.ops.cuda.xbr_epilogue"

    def in_plain_version(frame):
        if frame.f_globals.get("__name__") == plain_tail:
            return True
        while frame is not None and frame.f_code is not ws.warp_sample_plain.__code__:
            frame = frame.f_back
        return frame is not None

    def counting(name, fn):
        def f(*args):
            caller = sys._getframe(1)
            if any(isinstance(x, torch.Tensor) and x.device.type == "cuda" for x in args) and not in_plain_version(
                    caller):
                calls.append(f"{name} from {Path(caller.f_code.co_filename).name}:{caller.f_lineno} "
                             f"{caller.f_code.co_name}")
            return fn(*args)

        return f

    patched = [(m, n, fn) for key, m in list(sys.modules.items()) if key.startswith("retrocapture_tpu_torch")
               for n, fn in originals.items() if getattr(m, n, None) is fn]
    for m, n, fn in patched:
        setattr(m, n, counting(n, fn))
    try:
        yield calls
    finally:
        for m, n, fn in patched:
            setattr(m, n, fn)


def own_bytes(t):
    """The bytes a tensor's view addresses: a broadcast (stride-0)
    dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return 4 * n


def fma_bound(args, out):
    """(bound_ms, bound_by) of ``rctpu::fma`` on its operator arguments: each
    distinct tensor operand's own bytes read once (``fma32(col, col, -col)``
    reads ``col`` once) and the output written once over the memory rate,
    or its operations: fma32 an f64 multiply and an f64 add an element over
    the f64 issue rate, fmaf32 one f32 FMA (2 operations) over the f32
    rate."""
    views = {(t.data_ptr(), tuple(t.shape), t.stride()): t for t in args[:3] if t is not None}
    t_bytes = (sum(own_bytes(t) for t in views.values()) + 4 * out.numel()) / PEAK_BYTES_S * 1e3
    t_ops = out.numel() * (2 / F64_ISSUE_S if args[6] == 0 else 2 / PEAK_F32_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def fma_call(keep):
    """Keep, of the launches of ``rctpu::fma`` in a block (the batched calls,
    as ``launched`` records them), the arguments of the one that
    ``keep(args, kept)`` prefers to the one kept so far (``kept`` None at
    first). Yields a one-element list that holds them at the end."""
    import torch

    from retrocapture_tpu_torch.ops.cuda import fma as fm

    orig = fm._fma_op
    kept = [None]

    def rec(*args):
        if not any(isinstance(a, torch.Tensor) and torch._C._functorch.is_batchedtensor(a) for a in args):
            if keep(args, kept[0]):
                kept[0] = args
        return orig(*args)

    fm._fma_op = rec
    try:
        yield kept
    finally:
        fm._fma_op = orig


def fma_graph_replay(gen, wrappers, plains, held):
    """The fma operator with 0-d operands captured into a CUDA graph and
    replayed 3 times, the 0-d buffers and the tensor operand rewritten
    between replays: each replay reads the values of its time (bit-equal to
    the plain version on them, by ``held(got, want, what)``) and makes no
    launch call."""
    import torch

    from retrocapture_tpu_torch.ops.cuda import fma as fm

    vh, vw = VIEWPORT[1], VIEWPORT[0]
    x = torch.rand((3, vh, vw), generator=gen, device=DEV)
    s, t = torch.tensor(0.8, device=DEV), torch.tensor(1.5, device=DEV)
    graph_args = ((0, (x, s, t)), (1, (t, x[..., :1], x)), (0, (x[0], 1620.0, s)))

    def run():
        return [wrappers[m](*a) for m, a in graph_args]

    run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = run()
    for k in range(3):
        s.fill_(0.1 * k - 0.3)
        t.fill_(2.0 ** -k)
        x.copy_(torch.rand(x.shape, generator=gen, device=DEV))
        before = fm.LAUNCHES
        graph.replay()
        torch.cuda.synchronize()
        check(fm.LAUNCHES == before, "27 fma: a graph replay made a launch call")
        for got, (m, a) in zip(outs, graph_args):
            held(got, plains[m](*a), f"27 fma: replay {k} with rewritten 0-d operands differs from plain")
    del graph, outs, x
    torch.cuda.empty_cache()


def phase_fma(gen, Engine, tmp, card):
    """Phase 27, the multiply-add operator ``rctpu::fma`` (csrc/fma.cu)
    against ``policy.fma32`` and ``policy.fmaf32`` on the card:

    * FMA_SAMPLE random bit-pattern triples a mode, every triple of the
      edge values (NaN, +-inf, +-0, subnormals, FLT_MAX sums that
      overflow), and the tie triple a = b = 1 + 2^-12, c = +-2^-80, where
      the modes differ for +2^-80 alone: bit-equal off the NaNs, NaN where
      the plain version gives NaN;
    * every operand form the call sites pass (a scalar in each position,
      0-d tensors, [H, W, 1] against [H, W, 3], expanded, strided and
      transposed views, an operand off a 16-byte boundary), under
      ``torch.func.vmap`` with the batch on a, b or c alone and on all
      three (one launch each), and a CUDA graph replayed with its 0-d
      operands rewritten between replays (the replay reads the new values);
    * the kernel at the main paths' own calls, recorded in walked applies:
      feedback-ghost's ``mix`` (the north star's pass) and crt-mattias's
      largest epilogue call, bit-equal to the plain version on the same
      operands and timed in turns beside it, with their bound and
      ``torch.addcmul`` on the same operands (the same bytes; not the same
      bits for fma32).

    Returns ({call: its numbers}, the largest absolute difference from
    plain over all it compared)."""
    import numpy as np
    import torch

    from _mattias_standin import write_standin
    from retrocapture_tpu_torch import policy
    from retrocapture_tpu_torch.frontend import builtins
    from retrocapture_tpu_torch.ops.cuda import fma as fm

    t0 = time.perf_counter()
    wrappers = {0: fm.fma32, 1: fm.fmaf32}
    plains = {0: policy.fma32, 1: policy.fmaf32}

    def bits(n):
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=DEV, dtype=torch.int32).view(torch.float32)

    worst = [0.0]

    def held(got, want, what):
        check(same_bits(got, want), what)
        worst[0] = max(worst[0], abs_err(got, want))

    for mode in (0, 1):
        a, b, c = bits(FMA_SAMPLE), bits(FMA_SAMPLE), bits(FMA_SAMPLE)
        held(wrappers[mode](a, b, c), plains[mode](a, b, c),
             f"27 fma mode {mode}: not bit-equal to plain on random bit patterns")
        del a, b, c
    vals = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1.0, -1.0, 3.4028235e38,
                         -3.4028235e38, 1.1754944e-38, 1e-45, -1e-45, 2.5e-39, 0.5, 3.0], device=DEV)
    edges = [t.reshape(-1) for t in torch.meshgrid(vals, vals, vals, indexing="ij")]
    tie = torch.full((2,), 1 + 2.0**-12, device=DEV)
    tie_c = torch.tensor([2.0**-80, -2.0**-80], device=DEV)
    for mode in (0, 1):
        held(wrappers[mode](*edges), plains[mode](*edges), f"27 fma mode {mode}: edges not bit-equal")
        held(wrappers[mode](tie, tie, tie_c), plains[mode](tie, tie, tie_c),
             f"27 fma mode {mode}: the tie triple is not bit-equal to plain")
    t32, tf = fm.fma32(tie, tie, tie_c).tolist(), fm.fmaf32(tie, tie, tie_c).tolist()
    check(t32 == [1 + 2.0**-11] * 2 and tf == [1 + 2.0**-11 + 2.0**-23, 1 + 2.0**-11],
          f"27 fma: the tie triple gives fma32 {t32}, fmaf32 {tf}")

    vh, vw = VIEWPORT[1], VIEWPORT[0]

    def r(*shape):
        return torch.randn(shape, generator=gen, device=DEV)

    hw3, hw1, flat = r(vh, vw, 3), r(vh, vw, 1), r(vh * vw * 3 + 1)
    forms = [
        (0.92, hw3, r(vh, vw, 3)), (hw3, 0.4, r(vh, vw, 3)), (hw3, r(vh, vw, 3), -0.25), (hw3, 12.9898, 1.0),
        (r(2)[1], hw3, 1.0), (r(vh, vw), 1620.0, torch.tensor(0.123, device=DEV)), (hw1, r(vh, vw, 3), hw3),
        (r(1, vw, 3).expand(vh, vw, 3), hw1.expand(vh, vw, 3), hw3), (r(vh, vw, 3)[..., 2], 0.299, r(vh, vw, 3)[..., 0]),
        (r(8, vh, vw), 0.5, r(8, 1, 1)), (r(vw, vh).t(), r(vh, vw), r(vh, 1)),
        (flat[1:].view(vh, vw, 3), hw3, flat[:-1].view(vh, vw, 3)),
    ]
    for k, (a, b, c) in enumerate(forms):
        for mode in (0, 1):
            got = wrappers[mode](a, b, c)
            # The kernel writes a contiguous result (a CPU run's plain version
            # may keep an operand's layout).
            check(got.is_contiguous() or got.device.type == "cpu", f"27 fma mode {mode}: form {k} not contiguous")
            held(got, plains[mode](a, b, c), f"27 fma mode {mode}: broadcast form {k} not bit-equal to plain")
    B = 8
    cases = [((r(B, 3), hw3, r(vh, vw, 3)), (0, None, None)), ((hw3, r(3, B), 0.5), (None, 1, None)),
             ((r(vh, vw), 1620.0, r(B)), (None, None, 0)), ((r(vh, B, vw, 3), r(vw, 1, B), r(B)), (1, 2, 0))]
    for operands, dims in cases:
        for mode in (0, 1):
            before = fm.LAUNCHES
            got = torch.func.vmap(wrappers[mode], in_dims=dims)(*operands)
            check(fm.LAUNCHES == before + 1, f"27 fma vmap {dims}: {fm.LAUNCHES - before} launches, want 1")
            want = torch.stack([plains[mode](*(x if d is None else x.select(d, i) for x, d in zip(operands, dims)))
                                for i in range(B)])
            held(got, want, f"27 fma mode {mode}: vmap with in_dims {dims} not bit-equal to a loop")
    del forms, cases, hw3, hw1, flat, got, want
    fma_graph_replay(gen, wrappers, plains, held)
    say("27", f"rctpu::fma vs policy.fma32 / fmaf32: {FMA_SAMPLE} random bit-pattern triples a mode, "
        f"{edges[0].numel()} edge triples, the tie triple (fma32 {t32}, fmaf32 {tf}), 12 broadcast forms, 4 vmap "
        "cases (one launch each), a CUDA graph replayed 3 times with its 0-d operands rewritten: bit-equal off the "
        f"NaNs, NaN where plain gives NaN ({time.perf_counter() - t0:.1f} s)")

    # The main paths' calls, recorded in walked applies.
    h, w = SRC_HW
    in_mix = []
    mix = builtins._mix

    def tagged_mix(*args):
        in_mix.append(True)
        try:
            return mix(*args)
        finally:
            in_mix.pop()

    def first_mix(args, kept):
        return kept is None and bool(in_mix)

    def call_bytes(a):
        out = torch.broadcast_shapes(*(x.shape for x in a[:3] if x is not None)).numel()
        return sum(own_bytes(x) for x in a[:3] if x is not None) + 4 * out

    def largest(args, kept):
        return kept is None or call_bytes(args) > call_bytes(kept)

    paths = {
        "feedback-ghost mix": (PRESET, "nv12", 2, first_mix),
        "crt-mattias epilogue": (write_standin(tmp), "rgb", MATTIAS_BATCH, largest),
    }
    results = {}
    builtins._mix = tagged_mix
    try:
        for name, (path, fmt, batch, keep) in paths.items():
            shape = (batch, h * 3 // 2, w) if fmt == "nv12" else (batch, h, w, 3)
            frames = torch.randint(0, 256, shape, generator=gen, device=DEV, dtype=torch.uint8)
            e = Engine(viewport=VIEWPORT, device=DEV)
            check(e.load_preset(str(path)), f"27 {name}: load_preset: {e.last_error}")
            e.set_input_format(fmt)
            with env(RCTPU_REPLAY="0"), fma_call(keep) as kept:
                e.apply(frames, output="u8")
            _engine_ok(e, f"27 {name}")
            check(kept[0] is not None, f"27 {name}: the walk made no such call of rctpu::fma")
            args = kept[0]
            del e, frames, kept
            torch.cuda.empty_cache()
            a, b, c, sa, sb, sc, mode = args
            operands = [sv if x is None else x for x, sv in ((a, sa), (b, sb), (c, sc))]
            got, want = fm._fma_op(*args), fm.fma_plain(*operands, mode)
            torch.cuda.synchronize()
            held(got, want, f"27 {name}: the kernel is not bit-equal to plain on the call's operands")
            b_ms, b_by = fma_bound(args, got)
            # The plain version by CUDA events around its calls: a profiler
            # window over its few large passes was seen to keep a tenth of
            # their records.
            plain_ms, k_ms = in_turns(lambda: fm.fma_plain(*operands, mode), lambda: fm._fma_op(*args), 10, event_ms,
                                      kernel_timer=launch_timer("fma"))
            ta, tb, tc = (x if isinstance(x, torch.Tensor) else torch.tensor(x, device=DEV) for x in operands)
            lib_ms = _product_ms(lambda: torch.addcmul(tc, ta, tb), 10)
            forms = ", ".join("scalar" if x is None else f"{list(x.shape)}{'' if x.is_contiguous() else ' view'}"
                              for x in (a, b, c))
            call = f"{'fma32' if mode == 0 else 'fmaf32'}({forms}) -> {list(got.shape)}"
            results[name] = {"call": call, "ms": k_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                             "library_ms": lib_ms}
            say("27", f"{name}: {call}: bit-equal to plain; kernel {k_ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), torch.addcmul {lib_ms:.4f} ms  ({card})")
            del args, a, b, c, operands, got, want, ta, tb, tc
            torch.cuda.empty_cache()
    finally:
        builtins._mix = mix
    return results, worst[0]


def phase_cli_traced():
    """python -m retrocapture_tpu_torch --param-mode traced, as a process of
    its own on the card: returns 0 with its stats."""
    cmd = [sys.executable, "-m", "retrocapture_tpu_torch", "--source", "test", "--preset",
           "assets/presets/feedback-ghost.glslp", "--viewport", f"{VIEWPORT[0]}x{VIEWPORT[1]}", "--frames",
           str(CLI_FRAMES), "--batch", "8", "--param-mode", "traced", "--param", "GHOST=0.8", "--stats"]
    proc = subprocess.run(cmd, cwd=str(REPO), capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"24: {' '.join(cmd[1:])} returned {proc.returncode}: {proc.stderr[-2000:]}")
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    check(stats.get("frames") == CLI_FRAMES, f"24: stats {stats}")
    say("24", f"python -m retrocapture_tpu_torch --param-mode traced --param GHOST=0.8 ({CLI_FRAMES} frames, 1080p): "
        f"returned 0, stats {stats}")


def phase_ntsc(gen, Engine, tmp, card):
    """ntsc-320px through the stand-ins (tests/_ntsc_standin.py): the
    composite + gamma chain, pass 0 at 1280 wide, the last pass at 640 x
    viewport height, the 640x1080 -> 1080p blit (x ratio 3); one apply of
    svideo, plain and -linear; the band products' time beside their bound.
    Returns the blit launches and the blit kernel's largest distance from
    its plain version."""
    import torch

    from _ntsc_standin import PASS1, PASS2, write_chain
    from retrocapture_tpu_torch.graph import kernels as tk

    h, _ = SRC_HW
    vw, vh = VIEWPORT
    names = list(PASS1.values()) + list(PASS2.values())
    variants = [(f"ntsc {a} + {b}", write_chain(tmp, NTSC_WIDTH, a, b))
                for a, b in (("svideo", "gamma"), ("composite", "plain"), ("composite", "linear"))]
    e, frames, launches, src = _library_slice(
        gen, Engine, "21", "ntsc-320px composite + gamma", write_chain(tmp, NTSC_WIDTH), names, NTSC_BATCH, 2, variants)
    check(src == (NTSC_BATCH, vh, NTSC_WIDTH // 2, 3), f"ntsc: blit from {src}")
    kd = check_blit(knife_tex(gen, (VARIANT_BATCH, vh, NTSC_WIDTH // 2, 3), DEV), vh, vw, "21")
    _slice_rate("21", "ntsc-320px", e, frames, card)
    _host_profile("21", "ntsc-320px", e, frames)
    # The band product of one frame, as the entry runs it (the FIR at the
    # source rows, three channels of the [h, 1280, 4] pass-0 output).
    w, ow = NTSC_WIDTH, NTSC_WIDTH // 2
    ml = torch.from_numpy(tk._ntsc_band_matrix(tk._NTSC2_LUMA, w, ow)).to(DEV)
    mc = torch.from_numpy(tk._ntsc_band_matrix(tk._NTSC2_CHROMA, w, ow)).to(DEV)
    tex = torch.rand((h, w, 4), generator=gen, device=DEV)
    ms = _product_ms(lambda: (tex[..., 0] @ ml, tex[..., 1] @ mc, tex[..., 2] @ mc))
    # Counted as the reference's band work: 2 h w ow per channel; bytes:
    # three input planes, two matrices, three output planes.
    b_ms, b_by = bound(4 * (3 * h * w + 2 * w * ow + 3 * h * ow), 3 * 2 * h * w * ow)
    say("21", f"ntsc band product, one frame ([{h},{w}] @ [{w},{ow}] x 3 channels, TF32 off): {ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); {NTSC_BATCH} such products an apply  ({card})")
    return launches, kd, (ms, b_ms, b_by)


def phase_nnedi3(gen, Engine, tmp, card):
    """nnedi3 through the stand-ins (tests/_nnedi3_standin.py): the nns64
    -rgb chain 240x320 -> 480x320 -> 480x640 and the 480x640 -> 1080p
    blit; one apply of the nns16 -luma chain; the two contractions' time
    beside their bound. Returns as phase_ntsc."""
    import torch

    from _nnedi3_standin import NAMES, write_chain

    h, w = SRC_HW
    vw, vh = VIEWPORT
    d64, d16 = Path(tmp) / "nnedi3-64", Path(tmp) / "nnedi3-16"
    d64.mkdir(exist_ok=True)
    d16.mkdir(exist_ok=True)
    variants = [("nnedi3 nns16 -luma", write_chain(str(d16), 16, "luma", height=2 * h))]
    e, frames, launches, src = _library_slice(
        gen, Engine, "22", "nnedi3 nns64 -rgb", write_chain(str(d64), 64, "rgb", height=2 * h), NAMES, NNEDI3_BATCH, 2,
        variants)
    check(src == (NNEDI3_BATCH, 2 * h, 2 * w, 3), f"nnedi3: blit from {src}")
    kd = check_blit(knife_tex(gen, (VARIANT_BATCH, 2 * h, 2 * w, 3), DEV), vh, vw, "22")
    _slice_rate("22", "nnedi3 nns64 -rgb", e, frames, card)
    _host_profile("22", "nnedi3 nns64 -rgb", e, frames)
    # The entry's contraction as it runs it: [2 nns, 32] @ [32, h w c] in
    # f64 per pass, one frame; its bound at f64 bytes and the f64 matmul
    # rate.
    out = []
    for label, n in (("pass1", h * w * 3), ("pass2", 2 * h * w * 3)):
        wt = torch.randn((128, 32), generator=gen, device=DEV).double()
        taps = torch.rand((32, n), generator=gen, device=DEV).double()
        ms = _product_ms(lambda: wt @ taps)
        t_bytes = 8 * (32 * n + 128 * 32 + 128 * n) / PEAK_BYTES_S * 1e3
        t_ops = 2 * 128 * 32 * n / PEAK_F64_MATMUL_S * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        out.append((ms, b_ms, b_by))
        say("22", f"nnedi3 nns64 contraction, one frame's {label} ([128,32] @ [32,{n}] in f64): {ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})  ({card})")
    return launches, kd, out


def main() -> int:
    if not (REPO / "retrocapture_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke: retrocapture_tpu_torch is not beside this script")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU")
    # No op of a batched walk may take vmap's per-example fallback (a loop
    # over the frames): every such warning of the run is kept, and any
    # fails the run at its end.
    fallbacks = set()
    show = warnings.showwarning

    def keep_fallbacks(message, category, *args, **kwargs):
        if "batching rule" in str(message):
            fallbacks.add(str(message).split(".")[0])
        else:
            show(message, category, *args, **kwargs)

    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    warnings.filterwarnings("always", message=".*batching rule.*")
    warnings.showwarning = keep_fallbacks
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))  # the stand-in shaders the CPU tests drive too

    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = smi.strip()
    say("1", f"card: {card}")
    global F64_ISSUE_S
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    F64_ISSUE_S = F64_PER_CLOCK_SM * sms * clock_mhz * 1e6
    say("1", f"{sms} SMs at most {clock_mhz:.0f} MHz: elementwise f64 issues {F64_ISSUE_S / 1e12:.2f}e12 operations/s")
    say("1", f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    from retrocapture_tpu_torch import Engine
    from retrocapture_tpu_torch.ops.cuda import _build
    from retrocapture_tpu_torch.ops.cuda import fma as fm
    from retrocapture_tpu_torch.ops.cuda import mirrors as mr
    from retrocapture_tpu_torch.ops.cuda import resample as rs
    from retrocapture_tpu_torch.ops.cuda import warp_sample as ws
    from retrocapture_tpu_torch.ops.cuda import xbr_epilogue as xe  # bound to policy's functions before phase 5

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

    # Phases 5-6: the main path, counted from zero. From here to phase 25
    # every mirror and every multiply-add on the card goes through its
    # kernel: a call of a plain version on a CUDA tensor is a call site that
    # bypasses it.
    mirror_bypass = contextlib.ExitStack()
    bypass = mirror_bypass.enter_context(plain_mirror_calls())
    fma_bypass = mirror_bypass.enter_context(plain_fma_calls())
    rs.LAUNCHES = 0
    ws.LAUNCHES = 0
    fm.LAUNCHES = 0
    rs.general_blocks(reset=True)
    ws.general_launches(reset=True)
    eng, nv12 = phase_slice(gen, Engine)
    slice_launches = rs.LAUNCHES
    with tempfile.TemporaryDirectory() as td:
        weng, wframes = phase_warp_pass(gen, Engine, Path(td))
        launches = {"resample_u8": rs.LAUNCHES, "warp_sample": ws.LAUNCHES, "fma": fm.LAUNCHES}
        check(launches["fma"] > 0, "5-6: the main paths did not launch the fma kernel")
        rs_general = rs.general_blocks(reset=True)
        ws_general = ws.general_launches(reset=True)
        check(slice_launches > 0 and launches["warp_sample"] > 0, f"main-path launches {launches}")
        check(rs_general == 0, f"main paths: {rs_general} resample_u8 units of work took the general path")
        check(ws_general == 0, f"main paths: {ws_general} warp_sample launches took the general path")
        say("5-6", f"main-path launches: {launches}; resample_u8 general-path units {rs_general}; warp_sample "
            f"general-path launches {ws_general}")

        # Phase 7: timings, in turns, at the slice's shapes.
        h, w = SRC_HW
        tex = knife_tex(gen, (SLICE_BATCH, h, w, 3), DEV)
        ay, ax = rs.blit_matrices(h, w, VIEWPORT[0], VIEWPORT[1])
        ay_t, ax_t = torch.from_numpy(ay).to(DEV), torch.from_numpy(ax).to(DEV)
        rs_fns = (lambda: rs.resample_u8_plain(tex, ay_t, ax_t), lambda: rs.resample_u8(tex, ay, ax))
        rs_plain, rs_ms = in_turns(*rs_fns, 10, device_ms, kernel_timer=launch_timer("resample_u8"))
        rs_plain_ev, rs_ev = in_turns(*rs_fns, 10, event_ms)
        say("7", f"resample_u8 [{SLICE_BATCH},{h},{w},3] -> [{SLICE_BATCH},{VIEWPORT[1]},{VIEWPORT[0]},3]: device time kernel "
            f"{rs_ms:.3f} ms, plain {rs_plain:.3f} ms; per call (CUDA events, wrapper's host work included) "
            f"kernel {rs_ev:.3f} ms, plain {rs_plain_ev:.3f} ms  ({card})")
        vw, vh = VIEWPORT
        ftex = knife_tex(gen, (SLICE_BATCH, vh, vw, 3), DEV)
        fay, fax = rs.blit_matrices(vh, vw, vw, vh)
        fay_t, fax_t = (None if a is None else torch.from_numpy(a).to(DEV) for a in (fay, fax))
        fg_plain, fg_ms = in_turns(
            lambda: rs.resample_u8_plain(ftex, fay_t, fax_t), lambda: rs.resample_u8(ftex, fay, fax),
            10, device_ms, kernel_timer=launch_timer("resample_u8"), plain_iters=2,
        )
        fg_bound = blit_bound(ftex, vh, vw)
        say("7", f"resample_u8 [{SLICE_BATCH},{vh},{vw},3] -> same (feedback-ghost's own blit): device time "
            f"kernel {fg_ms:.3f} ms, plain {fg_plain:.3f} ms, bound {fg_bound[0]:.3f} ms ({fg_bound[1]})  ({card})")
        del ftex
        sh, sw = SNES_HW
        stex = knife_tex(gen, (SLICE_BATCH, sh, sw, 3), DEV)
        s_ay, s_ax = rs.blit_matrices(sh, sw, vw, vh)
        s_ay_t, s_ax_t = torch.from_numpy(s_ay).to(DEV), torch.from_numpy(s_ax).to(DEV)
        sn_plain, sn_ms = in_turns(
            lambda: rs.resample_u8_plain(stex, s_ay_t, s_ax_t), lambda: rs.resample_u8(stex, s_ay, s_ax),
            10, device_ms, kernel_timer=launch_timer("resample_u8"), plain_iters=2,
        )
        sn_bound = blit_bound(stex, vh, vw)
        say("7", f"resample_u8 [{SLICE_BATCH},{sh},{sw},3] -> [{SLICE_BATCH},{vh},{vw},3] (x ratio 7.5): device time "
            f"kernel {sn_ms:.3f} ms, plain {sn_plain:.3f} ms, bound {sn_bound[0]:.3f} ms ({sn_bound[1]})  ({card})")
        del stex
        # The whole call: blit_u8 keeps a geometry's matrices and device
        # tables, resample_u8 reads the caller's matrices anew.
        rs.clear_blit_cache()
        blit_ev = (event_ms(lambda: rs.blit_u8(tex, vw, vh), 10) + event_ms(lambda: rs.blit_u8(tex, vw, vh), 10)) / 2
        check(bool(torch.equal(rs.blit_u8(tex, vw, vh), rs.resample_u8(tex, ay, ax))),
              "blit_u8 through its cache differs from resample_u8 with the same matrices")
        say("7", f"blit_u8 [{SLICE_BATCH},{h},{w},3] -> 1080p per call (CUDA events, tables from the blit cache): "
            f"{blit_ev:.3f} ms; resample_u8 with the caller's matrices {rs_ev:.3f} ms  ({card})")
        wu0, wv0 = curvature_uv(VIEWPORT[1], VIEWPORT[0], DEV)
        ws_fns = (
            lambda: ws.warp_sample_plain(wtex, wu0, wv0, filter_linear=True, wrap_mode="clamp_to_border"),
            lambda: ws.warp_sample(wtex, wu0, wv0, filter_linear=True, wrap_mode="clamp_to_border"),
        )
        ws_plain, ws_ms = in_turns(*ws_fns, 100, device_ms, kernel_timer=launch_timer("warp_sample"))
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

        # Phases 8-9: the new kernels against their plain versions.
        from retrocapture_tpu_torch.ops.cuda import blur_groups as bg

        xp_err = phase_xphase(gen)
        blur_err, (btex, bu, bv, bgroups) = phase_blur(gen)

        # Phases 10-11: the crt-mattias path and the xphase path, each
        # counted from zero.
        # Phases 10, 12, 14 and 15 walk uncaptured, as in the slices that
        # brought them up: they count the launches of each walk, one of the
        # batch (phase 23 replays both paths by graph and counts the graph's
        # launches on the device).
        with env(RCTPU_REPLAY="0"):
            meng, mframes, mlaunches = phase_mattias(gen, Engine, Path(td))
        launches.update(mlaunches)
        # The preconv option's warp launches are single-channel (the general
        # path); the main paths' count starts again here.
        preconv_general = ws.general_launches(reset=True)
        launches["resample_xphase"] = phase_xphase_slice(gen, Engine, Path(td))
        say("10-11", f"main-path launches: {launches}")

        # Phase 12: timings of the new kernels, in turns, at the main
        # paths' shapes, and the crt-mattias slice's rate.
        xtex = knife_tex(gen, (SLICE_BATCH, h, w, 3), DEV)
        xplan = rs._xphase_plan(ax, w, VIEWPORT[0])
        ytaps = tuple(torch.from_numpy(t).to(DEV) for t in rs.axis_taps(ay))
        xp_plain, xp_ms = in_turns(
            lambda: rs.resample_u8_xphase_plain(xtex, ytaps, xplan), lambda: rs.resample_u8_xphase(xtex, ay, xplan),
            10, device_ms, kernel_timer=launch_timer("resample_xphase"),
        )
        say("12", f"resample_u8_xphase [{SLICE_BATCH},{h},{w},3] -> [{SLICE_BATCH},{VIEWPORT[1]},{VIEWPORT[0]},3]: "
            f"device time kernel {xp_ms:.3f} ms, plain {xp_plain:.3f} ms; the resample_u8 kernel on the same "
            f"shape {rs_ms:.3f} ms (phase 7)  ({card})")
        # blur_groups on one frame and at batch 32 in one launch (as the
        # engine's batched walk calls it).
        btex1 = btex[:1]
        blur_ms, blur32_ms = {}, {}
        blur32_shape = list(btex.shape)
        blur32_bound = bound(nbytes(btex, bu, bv) + 3 * btex.shape[0] * nbytes(bu), 2 * 25 * len(bgroups) * btex.shape[0] * bu.numel())
        for mode in ("v2", "v1"):
            tables = bg.weight_tables(bgroups, mode)
            with env(RCTPU_BLUR=mode):
                plain_ms, k_ms = in_turns(
                    lambda: bg.blur5x5_groups_plain(btex1, bu, bv, bgroups, tables),
                    lambda: bg.blur5x5_groups(btex1, bu, bv, bgroups),
                    100, device_ms, kernel_timer=launch_timer("blur_groups"), plain_iters=4,
                )
                plain32_ms, k32_ms = in_turns(
                    lambda: bg.blur5x5_groups_plain(btex, bu, bv, bgroups, tables),
                    lambda: bg.blur5x5_groups(btex, bu, bv, bgroups),
                    20, device_ms, kernel_timer=launch_timer("blur_groups"), plain_iters=2,
                )
            blur_ms[mode], blur32_ms[mode] = (k_ms, plain_ms), (k32_ms, plain32_ms)
            say("12", f"blur5x5_groups {mode} [1,{h},{w},3] -> [1,{VIEWPORT[1]},{VIEWPORT[0]}] x 3 channels (one "
                f"frame): device time kernel {k_ms:.4f} ms, plain {plain_ms:.3f} ms; [{MATTIAS_BATCH},{h},{w},3] in "
                f"one launch (as the batched walk calls it): kernel {k32_ms:.3f} ms ({k32_ms / MATTIAS_BATCH:.4f} a "
                f"frame), plain {plain32_ms:.3f} ms  ({card})")
        with env(RCTPU_REPLAY="0"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                meng.apply(mframes, output="u8")
            torch.cuda.synchronize()
            mdt = (time.perf_counter() - t0) / 2
            mdev = device_ms(lambda: meng.apply(mframes, output="u8"), 1)
        say("12", f"crt-mattias slice, walked: {MATTIAS_BATCH / mdt:.1f} frames/s at batch {MATTIAS_BATCH} "
            f"({mdt * 1e3:.1f} ms per apply; device busy {mdev:.1f} ms of it, idle "
            f"{100.0 * (1.0 - mdev / (mdt * 1e3)):.1f}%)  ({card})")

        # Phases 13-14: the xbr epilogue kernel against its plain version,
        # and the xbr-lv2 path, counted from zero.
        from _xbr_standin import write_standin as write_xbr_standin

        xpath = write_xbr_standin(td)
        xb_err, (xS, xmaps) = phase_xbr_kernel(gen, Engine, xpath)
        with env(RCTPU_REPLAY="0"):
            xeng, xframes, launches["xbr_epilogue"] = phase_xbr_slice(gen, Engine, xpath)
        say("13-14", f"main-path launches: {launches}")

        # Phase 15: the xbr kernel against the plain tail, in turns, at the
        # main path's shape; the xbr slice's rate; the library calls.
        xargs = _xbr_plain_args(xS, xmaps)
        xb_plain, xb_ms = in_turns(
            lambda: xe.xbr_epilogue_plain(*xargs), lambda: xe.xbr_epilogue(xS, xmaps),
            50, device_ms, kernel_timer=launch_timer("xbr_epilogue"), plain_iters=5,
        )
        say("15", f"xbr_epilogue S {tuple(xS.shape)} -> [1,{VIEWPORT[1]},{VIEWPORT[0]},4]: device time kernel "
            f"{xb_ms:.4f} ms, plain tail {xb_plain:.3f} ms  ({card})")
        with env(RCTPU_REPLAY="0"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                xeng.apply(xframes, output="u8")
            torch.cuda.synchronize()
            xdt = (time.perf_counter() - t0) / 2
            xdev = device_ms(lambda: xeng.apply(xframes, output="u8"), 1)
            say("15", f"xbr-lv2 slice, walked: {XBR_BATCH / xdt:.1f} frames/s at batch {XBR_BATCH} "
                f"({xdt * 1e3:.1f} ms per apply; device busy {xdev:.1f} ms of it, idle "
                f"{100.0 * (1.0 - xdev / (xdt * 1e3)):.1f}%)  ({card})")
            _host_profile("15", "xbr-lv2 walked", xeng, xframes)
        import torch.nn.functional as F

        # One PyTorch call computing the kernel's function on the same
        # inputs (the u8 pack of the blits aside), timed only here.
        x_nchw = tex.permute(0, 3, 1, 2).contiguous()
        w_nchw = wtex.permute(2, 0, 1)[None].contiguous()
        wgrid = torch.stack([wu0 * 2.0 - 1.0, wv0 * 2.0 - 1.0], dim=-1)[None]
        lib_calls = {
            "interpolate": (lambda: F.interpolate(x_nchw, size=(vh, vw), mode="bilinear", align_corners=False), 5),
            "grid_sample": (lambda: F.grid_sample(
                w_nchw, wgrid, mode="bilinear", padding_mode="zeros", align_corners=False), 100),
        }
        lib = {}
        for name, (fn, iters) in lib_calls.items():
            fn()
            lib[name] = (event_ms(fn, iters) + event_ms(fn, iters)) / 2
        say("15", f"library calls: F.interpolate bilinear [{SLICE_BATCH},3,{h},{w}] -> {vh}x{vw} f32 "
            f"{lib['interpolate']:.3f} ms; F.grid_sample bilinear zeros [1,4,{h},{w}] @ {vh}x{vw} "
            f"{lib['grid_sample']:.4f} ms  ({card})")
        del x_nchw

        # Phases 16-20: the program's front door. The counts of the two
        # kernels on these paths are read after each phase's main runs.
        os.chdir(REPO)  # the cli phase names its preset relative to the checkout
        mr.LAUNCHES = 0
        phase_stream(Engine, card)
        phase_streams(gen, Engine, card)
        u8_launches = phase_apply_u8(gen, Engine)
        with env(RCTPU_REPLAY="0"):  # it records each launch's inputs: a walk's launches
            (mip_rs, mip_ws), mip_rs_err = phase_mip(gen, Engine, Path(td))
        rs_err = max(rs_err, mip_rs_err)
        phase_cli(td)
        launches["resample_u8"] += u8_launches + mip_rs
        launches["warp_sample"] += mip_ws
        launches["mirrors"] += mr.LAUNCHES
        check(mr.LAUNCHES > 0, "16-20: mip-warp's level of detail did not launch the mirror kernel")
        say("16-20", f"main-path launches: {launches}")

        # Phases 21-22: the ntsc 2-phase and nnedi3 entries of the kernel
        # library, each path's blit launches counted from zero. They count
        # the entries' calls, a pass's one a walk of the batch (ntsc-320px
        # walks its batch in two FrameCount groups): they walk uncaptured
        # (phase 23 replays the ntsc path).
        mr.LAUNCHES = 0
        with env(RCTPU_REPLAY="0"):
            ntsc_rs, ntsc_kd, ntsc_band = phase_ntsc(gen, Engine, td, card)
            ntsc_mr = mr.LAUNCHES
            nn_rs, nn_kd, nn_prod = phase_nnedi3(gen, Engine, td, card)
        check(ntsc_mr > 0 and mr.LAUNCHES > ntsc_mr, f"21-22: mirror kernel launches ntsc {ntsc_mr}, nnedi3 "
              f"{mr.LAUNCHES - ntsc_mr}")
        launches["mirrors"] += mr.LAUNCHES
        launches["resample_u8"] += ntsc_rs + nn_rs
        rs_err = max(rs_err, ntsc_kd, nn_kd)
        say("21-22", f"main-path launches: {launches}")
        # The blit kernel at the two new geometries, and the library call
        # at every timed blit shape (F.interpolate, f32 out, no u8 pack).
        blit_shapes = {
            "ntsc": (NTSC_BATCH, vh, NTSC_WIDTH // 2), "nnedi3": (NNEDI3_BATCH, 2 * h, 2 * w),
            "1080p": (SLICE_BATCH, vh, vw), "snes": (SLICE_BATCH,) + SNES_HW,
        }
        new_blits = {}
        for name, (b, bh, bw) in blit_shapes.items():
            btex = knife_tex(gen, (b, bh, bw, 3), DEV)
            lib_ms = _product_ms(lambda: F.interpolate(btex.permute(0, 3, 1, 2), size=(vh, vw), mode="bilinear",
                                                       align_corners=False), 3)
            if name in ("ntsc", "nnedi3"):
                bay, bax = rs.blit_matrices(bh, bw, vw, vh)
                k_ms = launch_ms("resample_u8", lambda: rs.resample_u8(btex, bay, bax), 10)
                new_blits[name] = (k_ms, blit_bound(btex, vh, vw), lib_ms)
                say("21-22", f"resample_u8 [{b},{bh},{bw},3] -> [{b},{vh},{vw},3] ({name}'s blit): kernel {k_ms:.3f} ms, "
                    f"bound {new_blits[name][1][0]:.4f} ms, F.interpolate {lib_ms:.3f} ms  ({card})")
            else:
                new_blits[name] = (None, None, lib_ms)
                say("21-22", f"F.interpolate bilinear [{b},3,{bh},{bw}] -> {vh}x{vw} f32: {lib_ms:.3f} ms  ({card})")
            del btex

        # Phases 23-24: the slice's paths replayed by CUDA graph against the
        # uncaptured walk, every count from zero; the CLI in traced mode.
        rp_launches, in_graph = phase_replay(gen, Engine, Path(td), card)
        for k, n in rp_launches.items():
            launches[k] += n
        check(rp_launches["resample_u8"] > 0, f"23: the blit was not launched on the replayed paths ({rp_launches})")
        for k in ("warp_sample", "blur_groups_v2", "xbr_epilogue", "mirrors", "fma"):
            check(in_graph[k] > 0, f"23: {k} ran in no graph on the replayed paths ({in_graph})")
        say("23", f"launch calls on the replayed paths: {rp_launches}; kernel runs inside the graphs of one "
            f"replayed apply a path: {in_graph}")
        phase_cli_traced()

        # Phase 25: the batched branch of the stateless chains.
        batched = phase_batched(gen, Engine, Path(td), card)
        ws_general += ws.general_launches(reset=True)
        check(ws_general == 0, f"main paths: {ws_general} warp_sample launches took the general path")
        mirror_bypass.close()
        check(not bypass, f"a plain mirror ran on the card {len(bypass)} times ({sorted(set(bypass))}): a call site "
              "bypasses the mirror kernel")
        check(not fma_bypass, f"a plain fma ran on the card {len(fma_bypass)} times "
              f"({ {c: fma_bypass.count(c) for c in sorted(set(fma_bypass))} }): a call site bypasses the fma kernel")
        say("5-25", f"main paths: warp_sample general-path launches {ws_general} (the preconv option's single-channel "
            f"textures: {preconv_general}); plain mirror calls on the card {len(bypass)}; plain fma32/fmaf32 calls "
            f"on the card {len(fma_bypass)}")

        # Phase 26: the numerics mirrors' kernel against its plain version.
        mirror_sweep, mirror_calls, mirror_err = phase_mirrors(gen, Engine, Path(td), card)

        # Phase 27: the multiply-add operator against its plain versions.
        fma_calls, fma_err = phase_fma(gen, Engine, Path(td), card)

    # Each kernel's bound at its timed shape: inputs read once, outputs
    # written once; f32 operations counted per output value or pixel.
    vw, vh = VIEWPORT
    h, w = SRC_HW
    px = vh * vw
    bounds = {
        "resample_u8": blit_bound(tex, vh, vw),
        "resample_xphase": blit_bound(tex, vh, vw),
        "warp_sample": bound(nbytes(wtex, wu0, wv0) + px * 4 * 4, 40 * px),  # coords + 4 taps x 4 channels
        # One frame, and the batch of 32 in one launch.
        "blur_groups": bound(nbytes(btex1, bu, bv) + 3 * px * 4, 2 * 25 * len(bgroups) * px),
        "blur_groups_32": blur32_bound,
        # 253 f32 operations per pixel: 15 colour scales, 4 corners x 35
        # (4 ramps of 7, 4 flag products, 3 max), 72 for the mixes, 17 for
        # c_df and the select, 9 for the last mix.
        "xbr_epilogue": bound(nbytes(xS, xmaps.bx, xmaps.fpx, xmaps.fpy) + 4 * 65 + px * 16, 253 * px),
    }

    bounds["mirrors"] = (mirror_calls["crt-mattias"]["bound_ms"], mirror_calls["crt-mattias"]["bound_by"])

    bounds["fma"] = (fma_calls["crt-mattias epilogue"]["bound_ms"], fma_calls["crt-mattias epilogue"]["bound_by"])

    def entry(name, source, replaces, launched, err, ms, plain, bound_of, library):
        b_ms, b_by = bounds[bound_of]
        return {
            "name": name, "route": "cuda", "source": f"retrocapture_tpu_torch/csrc/{source}",
            "replaces": f"retrocapture_tpu/ops/pallas/{replaces}" if ".py:" in replaces else replaces,
            "launches": launched, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library if library is None or isinstance(library, float) else lib[library],
            # The kernel's executions inside the CUDA graphs of one replayed
            # apply of each phase-23 path (torch.profiler), which "launches"
            # (the wrapper's launch calls) does not count.
            "graph_runs": in_graph.get(name, 0), "in_graph": in_graph.get(name, 0) > 0,
        }

    # library_ms: F.interpolate (bilinear, align_corners=False) computes the
    # blits' resample without the u8 pack, F.grid_sample (bilinear, zeros)
    # the warped LINEAR clamp_to_border tap. None for blur_groups (225
    # warped NEAREST taps with per-group weights: no single call) and
    # xbr_epilogue (the xbr blend: no library operator).
    kernels = [
        entry("resample_u8", "resample_u8.cu", "resample.py:290", launches["resample_u8"], rs_err, rs_ms, rs_plain,
              "resample_u8", "interpolate"),
        entry("warp_sample", "warp_sample.cu", "warp_sample.py:204", launches["warp_sample"], ws_err, ws_ms, ws_plain,
              "warp_sample", "grid_sample"),
        entry("resample_xphase", "resample_xphase.cu", "resample.py:220", launches["resample_xphase"], xp_err, xp_ms,
              xp_plain, "resample_xphase", "interpolate"),
    ]
    for mode, line in (("v2", 515), ("v1", 221)):
        kernels.append(entry(f"blur_groups_{mode}", "blur_groups.cu", f"blur_groups.py:{line}",
                             launches[f"blur_groups_{mode}"], blur_err[mode], *blur_ms[mode], "blur_groups", None))
    kernels.append(entry("xbr_epilogue", "xbr_epilogue.cu", "xbr_epilogue.py:58", launches["xbr_epilogue"], xb_err,
                         xb_ms, xb_plain, "xbr_epilogue", None))
    # The port's own kernel: crt-mattias's output-gamma pow, nnedi3's exp
    # beside it, both at the call a walked apply makes; library_ms None (no
    # torch call computes these bits).
    mm = mirror_calls["crt-mattias"]
    kernels.append(entry("mirrors", "mirrors.cu", MIRRORS_REPLACE, launches["mirrors"], mirror_err, mm["ms"],
                         mm["plain_ms"], "mirrors", None))
    kernels[-1]["call"] = mm["call"]
    kernels[-1]["other_shapes"] = [
        {k: mirror_calls["nnedi3"][k] for k in ("call", "ms", "plain_ms", "bound_ms", "bound_by")}]
    kernels[-1]["sweep"] = mirror_sweep
    # The multiply-add operator at crt-mattias's largest epilogue call,
    # feedback-ghost's mix beside it; library_ms torch.addcmul on the same
    # operands (the same bytes, not fma32's bits).
    fc = fma_calls["crt-mattias epilogue"]
    kernels.append(entry("fma", "fma.cu", FMA_REPLACE, launches["fma"], fma_err, fc["ms"], fc["plain_ms"], "fma",
                         fc["library_ms"]))
    kernels[-1]["call"] = fc["call"]
    kernels[-1]["other_shapes"] = [
        {k: fma_calls["feedback-ghost mix"][k] for k in ("call", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}]
    # Beside the keys every entry has: the blit at its other two timed
    # shapes, and the general-path counts of the main paths (checked 0).
    kernels[0]["other_shapes"] = [
        {"shape": f"[{SLICE_BATCH},{vh},{vw},3] -> same", "ms": fg_ms, "plain_ms": fg_plain, "bound_ms": fg_bound[0],
         "library_ms": new_blits["1080p"][2]},
        {"shape": f"[{SLICE_BATCH},{SNES_HW[0]},{SNES_HW[1]},3] -> [{SLICE_BATCH},{vh},{vw},3]", "ms": sn_ms,
         "plain_ms": sn_plain, "bound_ms": sn_bound[0], "library_ms": new_blits["snes"][2]},
    ] + [
        {"shape": f"[{b},{bh},{bw},3] -> [{b},{vh},{vw},3] ({name})", "ms": new_blits[name][0],
         "bound_ms": new_blits[name][1][0], "library_ms": new_blits[name][2]}
        for name, (b, bh, bw) in blit_shapes.items() if name in ("ntsc", "nnedi3")
    ]
    # The library-call sections of the two new families (no kernel of
    # their own: torch.matmul with TF32 off), one frame each.
    kernels[0]["library_sections"] = [
        {"name": "ntsc band product", "ms": ntsc_band[0], "bound_ms": ntsc_band[1], "bound_by": ntsc_band[2],
         "per_apply": NTSC_BATCH},
        {"name": "nnedi3 contraction pass1", "ms": nn_prod[0][0], "bound_ms": nn_prod[0][1], "bound_by": nn_prod[0][2],
         "per_apply": NNEDI3_BATCH},
        {"name": "nnedi3 contraction pass2", "ms": nn_prod[1][0], "bound_ms": nn_prod[1][1], "bound_by": nn_prod[1][2],
         "per_apply": NNEDI3_BATCH},
    ]
    kernels[0]["general_path_units"] = rs_general
    # The three kernels that the stateless paths launch once a batch: their
    # numbers at the batched launch the main path makes (phase 25; blur v1,
    # RCTPU_BLUR=v1 only, at batch 32 from phase 12), the one-frame launch
    # of earlier slices beside them.
    for k in kernels:
        if k["name"] in batched or k["name"] == "blur_groups_v1":
            k["single_frame"] = {f: k[f] for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
            if k["name"] in batched:
                b = batched[k["name"]]
                k.update({f: b[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
                k["max_abs_err"] = max(k["max_abs_err"], b["max_abs_err"])
                k["batched_launch_shape"] = b["shape"]
            else:
                k["ms"], k["plain_ms"] = blur32_ms["v1"]
                k["bound_ms"], k["bound_by"] = bounds["blur_groups_32"]
                k["batched_launch_shape"] = blur32_shape
    check(not fallbacks, f"vmap took its per-example fallback for: {sorted(fallbacks)}")
    xbr = next(k for k in kernels if k["name"] == "xbr_epilogue")
    xbr["general_path_blocks"] = xe.general_blocks()
    check(xbr["general_path_blocks"] == 0, "xbr_epilogue: blocks took the general path at the main shape")
    kernels[1]["general_path_launches"] = ws_general
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
