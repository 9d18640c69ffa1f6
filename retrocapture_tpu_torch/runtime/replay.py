"""Build once per key, replay by CUDA graph: the counterpart of the
reference's ``Engine._get_jit`` cache (retrocapture_tpu/runtime/engine.py).

The reference traces a preset's chain once per key and runs the compiled
program for every later batch. The port evaluates the chain in Python, so
it keeps, per key, a ``ChainProgram``:

* its ``WalkProgram`` (policy.py): the host->device uploads of the first
  walk, taken back by every later walk, and the tables and device
  constants the walk derives from the key alone;
* on a CUDA device, one frame's chain captured as a ``torch.cuda.CUDAGraph``
  over buffers at fixed addresses: the frame (copied in, device to device),
  FrameCount and Time, the engine's parameter buffers (traced mode), the
  history ring and the PassFeedback textures, and the frame's output. A
  temporal chain's graph ends by rotating the ring and storing the feedback
  into those buffers, and by advancing FrameCount and Time; a stateless
  chain's graph is replayed once per frame with FrameCount ``fc + i``.

The walk that is captured makes no host decision from device values and
no upload (``policy.upload`` takes every host value from the program and
raises while the stream captures). A capture that meets either fails, and
the failure is raised, not hidden. The viewport blit stays outside the
graph and runs once per batch on the whole batch.

Without a graph (on the CPU, and under ``RCTPU_REPLAY=0`` on a card) the
same path runs the frame's chain again at every frame over the same fixed
buffers: the uncaptured run that the graph is held to is this code.

The kernel wrappers count their launches in Python (``LAUNCHES``): a walked
frame and a capture add to them, a graph's replay does not (its kernels
run without Python).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from retrocapture_tpu_torch.policy import WalkProgram, walking

__all__ = ["ChainProgram", "ReplayError", "run_captured", "new_stats"]

_DT = np.float32(0.016)  # Time advance per frame

class ReplayError(RuntimeError):
    """A chain that could not be captured into a CUDA graph."""


def new_stats() -> dict:
    """The counts ``Engine.replay_stats`` reports."""
    return {"graphs_captured": 0, "replays": 0, "uncaptured_applies": 0, "capture_seconds": 0.0}


@dataclass
class _Captured:
    """A captured frame: the graph and the buffers it reads and writes."""

    graph: Any  # a torch.cuda.CUDAGraph, or _Eager
    src: torch.Tensor  # [h, w, 4] the frame
    state: Any  # the engine's _ChainState over the buffers below
    out: torch.Tensor  # [oh, ow, 3] the frame's output


class _Eager:
    """The frame's chain run again at every replay, over the same fixed
    buffers: the replay path without a graph."""

    def __init__(self, body):
        self.replay = body


@dataclass
class ChainProgram:
    """What one key keeps: the walk's program and its captured frame, a
    CUDA graph (``captured[True]``) or the same buffers run without one
    (``captured[False]``)."""

    walk: WalkProgram = field(default_factory=WalkProgram)
    captured: dict = field(default_factory=dict)
    stream: Optional[Any] = None  # the side stream of the first walk and the capture

    def release(self) -> None:
        self.captured = {}
        self.walk = WalkProgram()


def _copy_state_into(dst, src) -> None:
    """Copy chain state ``src`` into the fixed buffers of ``dst``."""
    for d, s in zip(dst.history, src.history):
        d.copy_(s)
    for j, d in dst.feedback.items():
        d.copy_(src.feedback[j])
    dst.frame_count.copy_(src.frame_count)
    dst.time.copy_(src.time)


def _capture(prog: ChainProgram, walk_fn, state, src0, out_shape, temporal: bool, make_state, graph: bool,
             warm: bool) -> _Captured:
    """Capture one frame's walk over fixed buffers initialised from
    ``state`` (whose values they take). ``warm``: the program's first walk
    ran on the capture's stream just before."""
    dev = src0.device
    src = torch.empty_like(src0)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    hist = tuple(torch.empty_like(h) for h in state.history)
    fb = {j: torch.empty_like(t) for j, t in state.feedback.items()}
    fc = torch.empty_like(state.frame_count)
    tm = torch.empty_like(state.time)
    st = make_state(hist, fb, fc, tm)
    _copy_state_into(st, state)

    def body():
        with walking(prog.walk):
            o, new_hist, new_fb = walk_fn(src, hist, fb, fc, tm)
        out.copy_(o)
        if temporal:
            # Ring rotation and feedback ping-pong by copies into the
            # fixed buffers (every read of the old state came before).
            for k in range(len(hist) - 1, 0, -1):
                hist[k].copy_(hist[k - 1])
            if hist:
                hist[0].copy_(new_hist[0])
            for j, t in new_fb.items():
                fb[j].copy_(t)
            fc.add_(1)
            tm.add_(_DT)

    if not graph:
        return _Captured(_Eager(body), src, st, out)
    g = torch.cuda.CUDAGraph()
    torch.cuda.synchronize(dev)
    if not warm:
        # One uncaptured walk on the capture's stream first (its result is
        # not used): what a capture may not create, it finds made (library
        # handles and their workspaces for this stream).
        with torch.cuda.stream(prog.stream), walking(prog.walk):
            walk_fn(src0, state.history, state.feedback, state.frame_count, state.time)
        torch.cuda.synchronize(dev)
    with torch.cuda.stream(prog.stream):
        # thread_local: a frame queue's thread may copy on its own stream
        # meanwhile.
        g.capture_begin(capture_error_mode="thread_local")
        try:
            body()
        except BaseException as e:
            try:
                g.capture_end()
            except Exception:  # noqa: BLE001 - the capture is already invalid; report its first error
                pass
            raise ReplayError(
                f"the chain could not be captured into a CUDA graph: {type(e).__name__}: {e} "
                "(RCTPU_REPLAY=0 runs it uncaptured)"
            ) from e
        g.capture_end()
    torch.cuda.current_stream(dev).wait_stream(prog.stream)
    return _Captured(g, src, st, out)


def run_captured(prog: ChainProgram, walk_fn, src_b, state, out_shape, temporal: bool, make_state, stats: dict,
                 graph: bool):
    """Run the frames ``src_b [B, h, w, 4]`` of one key from ``state``
    through the program's captured frame (walked and captured first if
    the program has none). ``walk_fn(src, hist, fb, fc, tm) -> (out, hist, fb)`` is one
    frame's chain, ``out_shape`` its output's. Returns the outputs ``[B,
    oh, ow, 3]`` and the state the program holds after the last frame.
    ``graph``: capture a CUDA graph and replay it; else each frame runs
    the chain again over the same buffers (the CPU, and ``RCTPU_REPLAY=0``
    on a card, which ``stats`` counts as an uncaptured apply)."""
    dev = src_b.device
    nb = src_b.shape[0]
    stats["uncaptured_applies"] += not graph and dev.type == "cuda"
    if graph and prog.stream is None:
        prog.stream = torch.cuda.Stream(dev)
    side = torch.cuda.stream(prog.stream) if graph else contextlib.nullcontext()
    cur = torch.cuda.current_stream(dev) if graph else None
    if not temporal:
        fcs = state.frame_count + torch.arange(nb, dtype=torch.int32, device=dev)
        tms = state.time + _DT * torch.arange(nb, dtype=torch.float32, device=dev)
        fc_end, tm_end = state.frame_count + nb, state.time + _DT * np.float32(nb)
    outs = torch.empty((nb,) + tuple(out_shape), dtype=torch.float32, device=dev)
    i0 = 0
    cap = prog.captured.get(graph)
    if cap is None:
        t0 = time.perf_counter()
        if not prog.walk.recorded:
            # The first walk records the program's uploads; it runs frame 0
            # on the capture's stream, where it also warms what the capture
            # needs (library handles, the kernels' builds).
            if graph:
                prog.stream.wait_stream(cur)
            with side:
                fc0, tm0 = (state.frame_count, state.time) if temporal else (fcs[0], tms[0])
                with walking(prog.walk):
                    out0, hist, fb = walk_fn(src_b[0], state.history, state.feedback, fc0, tm0)
                outs[0].copy_(out0)
                if temporal:
                    state = make_state(hist, fb, state.frame_count + 1, state.time + _DT)
            if graph:
                cur.wait_stream(prog.stream)
            i0 = 1
        cap = prog.captured[graph] = _capture(prog, walk_fn, state, src_b[0], out_shape, temporal, make_state, graph,
                                              i0 == 1)
        state = cap.state
        if graph:
            stats["graphs_captured"] += 1
            stats["capture_seconds"] += time.perf_counter() - t0
    if state is not cap.state:
        _copy_state_into(cap.state, state)
    for i in range(i0, nb):
        cap.src.copy_(src_b[i])
        if not temporal:
            cap.state.frame_count.copy_(fcs[i])
            cap.state.time.copy_(tms[i])
        cap.graph.replay()
        outs[i].copy_(cap.out)
    stats["replays"] += (nb - i0) * graph
    if not temporal:
        cap.state.frame_count.copy_(fc_end)
        cap.state.time.copy_(tm_end)
    return outs, cap.state
