"""Build once per key, replay by CUDA graph: the counterpart of the
reference's ``Engine._get_jit`` cache (retrocapture_tpu/runtime/engine.py).

The reference traces a preset's chain once per key and runs the compiled
program for every later batch. The port evaluates the chain in Python, so
it keeps, per key, a ``ChainProgram``:

* its ``WalkProgram`` (policy.py): the host->device uploads of the first
  walk, taken back by every later walk, and the tables and device
  constants the walk derives from the key alone;
* on a CUDA device, a walk captured as a ``torch.cuda.CUDAGraph`` over
  buffers at fixed addresses: the frames (copied in, device to device),
  FrameCount and Time, the engine's parameter buffers (traced mode), the
  history ring and the PassFeedback textures, and the output.

The two shapes of walk are the reference's two branches of ``_get_jit``:

* **temporal** (its ``lax.scan``): one frame's step is captured and
  replayed once per frame. The graph ends by rotating the ring and storing
  the feedback into the fixed buffers, and by advancing FrameCount and
  Time. Over S streams (``apply_streams``) the step is one frame of every
  stream at once, ``torch.func.vmap`` of the frame over the stream axis.
* **stateless** (its ``jax.vmap``): the whole batch is one walk,
  ``torch.func.vmap`` of the frame's chain over the frames, frame ``i``
  seeing FrameCount ``fc + i`` and Time ``time + 0.016 i`` as device
  tensors (per stream ``s``, ``fc_s + i``). It is captured once per key and
  batch size and replayed once per apply. With fc-period grouping
  (``fc_group = (m, r0)``) the batch is m walks of B/m frames, each with
  one host FrameCount ``(r0 + p) % m`` and Time 0, interleaved back into
  frame order (the reference's engine.py:786-818).

The walk that is captured makes no host decision from device values and
no upload (``policy.upload`` takes every host value from the program and
raises while the stream captures). A capture that meets either fails, and
the failure is raised, not hidden. The viewport blit stays outside the
graph and runs once per batch on the whole batch.

Without a graph (on the CPU, and under ``RCTPU_REPLAY=0`` on a card) the
same path runs the walk again over the same fixed buffers: the uncaptured
run that the graph is held to is this code.

The kernel wrappers count their launches in Python (``LAUNCHES``): a walk
and a capture add to them, a graph's replay does not (its kernels run
without Python).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from retrocapture_tpu_torch.policy import WalkProgram, walking
from retrocapture_tpu_torch.utils.trace import span

__all__ = ["ChainProgram", "ReplayError", "run_captured", "new_stats", "stateless_batch"]

_DT = np.float32(0.016)  # Time advance per frame

class ReplayError(RuntimeError):
    """A chain that could not be captured into a CUDA graph."""


def new_stats() -> dict:
    """The counts ``Engine.replay_stats`` reports: ``frames`` run through the
    chain by every branch, ``fc_grouped_frames`` of them by the fc-period
    grouped one; over the frames, the passes that the nnedi3 entry
    computed (``nnedi3_passes``) and declined to the evaluator
    (``nnedi3_declined``), and the values it predicted (``nnedi3_values``)."""
    return {"graphs_captured": 0, "replays": 0, "uncaptured_applies": 0, "capture_seconds": 0.0,
            "frames": 0, "fc_grouped_frames": 0, "nnedi3_passes": 0, "nnedi3_declined": 0, "nnedi3_values": 0}


@dataclass
class _Captured:
    """A captured walk: the graph and the buffers it reads and writes."""

    graph: Any  # a torch.cuda.CUDAGraph, or _Eager
    src: torch.Tensor  # the frame (temporal) or the batch (stateless)
    state: Any  # the engine's _ChainState over the buffers below
    out: torch.Tensor  # the walk's output


class _Eager:
    """The walk run again at every replay, over the same fixed buffers: the
    replay path without a graph."""

    def __init__(self, body):
        self.replay = body


@dataclass
class ChainProgram:
    """What one key keeps: the walk's program and its captured walk, a
    CUDA graph (``captured[True]``) or the same buffers run without one
    (``captured[False]``)."""

    walk: WalkProgram = field(default_factory=WalkProgram)
    captured: dict = field(default_factory=dict)
    stream: Optional[Any] = None  # the side stream of the first walk and the capture
    counts: dict = field(default_factory=dict)  # what a walk tallied of one frame (policy.count)

    def release(self) -> None:
        self.captured = {}
        self.walk = WalkProgram()
        self.counts = {}


def _copy_state_into(dst, src) -> None:
    """Copy chain state ``src`` into the fixed buffers of ``dst``."""
    for d, s in zip(dst.history, src.history):
        d.copy_(s)
    for j, d in dst.feedback.items():
        d.copy_(src.feedback[j])
    dst.frame_count.copy_(src.frame_count)
    dst.time.copy_(src.time)


def _frame_steps(fc, tm, nb: int):
    """Per-frame FrameCount and Time of a stateless batch of ``nb`` frames
    from the base ``fc``, ``tm`` (0-d, or [S] per stream, the frames then
    stream after stream): ``fc + i`` and ``tm + 0.016 i`` (the reference's
    engine.py:862-865)."""
    n = nb // fc.numel()
    steps = torch.arange(n, dtype=torch.int32, device=fc.device)
    fcs = (fc[..., None] + steps).reshape(-1)
    tms = (tm[..., None] + steps.to(torch.float32) * float(_DT)).reshape(-1)
    return fcs, tms


def stateless_batch(walk_fn, history, feedback, nb: int, fc_group=None):
    """The walk of a stateless batch: ``batch(src [nb, h, w, 4], fc, tm)
    -> [nb, oh, ow, 3]``, ``torch.func.vmap`` of the frame's chain
    ``walk_fn(src, hist, fb, fc, tm) -> (out, hist, fb)`` over the frames.
    ``fc_group = (m, r0)``: m vmaps of nb/m frames, position p with the
    host FrameCount ``(r0 + p) % m`` and Time 0 (fc_period proved Time
    unused), interleaved back into frame order."""

    def one(src, fc, tm):
        return walk_fn(src, history, feedback, fc, tm)[0]

    def batch(src, fc, tm):
        if fc_group is None:
            fcs, tms = _frame_steps(fc, tm, nb)
            return torch.func.vmap(one)(src, fcs, tms)
        m, r0 = fc_group
        pos = [
            torch.func.vmap(lambda s, _fc=np.int32((r0 + p) % m): one(s, _fc, np.float32(0.0)))(src[p::m])
            for p in range(m)
        ]
        return torch.stack(pos, dim=1).reshape((nb,) + tuple(pos[0].shape[1:]))

    return batch


def _capture(prog: ChainProgram, body, graph: bool, warm, dev) -> Any:
    """``body`` captured into a CUDA graph on the program's stream (or, with
    ``graph`` False, kept to run again). ``warm``: None where the program's
    first walk ran on the capture's stream just before, else a walk to run
    uncaptured there first (its result is not used): what a capture may
    not create, it finds made (library handles and their workspaces for
    this stream)."""
    if not graph:
        return _Eager(body)
    g = torch.cuda.CUDAGraph()
    torch.cuda.synchronize(dev)
    if warm is not None:
        with torch.cuda.stream(prog.stream), walking(prog.walk):
            warm()
        torch.cuda.synchronize(dev)
    # The blocks that the walks freed stay cached in the allocator's general
    # pool, which the graph's private pool cannot take from: a batch's
    # capture needs them back on the card.
    torch.cuda.empty_cache()
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
    return g


def _fixed_state(state, make_state):
    """Buffers at fixed addresses holding a copy of ``state``."""
    st = make_state(
        tuple(torch.empty_like(h) for h in state.history),
        {j: torch.empty_like(t) for j, t in state.feedback.items()},
        torch.empty_like(state.frame_count),
        torch.empty_like(state.time),
    )
    _copy_state_into(st, state)
    return st


def _capture_step(prog, walk_fn, state, src0, out_shape, make_state, graph, warm: bool) -> _Captured:
    """Capture one temporal step over fixed buffers initialised from
    ``state``."""
    src = torch.empty_like(src0)
    out = torch.empty(out_shape, dtype=torch.float32, device=src0.device)
    st = _fixed_state(state, make_state)
    hist, fb, fc, tm = st.history, st.feedback, st.frame_count, st.time

    def body():
        with walking(prog.walk):
            o, new_hist, new_fb = walk_fn(src, hist, fb, fc, tm)
        out.copy_(o)
        # Ring rotation and feedback ping-pong by copies into the fixed
        # buffers (every read of the old state came before).
        for k in range(len(hist) - 1, 0, -1):
            hist[k].copy_(hist[k - 1])
        if hist:
            hist[0].copy_(new_hist[0])
        for j, t in new_fb.items():
            fb[j].copy_(t)
        fc.add_(1)
        tm.add_(_DT)

    def first():
        walk_fn(src0, state.history, state.feedback, state.frame_count, state.time)

    return _Captured(_capture(prog, body, graph, None if warm else first, src0.device), src, st, out)


def _capture_batch(prog, batch, state, src_b, out_shape, make_state, graph, warm: bool) -> _Captured:
    """Capture one stateless batch over fixed buffers: the frames, the base
    FrameCount and Time. ``warm``: the first walk ran just before."""
    src = torch.empty_like(src_b)
    out = torch.empty((src_b.shape[0],) + tuple(out_shape), dtype=torch.float32, device=src_b.device)
    st = _fixed_state(state, make_state)

    def body():
        with walking(prog.walk):
            out.copy_(batch(src, st.frame_count, st.time))

    def first():
        batch(src_b, state.frame_count, state.time)

    return _Captured(_capture(prog, body, graph, None if warm else first, src_b.device), src, st, out)


def run_captured(prog: ChainProgram, walk_fn, src_b, state, out_shape, temporal: bool, make_state, stats: dict,
                 graph: bool, fc_group=None):
    """Run the frames ``src_b`` of one key from ``state`` through the
    program's captured walk (walked and captured first if the program has
    none). ``walk_fn(src, hist, fb, fc, tm) -> (out, hist, fb)`` is one
    frame's chain (over S streams, the vmapped step of one frame of each),
    ``out_shape`` its output's.

    Temporal: ``src_b [T, ...]`` runs step by step, the state carried.
    Stateless: ``src_b [B, h, w, 4]`` is one walk of the batch
    (``stateless_batch``; ``state.frame_count`` 0-d, or [S] for B = S T
    frames stream after stream), ``fc_group`` its grouping. Returns the
    outputs ``[B or T, *out_shape]`` and the new state (a temporal chain's
    is the program's buffers). ``graph``: capture a CUDA graph and replay
    it; else the walk runs again over the same buffers (the CPU, and
    ``RCTPU_REPLAY=0`` on a card, which ``stats`` counts as an uncaptured
    apply)."""
    dev = src_b.device
    nb = src_b.shape[0]
    stats["uncaptured_applies"] += not graph and dev.type == "cuda"
    if graph and prog.stream is None:
        prog.stream = torch.cuda.Stream(dev)
    side = torch.cuda.stream(prog.stream) if graph else contextlib.nullcontext()
    cur = torch.cuda.current_stream(dev) if graph else None
    batch = None if temporal else stateless_batch(walk_fn, state.history, state.feedback, nb, fc_group)
    outs = None
    i0 = 0
    cap = prog.captured.get(graph)
    if cap is None:
        with span("rctpu.replay.capture"):
            t0 = time.perf_counter()
            if not prog.walk.recorded:
                # The first walk records the program's uploads; it runs on the
                # capture's stream, where it also warms what the capture needs
                # (library handles, the kernels' builds): frame 0 of a temporal
                # chain, the whole batch of a stateless one.
                if graph:
                    prog.stream.wait_stream(cur)
                with side, walking(prog.walk):
                    if temporal:
                        out0, hist, fb = walk_fn(
                            src_b[0], state.history, state.feedback, state.frame_count, state.time
                        )
                        outs = torch.empty((nb,) + tuple(out_shape), dtype=torch.float32, device=dev)
                        outs[0].copy_(out0)
                        state = make_state(hist, fb, state.frame_count + 1, state.time + _DT)
                    else:
                        outs = batch(src_b, state.frame_count, state.time)
                if graph:
                    cur.wait_stream(prog.stream)
                i0 = 1 if temporal else nb
            if temporal:
                cap = _capture_step(prog, walk_fn, state, src_b[0], out_shape, make_state, graph, i0 == 1)
                state = cap.state
            else:
                cap = _capture_batch(prog, batch, state, src_b, out_shape, make_state, graph, i0 == nb)
            prog.captured[graph] = cap
            if graph:
                stats["graphs_captured"] += 1
                stats["capture_seconds"] += time.perf_counter() - t0
    if not temporal:
        if i0 == 0:
            with span("rctpu.replay.launch"):
                _copy_state_into(cap.state, state)
                cap.src.copy_(src_b)
                cap.graph.replay()
                outs = cap.out.clone()
            stats["replays"] += graph
        n = nb // state.frame_count.numel()
        return outs, make_state(
            state.history, state.feedback, state.frame_count + n, state.time + float(_DT * np.float32(n))
        )
    if outs is None:
        outs = torch.empty((nb,) + tuple(out_shape), dtype=torch.float32, device=dev)
    with span("rctpu.replay.launch"):
        if state is not cap.state:
            _copy_state_into(cap.state, state)
        for i in range(i0, nb):
            cap.src.copy_(src_b[i])
            cap.graph.replay()
            outs[i].copy_(cap.out)
    stats["replays"] += (nb - i0) * graph
    return outs, cap.state
