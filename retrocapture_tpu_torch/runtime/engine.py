"""The Engine — RetroCapture's ShaderEngine contract in PyTorch.

API mirrors src/shader/ShaderEngine.h:54-93 and the JAX package's
``retrocapture_tpu.runtime.engine.Engine``: ``load_preset`` /
``set_parameter`` / ``get_parameters`` / ``apply``; a failed preset load
degrades to passthrough while keeping extracted parameter metadata for
UIs, exactly like the reference (ShaderEngine.cpp:294-314).

Execution model:
* The evaluator walks the chain once per frame: every pass of the chain
  is evaluated over its output grid on the engine's device, each pass's
  framebuffer format applied as an epilogue
  (ops/colorspace.framebuffer_store). FrameCount and Time are device
  scalars. Runtime parameters are constants of the evaluation (const
  mode) or, after ``set_param_mode("traced")``, f32 device buffers, one per
  parameter, that ``set_parameter`` writes (the reference's traced mode).
* A batch takes one of four branches, in the reference's order
  (its ``Engine._get_jit``):
  1. concrete FrameCount (``RCTPU_CONCRETE_FC=1``, the parity harnesses'
     mode): frame by frame, FrameCount and Time handed to the evaluator as
     numpy scalars, so that time-dependent math folds through its exact
     numpy path;
  2. fc-period grouped (a stateless chain whose every FrameCount reader
     declares a ``frame_count_mod``, ``PresetProgram.fc_period``; off under
     ``RCTPU_FC_GROUP=0``): the batch in m positions of B/m frames, each
     with one host FrameCount;
  3. temporal (a 7-deep history ring of final outputs —
     ShaderEngine.cpp:1731-1865 — or PassFeedback ping-pong :1280-1347):
     frame by frame, an explicit ``_ChainState`` carried;
  4. stateless: the whole batch in one walk, ``torch.func.vmap`` of the
     frame's chain, frame i with FrameCount fc + i and Time time + 0.016 i.
* Per key (source and viewport size, input quantization, parameter mode;
  for a stateless chain also the batch size and the grouping) the engine
  keeps a program (runtime/replay.py): the first walk records its uploads
  and every later walk takes them back; on a card the walk is captured
  into a CUDA graph after the first walk (one frame's step of a temporal
  chain, replayed per frame; a stateless chain's whole batch, replayed
  once an apply); without a graph (the CPU, ``RCTPU_REPLAY=0``) the same
  walk runs again over the same buffers.
* The viewport blit is stateless and runs once per batch, batched, after
  the chain (the CUDA blit kernel for ``output="u8"``).
* ``apply_streams`` keeps one chain state per stream, stacked along a
  leading stream axis: a temporal chain's step runs every stream's frame
  at once (vmap over the streams), a stateless chain runs all S·T frames
  as one batch.

The engine runs on the card (``device="cuda"``, the default) unless the
caller names another device, and raises rather than fall back to the CPU
when there is no card; frames given as numpy arrays are uploaded to its
device.
"""

from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from retrocapture_tpu_torch.frontend.interp import UnsupportedShaderError
from retrocapture_tpu_torch.frontend.values import GlslEvalError, GType, V, smart_device
from retrocapture_tpu_torch.graph.plan import (
    PassContext,
    PresetProgram,
    TexBinding,
    compile_preset,
)
from retrocapture_tpu_torch.graph.scale import PassShapes, compute_chain_shapes
from retrocapture_tpu_torch.ops import colorspace as cs
from retrocapture_tpu_torch.ops.colorspace import framebuffer_store
from retrocapture_tpu_torch.ops.cuda.resample import _quantize_u8, blit_u8
from retrocapture_tpu_torch.ops.sampling import sample2d
from retrocapture_tpu_torch.policy import to_device, upload
from retrocapture_tpu_torch.policy import unrecorded, walk_program
from retrocapture_tpu_torch.presets.glslp import Preset
from retrocapture_tpu_torch.runtime import replay
from retrocapture_tpu_torch.utils.logging import get_logger

__all__ = ["Engine", "MAX_FRAME_HISTORY", "chain_state_from_numpy"]

MAX_FRAME_HISTORY = 7  # ShaderEngine.h:143
_DT = np.float32(0.016)  # Time advance per frame

log = get_logger(__name__)

# Concrete-FrameCount mode: FrameCount and Time reach the evaluator as
# numpy scalars (one host read of the state's frame count per apply).
_CONCRETE_FC = os.environ.get("RCTPU_CONCRETE_FC", "0") == "1"

# The errors of a chain that does not lower (the reference's GL compile
# failure); in traced mode they send the preset to const mode first.
_LOWERING_ERRORS = (GlslEvalError, ValueError, IndexError, TypeError)


def _replay_on() -> bool:
    """``RCTPU_REPLAY=0`` runs a card's frames without a graph (for A/B
    runs and tests); read at every apply."""
    return os.environ.get("RCTPU_REPLAY", "1") != "0"


def _fc_group_on() -> bool:
    """``RCTPU_FC_GROUP=0`` turns fc-period grouping off (bit-identical;
    for A/B runs); read at every apply."""
    return os.environ.get("RCTPU_FC_GROUP", "1") != "0"


def _grids(w: int, h: int) -> tuple[np.ndarray, np.ndarray]:
    """Concrete (NumPy) pixel-center coordinate grids [h, w]."""
    u = (np.arange(w, dtype=np.float32) + 0.5) / np.float32(w)
    v = (np.arange(h, dtype=np.float32) + 0.5) / np.float32(h)
    return np.broadcast_to(u[None, :], (h, w)), np.broadcast_to(v[:, None], (h, w))


@dataclass
class _ChainState:
    """Per-(source, viewport) device state."""

    history: tuple  # tuple of [vh, vw, 4] tensors, most recent first
    feedback: dict[int, Any]  # pass index → [oh, ow, 4]
    frame_count: Any  # int32 0-d tensor
    time: Any  # float32 0-d tensor


def chain_state_from_numpy(history, feedback, frame_count, time, device) -> _ChainState:
    """The port's chain state from the JAX engine's ``_ChainState`` arrays
    (after ``np.asarray``): history tuple, feedback dict, frame count and
    time, uploaded to ``device``. The per-stream state of
    ``apply_streams`` has a leading stream axis on every array, frame
    count and time included, and converts the same way."""
    return _ChainState(
        history=tuple(to_device(np.asarray(h, np.float32), device) for h in history),
        feedback={int(j): to_device(np.asarray(t, np.float32), device) for j, t in feedback.items()},
        frame_count=to_device(np.asarray(frame_count, np.int32), device),
        time=to_device(np.asarray(time, np.float32), device),
    )


class Engine:
    """load preset → set parameters → process frames."""

    def __init__(self, viewport: Optional[tuple[int, int]] = None, *, device="cuda"):
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Engine: CUDA is not available; pass device='cpu' to run on the CPU")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._program: Optional[PresetProgram] = None
        self._preset: Optional[Preset] = None
        self._custom_params: dict[str, float] = {}
        self._viewport = viewport  # (W, H) or None → source size
        self._states: dict = {}
        # Host mirror of each state's frame count (it advances by the batch
        # size an apply), so that fc-period grouping knows FrameCount % m
        # with no read of the device.
        self._fc_hosts: dict = {}
        self._max_resolution: Optional[tuple[int, int]] = None
        self._input_format = "rgb"  # rgb | nv12 | yuyv | uyvy
        self._lowering_failed = False
        self._param_mode = "const"  # "const" | "traced"
        self._param_const_fallback = False  # traced lowering failed once
        self._param_bufs: dict[str, torch.Tensor] = {}  # traced: name -> f32 0-d buffer
        self._programs: dict = {}  # program key -> replay.ChainProgram
        self._stats = replay.new_stats()
        self.shader_active = False
        self.last_error: Optional[str] = None

    # -- preset management ---------------------------------------------
    def load_preset(self, path: str) -> bool:
        """Parse + compile a .glslp (or bare .glsl as a single pass).
        Returns False and degrades to passthrough on failure, keeping any
        extracted parameters (reference behavior, ShaderEngine.cpp:294)."""
        self._states.clear()
        self._fc_hosts.clear()
        self._custom_params.clear()
        self._lowering_failed = False
        self._param_const_fallback = False
        self._param_bufs.clear()
        self._drop_programs()
        try:
            if str(path).endswith(".glsl"):
                preset = Preset.loads(f"shaders = 1\nshader0 = {path}\n", path=str(path))
            else:
                preset = Preset.load(path)
            self._preset = preset
            self._program = compile_preset(preset)
            self.shader_active = True
            self.last_error = None
            return True
        except Exception as e:  # noqa: BLE001 - degrade like the reference
            log.warning("preset load failed, falling back to passthrough: %s", e)
            self.last_error = f"{type(e).__name__}: {e}"
            self._program = None
            self.shader_active = False
            return False

    def unload(self) -> None:
        self._program = None
        self._preset = None
        self.shader_active = False
        self._states.clear()
        self._fc_hosts.clear()
        self._param_bufs.clear()
        self._drop_programs()

    # -- parameters -----------------------------------------------------
    def get_parameters(self) -> list[dict]:
        """Dedup'd parameter metadata across passes, first-wins; value
        precedence custom > preset-file > pragma default
        (ShaderEngine::getShaderParameters, ShaderEngine.cpp:3264)."""
        if self._program is None:
            return []
        out = []
        for name, meta in self._program.parameters.items():
            value = self._custom_params.get(name, self._program.defaults.get(name, meta.initial))
            out.append(
                {
                    "name": name,
                    "description": meta.description,
                    "value": float(value),
                    "default": meta.initial,
                    "min": meta.minimum,
                    "max": meta.maximum,
                    "step": meta.step,
                }
            )
        return out

    def set_parameter(self, name: str, value: float) -> bool:
        """Validates the parameter exists and clamps to [min, max]
        (ShaderEngine::setShaderParameter, ShaderEngine.cpp:3353). Takes
        effect on the next apply(): in const mode the programs are built
        anew; in traced mode the value goes into the parameter's device
        buffer, which the kept programs read (glUniform's behaviour)."""
        if self._program is None or name not in self._program.parameters:
            return False
        meta = self._program.parameters[name]
        value = float(np.clip(value, meta.minimum, meta.maximum))
        self._custom_params[name] = value
        if self._effective_param_mode() == "traced":
            buf = self._param_bufs.get(name)
            if buf is not None:
                buf.fill_(value)
        else:
            self._drop_programs()
        return True

    def set_param_mode(self, mode: str) -> None:
        """'const' (default): parameters are constants of the evaluation;
        changing one builds the programs anew. 'traced': parameters are f32
        device buffers, one per parameter, read by the kept programs, so a
        ``set_parameter`` applies on the next frame with no rebuild
        (ShaderEngine.cpp:3353). Parameter-dependent sampling grids then
        take the warped paths; a shader that needs a parameter as a
        concrete value (a loop bound, an array size) sends the preset to
        const mode, with a warning, as in the reference."""
        if mode not in ("const", "traced"):
            raise ValueError(f"unknown param mode {mode!r}")
        if mode != self._param_mode:
            self._param_mode = mode
            self._drop_programs()

    def _effective_param_mode(self) -> str:
        if self._param_mode == "traced" and not self._param_const_fallback:
            return "traced"
        return "const"

    def _walk_params(self) -> dict:
        """The parameters a walk sees: f32 constants in const mode, the
        parameter buffers in traced mode (made on first use, at fixed
        addresses for the programs' lifetime)."""
        params = dict(self._program.defaults)
        params.update(self._custom_params)
        if self._effective_param_mode() != "traced":
            return params
        for k, v in params.items():
            if k not in self._param_bufs:
                self._param_bufs[k] = torch.full((), float(v), dtype=torch.float32, device=self.device)
        return {k: self._param_bufs[k] for k in params}

    def replay_stats(self, reset: bool = False) -> dict:
        """Graphs captured, frames replayed, applies on a card that walked
        uncaptured (``RCTPU_REPLAY=0`` or concrete FrameCount), and the
        seconds spent in first walks and captures; ``reset`` zeroes them."""
        out = dict(self._stats)
        if reset:
            self._stats = replay.new_stats()
        return out

    def _drop_programs(self) -> None:
        """Release every kept program (and its graph and pool)."""
        if self._programs and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # no graph may be in flight
        for p in self._programs.values():
            p.release()
        self._programs.clear()

    def get_parameter(self, name: str) -> Optional[float]:
        if self._program is None:
            return None
        if name in self._custom_params:
            return self._custom_params[name]
        return self._program.defaults.get(name)

    def set_input_format(self, fmt: str) -> None:
        """Raw capture pixel format: 'rgb' (default, [H,W,3] u8/float),
        'nv12' (packed planes [H*3/2, W] u8), 'yuyv'/'uyvy' ([H, W*2]
        u8). Non-RGB formats are converted to RGB at the head of the
        chain (processing/FrameProcessor.cpp:149-179)."""
        if fmt not in ("rgb", "nv12", "yuyv", "uyvy"):
            raise ValueError(f"unknown input format {fmt!r}")
        self._input_format = fmt
        self._drop_programs()

    def _packed_hw(self, ph: int, pw: int) -> tuple[int, int]:
        """Logical (h, w) from a packed raw plane shape."""
        fmt = self._input_format
        if fmt == "nv12":
            return (ph * 2) // 3, pw
        if fmt in ("yuyv", "uyvy"):
            return ph, pw // 2
        return ph, pw

    def _convert_packed(self, raw_b):
        """Packed u8 batch → float RGB [B, H, W, 3]."""
        fmt = self._input_format
        ph, pw = raw_b.shape[1], raw_b.shape[2]
        h, w = self._packed_hw(ph, pw)
        if fmt == "nv12":
            return cs.nv12_to_rgb(raw_b[:, :h, :], raw_b[:, h:, :], w, h)
        if fmt == "yuyv":
            return cs.yuyv_to_rgb(raw_b, w, h)
        if fmt == "uyvy":
            return cs.uyvy_to_rgb(raw_b, w, h)
        return raw_b

    def set_viewport(self, width: int, height: int) -> None:
        self._viewport = (int(width), int(height))
        self._drop_programs()

    def set_max_shader_resolution(self, width: int, height: int) -> None:
        """Clamp the chain's source resolution: larger inputs are
        downscaled (bilinear) before the first pass — the low-power-device
        path (ShaderEngine::setMaxShaderResolution, ShaderEngine.cpp:50-63,
        applied at :1621-1657). 0 disables."""
        self._max_resolution = (int(width), int(height))
        self._states.clear()
        self._fc_hosts.clear()
        self._drop_programs()

    def reset_state(self) -> None:
        self._states.clear()
        self._fc_hosts.clear()

    # -- state checkpoint/restore ----------------------------------------
    def save_state(self, path: str) -> None:
        """Serialize temporal state (history ring, PassFeedback textures,
        frame counters) to an .npz in the JAX package's layout."""
        blobs: dict[str, np.ndarray] = {}
        meta = []
        for ki, (key, st) in enumerate(self._states.items()):
            meta.append(
                {
                    "key": list(key),
                    "n_history": len(st.history),
                    "feedback_keys": sorted(st.feedback),
                }
            )
            for j, htex in enumerate(st.history):
                blobs[f"s{ki}_h{j}"] = htex.cpu().numpy()
            for j in sorted(st.feedback):
                blobs[f"s{ki}_f{j}"] = st.feedback[j].cpu().numpy()
            blobs[f"s{ki}_fc"] = st.frame_count.cpu().numpy()
            blobs[f"s{ki}_tm"] = st.time.cpu().numpy()
        blobs["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        np.savez(_npz_path(path), **blobs)

    def load_state(self, path: str) -> None:
        """Restore state written by ``save_state`` of either package."""
        data = np.load(_npz_path(path))
        meta = json.loads(bytes(data["__meta__"]).decode())
        self._states.clear()
        self._fc_hosts.clear()
        for ki, m in enumerate(meta):
            fc = np.asarray(data[f"s{ki}_fc"])
            if fc.ndim == 0:  # a stream state's is per stream, and never grouped
                self._fc_hosts[tuple(m["key"])] = int(fc)
            self._states[tuple(m["key"])] = chain_state_from_numpy(
                [data[f"s{ki}_h{j}"] for j in range(m["n_history"])],
                {j: data[f"s{ki}_f{j}"] for j in m["feedback_keys"]},
                data[f"s{ki}_fc"],
                data[f"s{ki}_tm"],
                self.device,
            )

    # -- application ----------------------------------------------------
    def apply(self, frames, output: str = "f32"):
        """Process one frame [H,W,3|4] or a batch [B,H,W,3|4] (uint8 or
        float; packed [B, ph, pw] u8 for nv12/yuyv/uyvy). Returns RGB at
        the viewport size on the engine's device: float32 in [0,1]
        (default) or, with ``output="u8"``, uint8 from the fused blit
        kernel. Batches of temporal presets run frame by frame with the
        state carried; stateless presets run the whole batch at once, every
        frame from the same state."""
        if output not in ("f32", "u8"):
            raise ValueError(f"unknown output {output!r}")
        arr = self._upload(frames)
        packed = self._input_format != "rgb"
        if not packed and arr.dim() == 5:
            return self.apply_streams(arr)
        batched = arr.dim() == (3 if packed else 4)
        if not batched:
            arr = arr[None]
        if packed:
            h, w = self._packed_hw(arr.shape[1], arr.shape[2])
        else:
            h, w = arr.shape[1], arr.shape[2]
        vw, vh = self._viewport or (w, h)

        if self._program is None or self._lowering_failed:
            out = self._passthrough_out(arr, packed, vw, vh, output)
            return out if batched else out[0]

        key = (h, w, vw, vh)
        try:
            state = self._get_state(key, seed_source=self._history_seed(key, arr, packed))
            fc_static = int(state.frame_count) if _CONCRETE_FC else None
            out, new_state = self._run_batch(key, arr, state, fc_static=fc_static)
        except _LOWERING_ERRORS as e:
            if self._traced_fallback(e):
                return self.apply(frames, output=output)
            self._lowering_failure(e)
            out = self._passthrough_out(arr, packed, vw, vh, output)
            return out if batched else out[0]
        self._commit(key, new_state, arr.shape[0])
        # Outside the try: an error of the blit is no lowering failure.
        out = _finalize(out, vw, vh, output == "u8")
        return out if batched else out[0]

    def apply_streams(self, frames):
        """Process S independent streams of T frames each:
        ``[S, T, H, W, 3|4]`` → ``[S, T, vh, vw, 3]`` float32. Temporal
        state is kept per stream, stacked along a leading stream axis
        under the key ``(h, w, vw, vh, S, "const")`` (the layout of the
        JAX package's checkpoints), so stream ``s`` renders what an
        engine of its own would, fed that stream alone. A temporal chain
        steps every stream's frame t at once (the reference's vmap over
        streams of its scan); a stateless chain runs the S·T frames as one
        batch, each stream from its own FrameCount."""
        arr = self._upload(frames)
        if arr.dim() != 5:
            raise ValueError(f"apply_streams expects [S, T, H, W, C], got {tuple(arr.shape)}")
        s, t, h, w = arr.shape[0], arr.shape[1], arr.shape[2], arr.shape[3]
        vw, vh = self._viewport or (w, h)
        if self._program is None or self._lowering_failed:
            src = self._to_rgba_float(arr)
            flat = src.reshape((s * t,) + tuple(src.shape[2:]))
            out = self._passthrough(flat, vw, vh)[..., :3]
            return out.reshape((s, t) + tuple(out.shape[1:]))

        key = (h, w, vw, vh, s, self._effective_param_mode())
        state = self._states.get(key)
        if state is None:
            proto = self._get_state((h, w, vw, vh))
            state = _map_state(proto, lambda x: x.expand((s,) + tuple(x.shape)))
            if self._program.uses_history() and state.history:
                # Seed each stream's cold ring from its own first frame
                # (unfilled-slot = pass-input reference semantics).
                hh, hw = state.history[0].shape[1:3]
                firsts = self._to_rgba_float(arr[:, 0])
                entry = torch.stack([_history_entry(f, hw, hh) for f in firsts])
                state = _ChainState(
                    tuple(entry for _ in state.history), state.feedback, state.frame_count, state.time
                )
            self._states[key] = state
        try:
            out, new = self._run_batch((h, w, vw, vh), arr.reshape((s * t,) + tuple(arr.shape[2:])), state, streams=s)
        except _LOWERING_ERRORS as e:
            if self._traced_fallback(e):
                return self.apply_streams(arr)
            self._lowering_failure(e)
            return self.apply_streams(arr)
        self._states[key] = new
        out = _finalize(out, vw, vh, False)
        return out.reshape((s, t) + tuple(out.shape[1:]))

    # convenience mirror of the reference's RGB24 readback output
    def apply_u8(self, frames) -> np.ndarray:
        """Like ``apply(..., output="u8")`` (the fused blit kernel on the
        card) brought to the host as numpy uint8: the transfer moves 1/4
        of the bytes (the PBO-readback analog). A chain that does not
        lower retreats to the quantized f32 path (which records the
        failure and passes through); the blit runs outside that retreat,
        so a blit kernel that refuses its input or fails to build or
        launch raises."""
        arr = self._upload(frames)
        if self._program is None or self._lowering_failed or arr.dim() not in (3, 4):
            return _quantize_u8(self.apply(arr)).cpu().numpy()
        batched = arr.dim() == 4
        if not batched:
            arr = arr[None]
        h, w = arr.shape[1], arr.shape[2]
        vw, vh = self._viewport or (w, h)
        key = (h, w, vw, vh)
        try:
            state = self._get_state(key, seed_source=self._history_seed(key, arr, False))
            out, new_state = self._run_batch(key, arr, state)
        except _LOWERING_ERRORS:
            return _quantize_u8(self.apply(frames)).cpu().numpy()
        self._commit(key, new_state, arr.shape[0])
        out = _finalize(out, vw, vh, True).cpu().numpy()
        return out if batched else out[0]

    # -- internals ------------------------------------------------------
    def _traced_fallback(self, e: Exception) -> bool:
        """In traced mode a chain that needs a parameter as a concrete value
        (loop bound, array size) retries in const mode, for good (the
        reference's const fallback). False in const mode."""
        if self._effective_param_mode() != "traced":
            return False
        log.warning("traced params unsupported here, const fallback: %s", e)
        self._param_const_fallback = True
        self._drop_programs()
        return True

    def _lowering_failure(self, e: Exception) -> None:
        """A pass failed to lower — the reference's GL compile would have
        failed too; degrade to passthrough but KEEP the extracted
        parameter metadata (ShaderEngine.cpp:294-314)."""
        log.warning("shader lowering failed, passthrough: %s", e)
        self.last_error = f"{type(e).__name__}: {e}"
        self.shader_active = False
        self._lowering_failed = True
        self._states.clear()
        self._fc_hosts.clear()
        self._drop_programs()

    def _upload(self, frames) -> torch.Tensor:
        if isinstance(frames, torch.Tensor):
            if frames.device != self.device:
                raise ValueError(
                    f"frames are on {frames.device}, the engine on {self.device}"
                )
            return frames
        return to_device(np.asarray(frames), self.device)

    def _passthrough_out(self, arr, packed: bool, vw: int, vh: int, output: str):
        src = self._to_rgba_float(self._convert_packed(arr) if packed else arr)
        out = self._passthrough(src, vw, vh)[..., :3]
        return _quantize_u8(out) if output == "u8" else out

    def _history_seed(self, key, arr, packed: bool):
        """Normalized first frame for seeding a cold history ring, or
        None when the state is already warm / the preset keeps none."""
        if key in self._states or not self._program.uses_history():
            return None
        first = self._convert_packed(arr[:1]) if packed else arr[:1]
        return self._to_rgba_float(first)[0]

    @staticmethod
    def _to_rgba_float(arr):
        if arr.dtype == torch.uint8:
            arr = arr.to(torch.float32) * (1.0 / 255.0)
        else:
            arr = arr.to(torch.float32)
        if arr.shape[-1] == 3:
            alpha = torch.ones(arr.shape[:-1] + (1,), dtype=torch.float32, device=arr.device)
            arr = torch.cat([arr, alpha], dim=-1)
        return arr

    @staticmethod
    def _resize_bilinear(tex, out_w: int, out_h: int):
        u, v = _grids(out_w, out_h)
        return sample2d(tex, u, v, filter_linear=True)

    def _passthrough(self, src, vw: int, vh: int):
        if src.shape[2] == vw and src.shape[1] == vh:
            return src
        return torch.stack([self._resize_bilinear(t, vw, vh) for t in src])

    def _get_state(self, key, seed_source=None) -> _ChainState:
        st = self._states.get(key)
        if st is not None:
            return st
        h, w, vw, vh = key
        prog = self._program
        pw, ph = self._clamped_source(w, h)
        shapes = compute_chain_shapes(
            prog.preset, pw, ph, vw, vh, max_resolution=self._max_resolution
        )
        dev = self.device
        history = ()
        if prog.uses_history():
            last = shapes[-1]
            if seed_source is not None:
                # Reference semantics for unfilled history slots: the
                # PrevN sampler stays unbound → texture unit 0 → the
                # pass input (ShaderEngine.cpp:1137-1155). Seed the ring
                # with the first frame resized through the same path a
                # real history entry takes.
                entry = _history_entry(seed_source, last.out_w, last.out_h)
                history = tuple(entry for _ in range(MAX_FRAME_HISTORY))
            else:
                history = tuple(
                    torch.zeros((last.out_h, last.out_w, 4), dtype=torch.float32, device=dev)
                    for _ in range(MAX_FRAME_HISTORY)
                )
        feedback = {}
        if prog.uses_feedback():
            for j, sh in enumerate(shapes):
                feedback[j] = torch.zeros((sh.out_h, sh.out_w, 4), dtype=torch.float32, device=dev)
        st = _ChainState(
            history=history,
            feedback=feedback,
            frame_count=torch.zeros((), dtype=torch.int32, device=dev),
            time=torch.zeros((), dtype=torch.float32, device=dev),
        )
        self._states[key] = st
        self._fc_hosts[key] = 0
        return st

    def _commit(self, key, state: _ChainState, nb: int) -> None:
        """Keep the state an apply of ``nb`` frames left under ``key``, its
        frame count's host mirror advanced."""
        self._states[key] = state
        if key in self._fc_hosts:
            self._fc_hosts[key] += nb

    def _fc_group(self, key, nb: int, temporal: bool, fc_static) -> Optional[tuple[int, int]]:
        """``(m, FrameCount % m)`` where a batch takes the fc-period grouped
        branch (the reference's engine.py:370-392), else None: grouping on,
        FrameCount not concrete, a stateless chain, more than one frame, a
        period 2 <= m <= 8 that divides the batch, and the key's frame count
        known on the host. A period of 1 (the chain never reads FrameCount)
        would only add interleave copies."""
        if not _fc_group_on() or fc_static is not None or temporal or nb <= 1:
            return None
        m = self._program.fc_period()
        r0 = self._fc_hosts.get(key)
        if m is None or not 2 <= m <= 8 or nb % m or r0 is None:
            return None
        return m, r0 % m

    def _clamped_source(self, w: int, h: int) -> tuple[int, int]:
        """Max-resolution clamp preserving aspect, even dims
        (ShaderEngine.cpp:1621-1657)."""
        if self._max_resolution is None:
            return w, h
        mw, mh = self._max_resolution
        if mw <= 0 or mh <= 0 or (w <= mw and h <= mh):
            return w, h
        aspect = w / h
        pw, ph = w, h
        if pw > mw:
            pw = mw
            ph = int(round(mw / aspect))
        if ph > mh:
            ph = mh
            pw = int(round(mh * aspect))
        return max((pw // 2) * 2, 2), max((ph // 2) * 2, 2)

    def _run_batch(self, key, raw_b, state: _ChainState, fc_static: Optional[int] = None,
                   streams: Optional[int] = None):
        """Normalize the batch and run the chain over every frame; the
        caller blits (``_finalize``). Returns the last pass's RGB frames
        ``[B, h, w, 3]`` and the new state (a temporal chain's is the
        state its program's buffers hold). ``fc_static`` is the state's
        frame count as a host integer in concrete-FrameCount mode, else
        None. ``streams``: the batch is S streams of T frames, stream after
        stream, and ``state`` holds one state per stream (apply_streams)."""
        h, w, vw, vh = key
        prog = self._program
        pw, ph = self._clamped_source(w, h)
        shapes = compute_chain_shapes(
            prog.preset, pw, ph, vw, vh, max_resolution=self._max_resolution
        )
        params = self._walk_params()
        temporal = prog.uses_history() or prog.uses_feedback()
        # Chain input sits on the k/255 grid only when it is raw u8 RGB
        # with no packed-format convert and no pre-resize (both produce
        # off-grid floats).
        src_quant = (
            raw_b.dtype == torch.uint8 and self._input_format == "rgb" and (pw, ph) == (w, h)
        )
        if self._input_format != "rgb":
            raw_b = self._convert_packed(raw_b)
        src_b = Engine._to_rgba_float(raw_b)
        if (pw, ph) != (w, h):
            u, v = _grids(pw, ph)
            src_b = torch.stack([sample2d(t, u, v, filter_linear=True) for t in src_b])
        nb = src_b.shape[0]

        def single(src, hist, fb, fc, tm):
            return _run_chain_impl(
                prog, shapes, (vw, vh), src, hist, fb, fc, tm, params,
                blit=False, source_quantized=src_quant,
            )

        card = self.device.type == "cuda"
        if fc_static is not None:
            # Frames run with FrameCount and Time as host constants, so
            # time-dependent math (noise seeds ``xy * float(FrameCount)``,
            # scanline phase) folds through the evaluator's numpy path,
            # as in the reference, where every uniform is concrete per
            # draw call. Time is f32(0.016) * f32(fc), not the running sum.
            # A plain walk: its host constants change with every frame.
            self._stats["uncaptured_applies"] += card
            hist, fb = state.history, state.feedback
            outs = []
            for i in range(nb):
                out, hist, fb = single(
                    src_b[i], hist, fb, np.int32(fc_static + i), _DT * np.float32(fc_static + i)
                )
                outs.append(out)
            new_state = _ChainState(
                hist, fb, state.frame_count + nb, state.time + _DT * np.float32(nb)
            )
            return torch.stack(outs)[..., :3], new_state

        out_shape = (shapes[-1].out_h, shapes[-1].out_w, 3)
        fc_group = None if streams else self._fc_group(key, nb, temporal, fc_static)
        pkey = (h, w, vw, vh, src_quant, self._effective_param_mode())
        if streams:
            pkey += ("streams", streams)
        if not temporal:
            pkey += (nb, fc_group)
        program = self._programs.get(pkey)
        if program is None:
            program = self._programs[pkey] = replay.ChainProgram()
        walk_fn = single
        if streams and temporal:
            # One step of every stream at once: frame t of the S streams,
            # each with its own state.
            walk_fn = torch.func.vmap(single)
            src_b = src_b.reshape((streams, nb // streams) + tuple(src_b.shape[1:])).transpose(0, 1)
            out_shape = (streams,) + out_shape
        out, new_state = replay.run_captured(
            program, walk_fn, src_b, state, out_shape, temporal, _ChainState, self._stats,
            graph=card and _replay_on(), fc_group=fc_group,
        )
        if streams and temporal:
            out = out.transpose(0, 1).reshape((nb,) + tuple(out.shape[2:]))
        return out, new_state


def _map_state(state: _ChainState, fn) -> _ChainState:
    """``fn`` applied to every tensor of a chain state."""
    return _ChainState(
        history=tuple(fn(x) for x in state.history),
        feedback={j: fn(x) for j, x in state.feedback.items()},
        frame_count=fn(state.frame_count),
        time=fn(state.time),
    )


def _finalize(outs_b, vw: int, vh: int, u8: bool):
    """Batched viewport blit + output packing. The u8 path is the fused
    blit kernel (ops/cuda/resample.blit_u8)."""
    needs_blit = outs_b.shape[1] != vh or outs_b.shape[2] != vw
    if not u8:
        if needs_blit:
            u, v = _grids(vw, vh)
            outs_b = torch.stack([sample2d(t, u, v, filter_linear=True) for t in outs_b])
        return outs_b
    return blit_u8(outs_b, vw, vh)


def _npz_path(path: str) -> str:
    """np.savez appends .npz when absent — normalize so a checkpoint
    saved as 'state' loads back as 'state'."""
    return path if str(path).endswith(".npz") else str(path) + ".npz"


def _history_entry(src, out_w: int, out_h: int):
    """Build a frame-history ring entry from a frame: resize to the ring
    shape with the LINEAR blit and quantize to RGBA8, exactly like the
    in-chain history update (the GL copy into a GL_RGBA/UNSIGNED_BYTE
    texture, ShaderEngine.cpp:1744-1756)."""
    if src.shape[0] != out_h or src.shape[1] != out_w:
        u, v = _grids(out_w, out_h)
        src = sample2d(src, u, v, filter_linear=True)
    return framebuffer_store(src, float_framebuffer=False, srgb_framebuffer=False)


# ---------------------------------------------------------------------------
# Chain execution


def _run_chain_impl(
    prog: PresetProgram,
    shapes: list[PassShapes],
    viewport: tuple[int, int],
    source,  # [h, w, 4] float32
    history: tuple,
    feedback: dict[int, Any],
    frame_count,
    time,
    params: dict[str, float],
    blit: bool = True,
    source_quantized: bool = False,
):
    """Execute every pass of a compiled preset for one frame. FrameCount
    increments once per frame, not per pass (ShaderEngine.cpp:1685-1689);
    history updates most-recent-first with the *final* processed output
    (:1731-1865); feedback ping-pong swaps at frame end (:1710-1718)."""
    n = len(prog.passes)
    src_h, src_w = source.shape[0], source.shape[1]
    preset = prog.preset

    def filter_of_output(j: int) -> tuple[bool, str, bool]:
        # Output of pass j carries the texture state last applied by the
        # pass that consumed it as input (j+1); the final pass's output
        # keeps the FBO defaults LINEAR/clamp (createFramebuffer).
        if j + 1 < n:
            cfg = preset.passes[j + 1]
            return cfg.filter_linear, cfg.wrap_mode, cfg.mipmap_input
        return True, "clamp_to_edge", False

    def _stored_quant(j: int) -> bool:
        cfg_j = preset.passes[j]
        return not cfg_j.float_framebuffer and not cfg_j.srgb_framebuffer

    original_binding = TexBinding(
        source,
        preset.passes[0].filter_linear,
        preset.passes[0].wrap_mode,
        preset.passes[0].mipmap_input,
        quantized=source_quantized,
    )
    # History entries are RGBA8 copies (framebuffer_store below).
    history_bindings = [
        TexBinding(t, True, "clamp_to_edge", quantized=True) for t in history
    ]

    pass_outputs: list[Optional[TexBinding]] = []
    outputs_raw: list = []
    current = source
    cur_quant = source_quantized
    for i, cp in enumerate(prog.passes):
        cfg = preset.passes[i]
        sh = shapes[i]
        input_binding = TexBinding(
            current, cfg.filter_linear, cfg.wrap_mode, cfg.mipmap_input,
            quantized=cur_quant,
        )
        fb_bindings = {
            j: TexBinding(t, *filter_of_output(j), quantized=_stored_quant(j))
            for j, t in feedback.items()
        }
        ctx = PassContext(
            prog,
            i,
            shapes=shapes,
            viewport=viewport,
            source_size=(src_w, src_h),
            input_binding=input_binding,
            original_binding=original_binding,
            pass_outputs=pass_outputs,
            history=history_bindings,
            feedback=fb_bindings,
            frame_count=frame_count,
            frame_time=time,
            params={
                k: (np.float32(v) if isinstance(v, (int, float, np.generic)) else v)
                for k, v in params.items()
            },
            device=source.device,
        )
        color = _run_pass(cp, ctx, sh)
        stored = framebuffer_store(
            color,
            float_framebuffer=cfg.float_framebuffer,
            srgb_framebuffer=cfg.srgb_framebuffer,
        )
        outputs_raw.append(stored)
        pass_outputs.append(
            TexBinding(stored, *filter_of_output(i), quantized=_stored_quant(i))
        )
        current = stored
        cur_quant = _stored_quant(i)

    final = current

    # History ring: the final pass output (at its own size,
    # ShaderEngine.cpp:1744-1756) quantized to RGBA8 like the copy into a
    # GL_RGBA/UNSIGNED_BYTE texture.
    new_history = history
    if history:
        hh, hw = history[0].shape[0], history[0].shape[1]
        if final.shape[0] != hh or final.shape[1] != hw:
            u, v = _grids(hw, hh)
            entry = sample2d(final, u, v, filter_linear=True)
        else:
            entry = final
        entry = framebuffer_store(entry, float_framebuffer=False, srgb_framebuffer=False)
        new_history = (entry,) + tuple(history[:-1])

    # Feedback ping-pong: this frame's outputs become next frame's
    # PassFeedback textures.
    new_feedback = {j: outputs_raw[j] for j in feedback}

    # Final window blit (OpenGLRenderer::renderTexture): stretch the last
    # pass output to the viewport with the FBO texture's LINEAR filter.
    final = final[..., :3]
    vw, vh = viewport
    if blit and (final.shape[0] != vh or final.shape[1] != vw):
        u, v = _grids(vw, vh)
        final = sample2d(final, u, v, filter_linear=True)

    return final, new_history, new_feedback


def _run_pass(cp, ctx: PassContext, sh: PassShapes):
    """One pass → [oh, ow, 4] color. A shader with a kernel-library entry
    (graph/kernels.py: crt-mattias, xbr-lv2, the ntsc 2-phase passes,
    nnedi3) takes that path when the entry finds
    the pass feasible; the evaluator is the general path and the
    semantic reference (the reference's engine.py:1196-1216; its
    phase-factored evaluation is not ported yet)."""
    from retrocapture_tpu_torch.graph.kernels import find_kernel

    hand = find_kernel(ctx.program.preset.passes[cp.index].shader_path)
    if hand is not None:
        out = hand(ctx, sh)
        if out is not None:
            return out
    return _eval_pass_on_grid(cp, ctx, sh)


def _quad_transform(v_globals, ow: int, oh: int):
    """Inverse rasterization map for a non-identity ``gl_Position``.

    Most corpus vertex shaders emit ``gl_Position = MVPMatrix *
    VertexCoord`` — a fullscreen quad, for which evaluating varyings
    directly on the output grid is exact.  A handful (lcd-shader,
    imgborder, cocktail-cabinet, hqx single-pass, braid-rewind) *scale*
    the clip position, shrinking the quad to a sub-region of the
    render target (the integer-prescale-with-borders trick).  The
    reference rasterizes that quad into a transparent-black-cleared FBO
    (ShaderEngine's per-pass glClear; see OpenGLRenderer FBO setup), so
    uncovered pixels are (0,0,0,0).

    The evaluator seeds the vertex stage on the output pixel grid and
    tracks clip position as an affine function of (col, row).  When the
    evaluated ``gl_Position`` differs from the identity quad, invert the
    affine map: for each *real* output pixel, find the seeded grid
    coordinate whose transformed clip position lands there, re-run the
    vertex stage on those coordinates, and mask pixels that fall
    outside the quad.  Returns ``((axx, axy, bx), (ayx, ayy, by))``
    with ``col' = axx*col + axy*row + bx`` (likewise row'), or None
    when gl_Position is the identity quad / not analyzable (the
    historical fullscreen assumption)."""
    from retrocapture_tpu_torch.frontend.values import affine_of

    gp = v_globals.get("gl_Position")
    if not isinstance(gp, V) or gp.type.shape != (4,):
        return None
    aff = affine_of(gp, 4)
    if aff is None:
        return None
    (ax, bx, cx), (ay, by, cy), _zt, (aw, bw, cw) = aff
    # Only w == 1 (no perspective) is invertible as a 2-D affine map.
    if aw != 0.0 or bw != 0.0 or abs(cw - 1.0) > 1e-9:
        return None
    import math

    def close(u, v):
        return math.isclose(u, v, rel_tol=1e-6, abs_tol=1e-9)

    if (
        close(ax, 2.0 / ow)
        and close(bx, 0.0)
        and close(cx, 1.0 / ow - 1.0)
        and close(ay, 0.0)
        and close(by, 2.0 / oh)
        and close(cy, 1.0 / oh - 1.0)
    ):
        return None  # identity fullscreen quad
    det = ax * by - bx * ay
    if abs(det) < 1e-12:
        return None
    # Seeded clip = A·(col,row) + c; target NDC of real pixel (col0,row0)
    # is ((2/ow)·col0 + 1/ow − 1, (2/oh)·row0 + 1/oh − 1).  Solve
    # A·(col',row') = q − c for the pre-image grid coordinate.
    gx, hx = 2.0 / ow, 1.0 / ow - 1.0 - cx
    gy, hy = 2.0 / oh, 1.0 / oh - 1.0 - cy
    return (
        (by * gx / det, -bx * gy / det, (by * hx - bx * hy) / det),
        (-ay * gx / det, ax * gy / det, (-ay * hx + ax * hy) / det),
    )



def _plane_setup_f32_pos(p0, p1, p2, a0v, a1v, a2v):
    """llvmpipe plane setup from arbitrary (snapped) screen-space
    triangle positions — the general form of _plane_setup_f32 used when
    ``gl_Position`` is a non-identity quad (integer-prescale-with-border
    vertex shaders scale the clip position; the rasterized quad then
    covers a sub- or super-region of the render target)."""
    f = np.float32
    x0, y0 = f(p0[0]), f(p0[1])
    x1, y1 = f(p1[0]), f(p1[1])
    x2, y2 = f(p2[0]), f(p2[1])
    a0v, a1v, a2v = f(a0v), f(a1v), f(a2v)
    dx01 = f(x0 - x1)
    dy01 = f(y0 - y1)
    dx20 = f(x2 - x0)
    dy20 = f(y2 - y0)
    area = f(f(dx01 * dy20) - f(dx20 * dy01))
    if area == 0.0:
        return None
    ooa = f(f(1.0) / area)
    da01 = f(a0v - a1v)
    da20 = f(a2v - a0v)
    dadx = f(f(da01 * f(dy20 * ooa)) - f(da20 * f(dy01 * ooa)))
    dady = f(f(da20 * f(dx01 * ooa)) - f(da01 * f(dx20 * ooa)))
    a0 = f(a0v - f(f(dadx * f(x0 - f(0.5))) + f(dady * f(y0 - f(0.5)))))
    return a0, dadx, dady


def _snap16(x):
    """lp_setup's 1/16-subpixel fixed-point vertex snapping."""
    return np.float32(np.round(np.float64(x) * 16.0) / 16.0)


def _quad_screen_corners(gp, ow: int, oh: int):
    """Screen-space (col, row) corners from concrete gl_Position corner
    values [[c00,c10],[c01,c11]] (vec4), via the GL viewport transform +
    1/16 snapping. Returns (corners dict, identity flag) or None when
    not an affine no-perspective quad."""
    arr = np.asarray(gp, np.float64)
    if arr.shape != (2, 2, 4):
        return None
    ws = arr[..., 3]
    if not np.allclose(ws, 1.0, rtol=0, atol=1e-9):
        return None
    sx = _snap16((arr[..., 0] * 0.5 + 0.5) * ow)
    sy = _snap16((arr[..., 1] * 0.5 + 0.5) * oh)
    ident = (
        np.array_equal(sx, np.array([[0.0, ow], [0.0, ow]], np.float32))
        and np.array_equal(sy, np.array([[0.0, 0.0], [oh, oh]], np.float32))
    )
    return (sx, sy), ident


def _plane_setup_f32(w: int, h: int, c10, c11, c01):
    """llvmpipe triangle-plane setup, bit-exact (probed 2026-08-17 over
    7 viewport sizes against the real-GL oracle with RGBA32F readback).

    The oracle draws the fullscreen quad as a TRIANGLE_STRIP whose second
    triangle is (v1, v3, v2) = ((w,0), (w,h), (0,h)) in screen pixels
    (gloracle.cpp:386-392, 558); Mesa's lp_setup computes each attribute
    plane as a0/dadx/dady in float32 with exactly this operation order,
    folding the half-pixel center into a0.  Per-pixel evaluation is then
    ``f32(f32(a0 + dadx*x) + dady*y)`` at INTEGER pixel coords, each
    step single-rounded (fma).  Reproducing these exact bits is what
    decides the knife-edge ``mod(vTexCoord, cell) > texel`` comparisons
    the handheld/lcd dot-matrix shaders build their grids from."""
    f = np.float32
    x0, y0, a0v = f(w), f(0.0), f(c10)
    x1, y1, a1v = f(w), f(h), f(c11)
    x2, y2, a2v = f(0.0), f(h), f(c01)
    dx01 = f(x0 - x1)
    dy01 = f(y0 - y1)
    dx20 = f(x2 - x0)
    dy20 = f(y2 - y0)
    area = f(f(dx01 * dy20) - f(dx20 * dy01))
    ooa = f(f(1.0) / area)
    da01 = f(a0v - a1v)
    da20 = f(a2v - a0v)
    dadx = f(f(da01 * f(dy20 * ooa)) - f(da20 * f(dy01 * ooa)))
    dady = f(f(da20 * f(dx01 * ooa)) - f(da01 * f(dx20 * ooa)))
    a0 = f(a0v - f(f(dadx * f(x0 - f(0.5))) + f(dady * f(y0 - f(0.5)))))
    return a0, dadx, dady


def _plane_component(a0, dadx, dady, ow: int, oh: int):
    """Per-pixel plane evaluation ``f32(f32(a0 + dadx*x) + dady*y)`` at
    integer pixel coords, as a CONCRETE numpy broadcast view.

    Concreteness is the point: the fragment evaluator then runs every
    varying-derived expression (floor/fract/clamp texel sharpening,
    scanline sin factors, ...) in numpy on the host, so coordinate math
    reaches the samplers as concrete per-axis vectors (eligible for the
    index-select taps), and row- or column-constant values reach the
    device as one row or column (values.smart_device)."""
    inner = (np.float64(dadx) * np.arange(ow, dtype=np.float64) + np.float64(a0)).astype(
        np.float32
    )
    if dady == 0.0:
        return np.broadcast_to(inner[None, :], (oh, ow))
    if dadx == 0.0:
        col = (np.float64(dady) * np.arange(oh, dtype=np.float64) + np.float64(a0)).astype(
            np.float32
        )
        return np.broadcast_to(col[:, None], (oh, ow))
    return (
        inner[None, :].astype(np.float64)
        + np.float64(dady) * np.arange(oh, dtype=np.float64)[:, None]
    ).astype(np.float32)


def _plane_varyings(cp, ctx: PassContext, ow: int, oh: int):
    """Rasterizer-exact varyings: evaluate the vertex stage at the four
    quad corners only (what GL hardware does), then rebuild each varying
    over the output grid with llvmpipe's plane equation in float32.

    This replaces the historical per-pixel vertex evaluation for two
    reasons of GL semantics:
    1. float32 rounding — interpolated values differ from per-pixel
       formula evaluation in ulps, and dot-matrix shaders branch on
       exact ties of those bits (handheld/lcd families);
    2. non-affine vertex math (cos/floor of TexCoord, etc.) must be
       computed at corners and linearly interpolated, not evaluated
       per-pixel.

    Returns {varying name -> V} for every float varying whose corner
    values are concrete, {} when the vertex stage can't be corner-run
    (tensor uniforms, vertex texture fetches...)."""
    f = np.float32
    tc = np.array(
        [[[0, 0, 0, 1], [1, 0, 0, 1]], [[0, 1, 0, 1], [1, 1, 0, 1]]], np.float32
    )
    vc = np.array(
        [[[-1, -1, 0, 1], [1, -1, 0, 1]], [[-1, 1, 0, 1], [1, 1, 0, 1]]], np.float32
    )
    t4 = GType("float", (4,))
    tex_v = V(tc, t4)
    vert_v = V(vc, t4)
    col_v = V(np.ones(4, np.float32), t4)
    ins = {
        "TexCoord": tex_v,
        "VertexCoord": vert_v,
        "Position": vert_v,
        "COLOR": col_v,
        "Color": col_v,
        "gl_Position": vert_v,
        "PrevTexCoord": tex_v,
    }
    for n in range(1, 7):
        ins[f"Prev{n}TexCoord"] = tex_v
    try:
        v_globals, _, _ = cp.vertex_eval.run(ctx, ins)
    except Exception:
        return {}, None
    from retrocapture_tpu_torch.frontend.values import is_concrete

    # Screen-space corner positions from gl_Position (viewport transform
    # + 1/16 vertex snapping): identity quads use the probed integer-
    # corner setup; scaled quads (integer-prescale-with-border vertex
    # shaders) interpolate across their actual rasterized rectangle and
    # come with a coverage mask (pixels outside are cleared black by the
    # per-pass glClear).
    gp = v_globals.get("gl_Position")
    if not isinstance(gp, V) or not is_concrete(gp.data):
        return {}, None
    try:
        gp_c = np.broadcast_to(np.asarray(gp.data, np.float32), (2, 2, 4))
    except ValueError:
        return {}, None
    qc = _quad_screen_corners(gp_c, ow, oh)
    if qc is None:
        return {}, None
    (qsx, qsy), identity_quad = qc
    cover = None
    if not identity_quad:
        xlo, xhi = float(qsx.min()), float(qsx.max())
        ylo, yhi = float(qsy.min()), float(qsy.max())
        covx = ((np.arange(ow, dtype=np.float64) + 0.5) >= xlo) & (
            (np.arange(ow, dtype=np.float64) + 0.5) < xhi
        )
        covy = ((np.arange(oh, dtype=np.float64) + 0.5) >= ylo) & (
            (np.arange(oh, dtype=np.float64) + 0.5) < yhi
        )
        cover = (covy, covx)

    out = {}
    for name in cp.vertex_eval.varying_names:
        cv = v_globals.get(name)
        if not isinstance(cv, V) or cv.type.base != "float":
            continue
        if not is_concrete(cv.data):
            continue
        comps = cv.type.shape[0] if cv.type.is_vector else 1
        try:
            arr = np.broadcast_to(
                np.asarray(cv.data, np.float32), (2, 2, comps) if cv.type.is_vector else (2, 2)
            )
        except ValueError:
            continue
        if not cv.type.is_vector:
            arr = arr[..., None]
        planes = []
        affs = []
        ok = True
        for k in range(comps):
            c00, c10, c01, c11 = arr[0, 0, k], arr[0, 1, k], arr[1, 0, k], arr[1, 1, k]
            if not np.all(np.isfinite([c00, c10, c01, c11])):
                ok = False
                break
            if identity_quad:
                plane = _plane_setup_f32(ow, oh, c10, c11, c01)
            else:
                plane = _plane_setup_f32_pos(
                    (qsx[0, 1], qsy[0, 1]),
                    (qsx[1, 1], qsy[1, 1]),
                    (qsx[1, 0], qsy[1, 0]),
                    c10,
                    c11,
                    c01,
                )
                if plane is None:
                    ok = False
                    break
            a0, dadx, dady = plane
            comp = _plane_component(a0, dadx, dady, ow, oh)
            # Non-planar f32 corners (genuinely bilinear varyings) render
            # as two triangle planes with a diagonal seam in GL; stitch
            # the first-triangle plane over its half.
            resid = (float(c11) - float(c10)) - (float(c01) - float(c00))
            scale = max(abs(float(c)) for c in (c00, c10, c01, c11)) or 1.0
            if abs(resid) > 64.0 * np.spacing(np.float32(scale)) and identity_quad:
                b0, bdx, bdy = _plane_setup_t012_f32(ow, oh, c00, c10, c01)
                compA = _plane_component(b0, bdx, bdy, ow, oh)
                xs = np.arange(ow, dtype=np.float32)[None, :] + np.float32(0.5)
                ys = np.arange(oh, dtype=np.float32)[:, None] + np.float32(0.5)
                lower = xs * np.float32(oh) + ys * np.float32(ow) < np.float32(ow * oh)
                comp = np.where(lower, compA, comp)
                affs = None
            if affs is not None:
                affs.append((float(dadx), float(dady), float(a0)))
            planes.append(comp)
        if not ok:
            continue
        data = np.stack(planes, axis=-1) if cv.type.is_vector else planes[0]
        out[name] = V(
            data,
            cv.type,
            affine=tuple(affs) if affs is not None and cv.type.is_vector else None,
        )
    return out, cover


def _plane_setup_t012_f32(w: int, h: int, c00, c10, c01):
    """Plane setup for the strip's FIRST triangle (v0,v1,v2) =
    ((0,0),(w,0),(0,h)) — used only to stitch non-planar (bilinear)
    varyings across the quad diagonal."""
    f = np.float32
    x0, y0, a0v = f(0.0), f(0.0), f(c00)
    x1, y1, a1v = f(w), f(0.0), f(c10)
    x2, y2, a2v = f(0.0), f(h), f(c01)
    dx01 = f(x0 - x1)
    dy01 = f(y0 - y1)
    dx20 = f(x2 - x0)
    dy20 = f(y2 - y0)
    area = f(f(dx01 * dy20) - f(dx20 * dy01))
    ooa = f(f(1.0) / area)
    da01 = f(a0v - a1v)
    da20 = f(a2v - a0v)
    dadx = f(f(da01 * f(dy20 * ooa)) - f(da20 * f(dy01 * ooa)))
    dady = f(f(da20 * f(dx01 * ooa)) - f(da01 * f(dx20 * ooa)))
    a0 = f(a0v - f(f(dadx * f(x0 - f(0.5))) + f(dady * f(y0 - f(0.5)))))
    return a0, dadx, dady


def _eval_pass_on_grid(cp, ctx: PassContext, sh: PassShapes):
    """One pass: vertex stage over the output grid → varyings; fragment
    stage → [oh, ow, 4] color. The pixel grids are seeded as device
    tensors carrying affine metadata (values.py), so separable taps are
    proven separable; rasterizer-exact varyings replace them where the
    vertex stage can be evaluated at the quad corners."""
    ow, oh = sh.out_w, sh.out_h
    dev = ctx.device
    xg = torch.arange(ow, dtype=torch.float32, device=dev)[None, :].expand(oh, ow)  # column
    yg = torch.arange(oh, dtype=torch.float32, device=dev)[:, None].expand(oh, ow)  # row
    zeros = torch.zeros((oh, ow), dtype=torch.float32, device=dev)
    ones = torch.ones((oh, ow), dtype=torch.float32, device=dev)
    ugrid = (xg + 0.5) * np.float32(1.0 / ow)
    vgrid = (yg + 0.5) * np.float32(1.0 / oh)

    ua = (1.0 / ow, 0.0, 0.5 / ow)
    va = (0.0, 1.0 / oh, 0.5 / oh)
    c0 = (0.0, 0.0, 0.0)
    c1 = (0.0, 0.0, 1.0)

    def vec4(a, b, c, d, aff):
        comps = torch.broadcast_tensors(a, b, c, d)
        return V(torch.stack(comps, dim=-1), GType("float", (4,)), affine=aff)

    tex_coord = vec4(ugrid, vgrid, zeros, ones, (ua, va, c0, c1))
    vertex_coord = vec4(
        ugrid * 2.0 - 1.0,
        vgrid * 2.0 - 1.0,
        zeros,
        ones,
        (
            (2.0 / ow, 0.0, 1.0 / ow - 1.0),
            (0.0, 2.0 / oh, 1.0 / oh - 1.0),
            c0,
            c1,
        ),
    )
    color_attr = V(np.ones(4, np.float32), GType("float", (4,)))

    def attr_inputs(tc, vc):
        # Attribute slot aliases per the reference's glBindAttribLocation
        # table (ShaderEngine.cpp:707-719): Position shares slot 0 with
        # VertexCoord; the motion-blur Prev*TexCoord attributes share
        # slot 1 with TexCoord (all frames use the same quad coords).
        ins = {
            "TexCoord": tc,
            "VertexCoord": vc,
            "Position": vc,
            "COLOR": color_attr,
            "Color": color_attr,
            "gl_Position": vc,
            "PrevTexCoord": tc,
        }
        for n in range(1, 7):
            ins[f"Prev{n}TexCoord"] = tc
        return ins

    v_inputs = attr_inputs(tex_coord, vertex_coord)
    v_globals, _, _ = cp.vertex_eval.run(ctx, v_inputs)

    cover = None
    # Rasterizer-exact varyings: corner-evaluate the vertex stage and
    # rebuild each varying with llvmpipe's float32 plane equations.
    wp = walk_program()
    kept = wp is not None and cp.vertex_static
    if kept and ("planes", cp.index) in wp.tables:
        planes, plane_cover = wp.tables[("planes", cp.index)]
    else:
        try:
            # Kept with the program where the vertex stage reads no frame
            # state: its corners then depend on the key alone (the planes
            # keep concrete varyings only, never a traced parameter's).
            with unrecorded() if kept else contextlib.nullcontext():
                planes, plane_cover = _plane_varyings(cp, ctx, ow, oh)
        except Exception:  # noqa: BLE001 - corner evaluation is best effort
            planes, plane_cover = {}, None
        if kept:
            wp.tables[("planes", cp.index)] = (planes, plane_cover)
    if planes and plane_cover is not None:
        # A transformed quad demands every consumed varying come from
        # the planes; a leftover identity-grid varying would be wrong.
        for name in cp.vertex_eval.varying_names:
            gv = v_globals.get(name)
            if isinstance(gv, V) and gv.type.base == "float" and name not in planes:
                planes, plane_cover = {}, None
                break
    if planes and plane_cover is not None:
        covy, covx = plane_cover
        cover = upload(covy, dev)[:, None] & upload(covx, dev)[None, :]
    quad = None if planes else _quad_transform(v_globals, ow, oh)
    if quad is not None:
        (axx, axy, bx0), (ayx, ayy, by0) = quad
        xg2 = axx * xg + axy * yg + np.float32(bx0)
        yg2 = ayx * xg + ayy * yg + np.float32(by0)
        # Quad param covers col ∈ [-0.5, ow-0.5); fragments whose
        # pre-image falls outside are never rasterized → cleared black.
        cover = (xg2 >= -0.5) & (xg2 < ow - 0.5) & (yg2 >= -0.5) & (yg2 < oh - 0.5)

        def _comp(t):
            a, b, c = t
            return (a * axx + b * ayx, a * axy + b * ayy, a * bx0 + b * by0 + c)

        ugrid2 = (xg2 + 0.5) * np.float32(1.0 / ow)
        vgrid2 = (yg2 + 0.5) * np.float32(1.0 / oh)
        tex_coord = vec4(ugrid2, vgrid2, zeros, ones, (_comp(ua), _comp(va), c0, c1))
        vertex_coord = vec4(
            ugrid2 * 2.0 - 1.0,
            vgrid2 * 2.0 - 1.0,
            zeros,
            ones,
            (
                _comp((2.0 / ow, 0.0, 1.0 / ow - 1.0)),
                _comp((0.0, 2.0 / oh, 1.0 / oh - 1.0)),
                c0,
                c1,
            ),
        )
        v_inputs = attr_inputs(tex_coord, vertex_coord)
        v_globals, _, _ = cp.vertex_eval.run(ctx, v_inputs)

    f_inputs = {}
    for name in cp.vertex_eval.varying_names:
        if name in v_globals:
            f_inputs[name] = v_globals[name]
    f_inputs.update({n: pv for n, pv in planes.items() if n in f_inputs})
    if quad is None:
        # Concrete gl_FragCoord: per-axis numpy broadcast views, so
        # fragCoord-derived masks (comb patterns, interlace mod) fold on
        # the host like the plane varyings do.
        xc = np.broadcast_to(
            (np.arange(ow, dtype=np.float32) + np.float32(0.5))[None, :], (oh, ow)
        )
        yc = np.broadcast_to(
            (np.arange(oh, dtype=np.float32) + np.float32(0.5))[:, None], (oh, ow)
        )
        fc_data = np.stack(
            [xc, yc, np.zeros((oh, ow), np.float32), np.ones((oh, ow), np.float32)],
            axis=-1,
        )
        frag_coord = V(
            fc_data,
            GType("float", (4,)),
            affine=((1.0, 0.0, 0.5), (0.0, 1.0, 0.5), c0, c1),
        )
    else:
        frag_coord = vec4(
            xg + 0.5,
            yg + 0.5,
            zeros,
            ones,
            ((1.0, 0.0, 0.5), (0.0, 1.0, 0.5), c0, c1),
        )
    f_inputs["gl_FragCoord"] = frag_coord

    _, out_color, discard_mask = cp.fragment_eval.run(ctx, f_inputs)
    if out_color is None:
        raise UnsupportedShaderError(f"pass {cp.index}: no output color written")
    data = smart_device(out_color.data, dev)
    if discard_mask is not None and discard_mask is not False:
        if discard_mask is True:
            data = torch.zeros_like(data)
        else:
            data = torch.where(smart_device(discard_mask, dev)[..., None], 0.0, data)
    if cover is not None:
        data = torch.where(cover[..., None], data, 0.0)
    return data.expand(oh, ow, 4)
