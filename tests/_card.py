"""Recorders of what the port's kernels do on the card, for the card tests
(tests/test_torch_cuda.py) and the kernel-timing tool
(tools/torch_kernel_table.py).

Each recorder wraps a module attribute for the duration of a ``with``
block and restores it after; none imports a CUDA-only module, so this
file is importable on a machine without a card.
"""

import contextlib
import importlib
import sys
from pathlib import Path

import torch

from retrocapture_tpu_torch.ops.cuda import blur_groups as bg
from retrocapture_tpu_torch.ops.cuda import fma as fm
from retrocapture_tpu_torch.ops.cuda import mattias_epilogue as me
from retrocapture_tpu_torch.ops.cuda import mirrors as mr
from retrocapture_tpu_torch.ops.cuda import nnedi3 as nn
from retrocapture_tpu_torch.ops.cuda import warp_sample as ws
from retrocapture_tpu_torch.ops.cuda import xbr_epilogue as xe
from retrocapture_tpu_torch.ops.cuda import xbr_front as xf

BENCH = Path(__file__).resolve().parents[1] / "bench_torch"

# The wrappers' launch counters, by kernel name: (module under
# retrocapture_tpu_torch.ops.cuda, counter, a part of the kernel's
# __global__ function name as torch.profiler reports it).
COUNTERS = {
    "resample_u8": ("resample", "LAUNCHES", "resample_u8_kernel"),
    "resample_xphase": ("resample", "XPHASE_LAUNCHES", "resample_xphase_kernel"),
    "warp_sample": ("warp_sample", "LAUNCHES", "warp_sample_kernel"),
    "blur_groups": ("blur_groups", "LAUNCHES", "blur_groups_kernel"),
    "xbr_epilogue": ("xbr_epilogue", "LAUNCHES", "xbr_epilogue_kernel"),
    "xbr_front": ("xbr_front", "LAUNCHES", "xbr_front_kernel"),
    "mattias_epilogue": ("mattias_epilogue", "LAUNCHES", "mattias_epilogue_kernel"),
    "nnedi3": ("nnedi3", "LAUNCHES", "nnedi3_kernel"),
    "mirrors": ("mirrors", "LAUNCHES", "mirror_kernel"),
    "fma": ("fma", "LAUNCHES", "::fma_"),
}


# The operators whose launches a walk records, by kernel: (module, operator,
# its plain version on the operator's arguments).
RECORDED = {
    "warp_sample": (ws, "_warp_sample_op",
                    lambda tex, u, v, lin, mode: ws.warp_sample_plain(tex, u, v, filter_linear=lin, wrap_mode=mode)),
    "blur_groups": (bg, "_blur_groups_op",
                    lambda tex, u, v, params, chan, channels: bg._plain(tex, u, v, params, channels)),
    "xbr_front": (xf, "_xbr_front_op", lambda *a: xf.xbr_front_plain(a[0], a[1], a[2:7], *a[7:])),
    "xbr_epilogue": (xe, "_xbr_epilogue_op", lambda S, bx, fpx, fpy, *_: torch.cat(
        [xe.xbr_epilogue_plain(S[i:i + 8], bx, fpx, fpy) for i in range(0, S.shape[0], 8)])),
    "mattias_epilogue": (me, "_mattias_epilogue_op", me.mattias_epilogue_plain),
    "nnedi3": (nn, "_nnedi3_op", nn.nnedi3_plain),
    "mirrors": (mr, "_mirror_op", mr.mirror_plain),
}


def _ops_module(name):
    return importlib.import_module(f"retrocapture_tpu_torch.ops.cuda.{name}")


def counts() -> dict:
    """Each kernel's launch calls so far (a walked frame's and a
    capture's; a graph's replay makes none)."""
    return {k: getattr(_ops_module(mod), attr) for k, (mod, attr, _) in COUNTERS.items()}


def since(before: dict) -> dict:
    """The launch calls made since ``before`` (``counts()``), by kernel."""
    return {k: n - before[k] for k, n in counts().items()}


def kernel_runs(fn, want=None) -> dict:
    """How often the device ran each kernel in one call of ``fn``, inside a
    CUDA graph or not: its records in a window of the benchmark's profiler
    (bench_torch/harness/trace.py). A window was seen to lose a few of a
    graph's kernel records, and to come back with none, and never to add
    one: the call is profiled again while the counts differ from ``want``
    (every window but the first when ``want`` is None), ``PROFILE_TRIES``
    windows in all, and each kernel keeps its largest count."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from harness import trace

    runs = dict.fromkeys(COUNTERS, 0)
    for _ in range(trace.PROFILE_TRIES):
        prof = trace.Profiler()
        torch.cuda.synchronize()
        prof.start()
        prof.open()
        fn()
        torch.cuda.synchronize()
        prof.close()
        window = prof.trace()
        if window is not None:
            runs = {k: max(n, len(window.kernel_s(COUNTERS[k][2]))) for k, n in runs.items()}
            if want is None or runs == want:
                break
    return runs


def _batched(args) -> bool:
    return any(isinstance(a, torch.Tensor) and torch._C._functorch.is_batchedtensor(a) for a in args)


@contextlib.contextmanager
def launched(module, op):
    """Record the arguments of every launch of the operator ``module.op``
    (it still runs) for the duration of a block: the calls its batching
    rule makes with the whole batch, not the one-frame calls that
    ``torch.func.vmap`` hands it inside a batched walk. Wrap the module's
    operator, not its public wrapper."""
    orig = getattr(module, op)
    calls = []

    def rec(*args):
        if not _batched(args):
            calls.append(args)
        return orig(*args)

    setattr(module, op, rec)
    try:
        yield calls
    finally:
        setattr(module, op, orig)


@contextlib.contextmanager
def fma_forms():
    """Record each distinct operand form of the launches of ``rctpu::fma``
    in a block (both of its routes pass through ``fma._fma_call``):
    {(each operand's shape and strides, mode): [launches, the first
    launch's arguments]}."""
    orig = fm._fma_call
    forms = {}

    def rec(*args):
        if not _batched(args):
            key = tuple(None if x is None else (tuple(x.shape), x.stride()) for x in args[:3]) + (args[6],)
            forms.setdefault(key, [0, args])[0] += 1
        return orig(*args)

    fm._fma_call = rec
    try:
        yield forms
    finally:
        fm._fma_call = orig


@contextlib.contextmanager
def _plain_calls(names, skip=lambda frame: False):
    """Record the calls of ``policy``'s functions ``names`` with a CUDA
    tensor among their arguments, wherever a module of the port holds
    them, but for callers ``skip`` accepts: the function's name and its
    caller, one entry a call."""
    from retrocapture_tpu_torch import policy

    calls = []
    originals = {n: getattr(policy, n) for n in names}

    def counting(name, fn):
        def f(*args, **kwargs):
            caller = sys._getframe(1)
            if any(isinstance(x, torch.Tensor) and x.device.type == "cuda" for x in args) and not skip(caller):
                calls.append(f"{name} from {caller.f_code.co_filename}:{caller.f_lineno} {caller.f_code.co_name}")
            return fn(*args, **kwargs)

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


def plain_mirror_calls():
    """The mirrors' plain versions (``policy.sinf32``, ``logf32``,
    ``log2f32``, ``expf32``) called on a CUDA tensor in a block. On the
    card the operator ``rctpu::mirror`` runs the kernel and never a plain
    version, so every such call is a call site that bypasses the kernel."""
    return _plain_calls(("sinf32", "logf32", "log2f32", "expf32"))


def plain_fma_calls():
    """``policy.fma32`` / ``fmaf32`` called with a CUDA operand in a block,
    but inside the two kernels' plain versions that keep policy's formula
    (the xbr epilogue's plain tail and ``warp_sample_plain``). On the card
    every call site of the main paths goes through ``rctpu::fma``, so
    every such call is a call site that bypasses its kernel."""
    plain_tail = "retrocapture_tpu_torch.ops.cuda.xbr_epilogue"

    def in_plain_version(frame):
        if frame.f_globals.get("__name__") == plain_tail:
            return True
        while frame is not None and frame.f_code is not ws.warp_sample_plain.__code__:
            frame = frame.f_back
        return frame is not None

    return _plain_calls(("fma32", "fmaf32"), in_plain_version)

