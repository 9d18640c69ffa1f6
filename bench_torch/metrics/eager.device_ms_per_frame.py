"""eager.device_ms_per_frame: device time a frame of the kernels that
PyTorch and its libraries build (the eager passes: epilogues, front
sections, the evaluator's operators, the quantize), by origin: a kernel
whose name is PyTorch's (``at::``, ``c10::``), CUB's or cuBLAS/CUTLASS's.
The port's own kernels (``csrc/*.cu``) never carry those names, so a hand
kernel that a later change adds counts as the port's, not as eager."""

LIBRARY = ("at::", "c10::", "cub::", "cutlass", "cublas", "xmma", "gemm")


def read(r):
    if not r.closed_loop or r.trace is None or not r.window.frames:
        return None
    eager = sum(d for name, _, d in r.trace.records if any(p in name for p in LIBRARY))
    return eager / r.window.frames * 1e3
