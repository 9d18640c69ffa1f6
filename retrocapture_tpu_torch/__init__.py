"""retrocapture_tpu_torch — the retro-shader video pipeline in PyTorch.

The PyTorch/CUDA port of ``retrocapture_tpu``: RetroArch ``.glslp``
presets are parsed, their GLSL passes are evaluated over whole frame
tensors on a named device, and multi-pass chains with history and
PassFeedback state run over batched ``[B, H, W, 3]`` frames. The
kernels of the main path are hand-written CUDA for Hopper
(``csrc/``), each with a plain torch version that the CPU uses.

Public API (the JAX package's, plus an explicit device):

    from retrocapture_tpu_torch import Engine
    eng = Engine(viewport=(1920, 1080), device="cuda")
    eng.load_preset("assets/presets/feedback-ghost.glslp")
    eng.set_input_format("nv12")
    out = eng.apply(nv12_batch, output="u8")   # u8 [B, 1080, 1920, 3]
"""

from retrocapture_tpu_torch.policy import apply_policy

apply_policy()

from retrocapture_tpu_torch.presets.glslp import PassConfig, Preset, TextureConfig  # noqa: E402
from retrocapture_tpu_torch.runtime.engine import Engine  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Engine",
    "Preset",
    "PassConfig",
    "TextureConfig",
    "__version__",
]
