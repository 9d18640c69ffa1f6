from retrocapture_tpu_torch.presets.glslp import Preset, PassConfig, TextureConfig

__all__ = ["Preset", "PassConfig", "TextureConfig"]
