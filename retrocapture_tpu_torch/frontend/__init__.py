from retrocapture_tpu_torch.frontend.cpp import Preprocessor, PragmaParameter, preprocess

__all__ = ["Preprocessor", "PragmaParameter", "preprocess"]
