from .model import Sana
from .transformer import SanaConfig, SanaTransformer, relu_linear_attention

__all__ = ["Sana", "SanaConfig", "SanaTransformer", "relu_linear_attention"]
