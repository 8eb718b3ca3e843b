from .model import QwenImage
from .transformer import QwenImageConfig, QwenImageTransformer

__all__ = ["QwenImage", "QwenImageConfig", "QwenImageTransformer"]
