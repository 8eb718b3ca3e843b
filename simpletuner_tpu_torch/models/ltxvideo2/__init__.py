from .model import LTXVideo2
from .transformer import LTX2Config, LTX2Transformer

__all__ = ["LTX2Config", "LTX2Transformer", "LTXVideo2"]
