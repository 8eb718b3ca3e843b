from .model import Ideogram
from .transformer import IdeogramConfig, IdeogramTransformer

__all__ = ["Ideogram", "IdeogramConfig", "IdeogramTransformer"]
