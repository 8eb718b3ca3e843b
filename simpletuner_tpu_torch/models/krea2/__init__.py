from .model import Krea2
from .transformer import Krea2Config, Krea2Transformer

__all__ = ["Krea2", "Krea2Config", "Krea2Transformer"]
