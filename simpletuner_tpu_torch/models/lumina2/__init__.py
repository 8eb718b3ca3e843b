from .model import Lumina2
from .transformer import Lumina2Config, Lumina2Transformer

__all__ = ["Lumina2", "Lumina2Config", "Lumina2Transformer"]
