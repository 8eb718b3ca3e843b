from .model import Flux2
from .transformer import Flux2Config, Flux2Transformer

__all__ = ["Flux2", "Flux2Config", "Flux2Transformer"]
