from .model import Cosmos3
from .transformer import Cosmos3Config, Cosmos3OmniTransformer

__all__ = ["Cosmos3", "Cosmos3Config", "Cosmos3OmniTransformer"]
