from .transformer import Cosmos1Config, Cosmos1Transformer

__all__ = ["Cosmos1Config", "Cosmos1Transformer"]
