from .model import Cosmos2Image

__all__ = ["Cosmos2Image"]
