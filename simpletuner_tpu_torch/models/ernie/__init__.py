from .model import Ernie
from .transformer import ErnieConfig, ErnieTransformer

__all__ = ["Ernie", "ErnieConfig", "ErnieTransformer"]
