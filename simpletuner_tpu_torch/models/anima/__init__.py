from .model import Anima
from .transformer import AnimaConfig, AnimaTransformer

__all__ = ["Anima", "AnimaConfig", "AnimaTransformer"]
