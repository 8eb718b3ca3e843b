from .model import HiDream
from .transformer import HiDreamConfig, HiDreamTransformer

__all__ = ["HiDream", "HiDreamConfig", "HiDreamTransformer"]
