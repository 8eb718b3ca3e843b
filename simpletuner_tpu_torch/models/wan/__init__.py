from .model import Wan
from .transformer import WanBlock, WanConfig, WanTransformer

__all__ = ["Wan", "WanBlock", "WanConfig", "WanTransformer"]
