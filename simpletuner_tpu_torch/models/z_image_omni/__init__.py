from .model import ZImageOmni
from .transformer import ZImageOmniConfig, ZImageOmniTransformer

__all__ = ["ZImageOmni", "ZImageOmniConfig", "ZImageOmniTransformer"]
