from .model import LongcatVideo
from .transformer import LongCatVideoConfig, LongCatVideoTransformer

__all__ = ["LongcatVideo", "LongCatVideoConfig", "LongCatVideoTransformer"]
