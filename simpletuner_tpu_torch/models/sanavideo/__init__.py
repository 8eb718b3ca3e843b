from .model import SanaVideo
from .transformer import SanaVideoConfig, SanaVideoTransformer

__all__ = ["SanaVideo", "SanaVideoConfig", "SanaVideoTransformer"]
