from .model import OmniGen
from .transformer import OmniGenConfig, OmniGenTransformer

__all__ = ["OmniGen", "OmniGenConfig", "OmniGenTransformer"]
