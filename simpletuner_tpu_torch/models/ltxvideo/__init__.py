from .model import LTXVideo
from .transformer import LTXBlock, LTXConfig, LTXTransformer, ltx_rope

__all__ = ["LTXBlock", "LTXConfig", "LTXTransformer", "LTXVideo", "ltx_rope"]
