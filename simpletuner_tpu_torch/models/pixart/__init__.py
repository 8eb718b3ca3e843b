from .model import PixartSigma
from .transformer import PixartConfig, PixartTransformer, sincos_pos_embed_2d

__all__ = ["PixartConfig", "PixartSigma", "PixartTransformer", "sincos_pos_embed_2d"]
