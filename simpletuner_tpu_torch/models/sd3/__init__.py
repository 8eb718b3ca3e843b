from .model import SD3
from .transformer import MMDiTBlock, SD3Config, SD3Transformer, posemb_2d_sincos
