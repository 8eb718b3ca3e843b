from .model import ZlabI1
from .transformer import ZlabI1Config, ZlabI1Transformer

__all__ = ["ZlabI1", "ZlabI1Config", "ZlabI1Transformer"]
