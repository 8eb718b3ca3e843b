from .model import HunyuanVideo
from .transformer import HunyuanVideo15Config, HunyuanVideo15Transformer

__all__ = ["HunyuanVideo", "HunyuanVideo15Config", "HunyuanVideo15Transformer"]
