from .model import MageFlow, ZImage

__all__ = ["MageFlow", "ZImage"]
