from .model import BooguImage

__all__ = ["BooguImage"]
