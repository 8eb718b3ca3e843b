from .model import BooguImage, WanS2V

__all__ = ["BooguImage", "WanS2V"]
