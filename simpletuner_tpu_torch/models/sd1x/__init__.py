from .model import SD1x, SD2x

__all__ = ["SD1x", "SD2x"]
