from .model import SDXL

__all__ = ["SDXL"]
