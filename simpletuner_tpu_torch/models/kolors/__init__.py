from .model import Kolors

__all__ = ["Kolors"]
