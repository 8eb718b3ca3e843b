from .model import Kandinsky5Image, Kandinsky5Video
from .transformer import Kandinsky5Config, Kandinsky5Transformer

__all__ = ["Kandinsky5Config", "Kandinsky5Image", "Kandinsky5Transformer", "Kandinsky5Video"]
