from .model import Chroma
from .transformer import ChromaConfig, ChromaTransformer, chroma_input_vec

__all__ = ["Chroma", "ChromaConfig", "ChromaTransformer", "chroma_input_vec"]
