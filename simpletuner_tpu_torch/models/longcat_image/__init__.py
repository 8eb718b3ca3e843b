from .model import PROMPT_PREFIX, PROMPT_SUFFIX, LongcatImage

__all__ = ["LongcatImage", "PROMPT_PREFIX", "PROMPT_SUFFIX"]
