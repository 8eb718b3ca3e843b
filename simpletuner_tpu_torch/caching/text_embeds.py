"""Text-embedding cache, read and write paths.

The torch port's copy of ``simpletuner_tpu/caching/text_embeds.py``, cut to
what the port uses: the reference's on-disk layout (reference:
helpers/caching/text_embeds.py:138-149, ``md5(caption) + "-" + model_type +
".pt"`` through the backend's ``.pt`` format), so a cache written by the JAX
package renders here.  Encoding prompts is not ported (no text encoders yet):
a prompt must already be in the cache.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Optional

from ..data.backends.base import BaseDataBackend


class TextEmbeddingCache:
    def __init__(self, id: str, data_backend: BaseDataBackend, cache_dir: str, model_type: str, disabled: bool = False):
        self.id = id
        self.data_backend = data_backend
        self.cache_dir = cache_dir
        self.model_type = model_type
        self.disabled = disabled

    def create_hash(self, caption: Optional[str]) -> str:
        normalized = "" if caption is None else str(caption)
        digest = hashlib.md5(normalized.encode()).hexdigest()
        return f"{digest}-{self.model_type}"

    def cache_path(self, caption: Optional[str]) -> str:
        return os.path.join(self.cache_dir, self.create_hash(caption) + ".pt")

    def exists(self, caption: Optional[str]) -> bool:
        return self.data_backend.exists(self.cache_path(caption))

    def load(self, caption: Optional[str]) -> Any:
        return self.data_backend.torch_load(self.cache_path(caption))

    def save(self, caption: Optional[str], embeds: Any) -> None:
        if self.disabled:
            return
        self.data_backend.torch_save(embeds, self.cache_path(caption))
