"""Text-embedding cache.

The torch port's copy of ``simpletuner_tpu/caching/text_embeds.py``: the
reference's on-disk layout (reference: helpers/caching/text_embeds.py:138-149,
``md5(caption) + "-" + model_type + ".pt"`` through the backend's ``.pt``
format), so a cache written by either package loads in the other, and the
encode path: ``compute_embeddings_for_prompts`` deduplicates prompts, splits
them across processes like the reference's rank split (:546), encodes the
missing ones in batches of ``batch_size`` through ``encode_fn`` and writes
them from a thread pool; ``get`` encodes on demand.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..data.backends.base import BaseDataBackend


class TextEmbeddingCache:
    def __init__(
        self,
        id: str,
        data_backend: BaseDataBackend,
        cache_dir: str,
        model_type: str,
        encode_fn: Optional[Callable[[Sequence[str]], List[Dict[str, np.ndarray]]]] = None,
        batch_size: int = 4,
        disabled: bool = False,
        max_workers: int = 8,
    ):
        self.id = id
        self.data_backend = data_backend
        self.cache_dir = cache_dir
        self.model_type = model_type
        self.encode_fn = encode_fn
        self.batch_size = batch_size
        self.disabled = disabled
        self.max_workers = max_workers

    # ---- hashing (reference text_embeds.py:125-149) ---------------------------------------
    def create_hash(self, caption: Optional[str]) -> str:
        normalized = "" if caption is None else str(caption)
        digest = hashlib.md5(normalized.encode()).hexdigest()
        return f"{digest}-{self.model_type}"

    def cache_path(self, caption: Optional[str]) -> str:
        return os.path.join(self.cache_dir, self.create_hash(caption) + ".pt")

    # ---- IO ---------------------------------------------------------------------------------
    def exists(self, caption: Optional[str]) -> bool:
        return self.data_backend.exists(self.cache_path(caption))

    def load(self, caption: Optional[str]) -> Any:
        return self.data_backend.torch_load(self.cache_path(caption))

    def save(self, caption: Optional[str], embeds: Any) -> None:
        if self.disabled:
            return
        self.data_backend.torch_save(embeds, self.cache_path(caption))

    # ---- batch compute ---------------------------------------------------------------------
    def compute_embeddings_for_prompts(
        self,
        prompts: Sequence[Optional[str]],
        return_embeds: bool = False,
        process_index: int = 0,
        num_processes: int = 1,
    ) -> Optional[List[Any]]:
        """Encode and cache the prompts that are not cached yet."""
        unique = sorted({("" if p is None else str(p)) for p in prompts})
        shard = unique[process_index::num_processes]
        missing = [p for p in shard if not self.exists(p)]
        if missing and self.encode_fn is None:
            raise RuntimeError(f"text cache {self.id}: {len(missing)} uncached prompts but no encoder attached")
        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            futures = []
            for start in range(0, len(missing), self.batch_size):
                chunk = missing[start: start + self.batch_size]
                embeds = self.encode_fn(chunk)
                for caption, embed in zip(chunk, embeds):
                    futures.append(pool.submit(self.save, caption, embed))
            for future in futures:
                future.result()
        if return_embeds:
            return [self.load(p) for p in prompts]
        return None

    def get(self, caption: Optional[str]) -> Any:
        """Fetch, encoding on demand when an encoder is attached."""
        if self.exists(caption):
            return self.load(caption)
        if self.encode_fn is None:
            raise KeyError(f"no cached embedding for caption hash {self.create_hash(caption)}")
        embed = self.encode_fn([caption or ""])[0]
        if not self.disabled:
            self.save(caption, embed)
        return embed
