"""MultiAspectSampler — stateful, resumable bucket-batch sampler.

Reference: helpers/multiaspect/sampler.py:28 (bucket cursor, seen-image
exhaustion, bucket switching, save/load state at :119/:173, batch yield :977).
Deterministic given (seed, epoch); state round-trips through JSON for
checkpoint/resume, and multi-host sharding happens upstream via
``MetadataBackend.split_buckets_between_processes``.

The torch port's own copy of ``simpletuner_tpu/data/sampler.py``.
"""

from __future__ import annotations

import json
import random
from typing import Any, Dict, Iterator, List, Optional, Sequence

from .metadata import MetadataBackend


class MultiAspectSampler:
    def __init__(
        self,
        id: str,
        metadata_backend: MetadataBackend,
        batch_size: int,
        seed: int = 42,
        drop_last: bool = True,
        repeats: int = 0,
    ):
        self.id = id
        self.metadata_backend = metadata_backend
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.repeats = repeats
        self.current_epoch = 0
        self._seen: set = set()
        self._bucket_cursors: Dict[str, int] = {}
        self._epoch_order: Dict[str, List[str]] = {}
        self._current_bucket: Optional[str] = None
        self._draws = 0  # bucket-pick counter; part of resume state

    # ---- state (checkpoint/resume) ---------------------------------------------------------
    def save_state(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "current_epoch": self.current_epoch,
            "seen": sorted(self._seen),
            "bucket_cursors": dict(self._bucket_cursors),
            "current_bucket": self._current_bucket,
            "draws": self._draws,
            "seed": self.seed,
            "batch_size": self.batch_size,
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        if state.get("batch_size") not in (None, self.batch_size):
            # schedule change: restart epoch like the reference's
            # _saved_schedule_is_restorable guard (sampler.py:138)
            return
        self.current_epoch = state.get("current_epoch", 0)
        self._seen = set(state.get("seen", []))
        self._bucket_cursors = dict(state.get("bucket_cursors", {}))
        self._current_bucket = state.get("current_bucket")
        self._draws = state.get("draws", 0)
        self._shuffle_epoch()

    def state_json(self) -> str:
        return json.dumps(self.save_state())

    # ---- epoch machinery -----------------------------------------------------------------
    def _rng(self) -> random.Random:
        return random.Random((self.seed, self.current_epoch).__hash__())

    def _shuffle_epoch(self) -> None:
        rng = self._rng()
        self._epoch_order = {}
        for key in self.metadata_backend.bucket_keys():
            files = list(self.metadata_backend.aspect_ratio_bucket_indices[key])
            files = files * (1 + max(self.repeats, 0))
            rng.shuffle(files)
            self._epoch_order[key] = files

    def _start_epoch(self) -> None:
        self._seen.clear()
        self._bucket_cursors = {}
        self._current_bucket = None
        self._draws = 0
        self._shuffle_epoch()

    def _exhausted(self, key: str) -> bool:
        return self._bucket_cursors.get(key, 0) + self.batch_size > len(self._epoch_order.get(key, []))

    def _pick_bucket(self) -> Optional[str]:
        available = sorted(k for k in self._epoch_order if not self._exhausted(k))
        if not available:
            return None
        # deterministic pick keyed on (seed, epoch, draw counter) so save/load
        # resumes the exact sequence regardless of how far iteration progressed
        rng = random.Random((self.seed, self.current_epoch, self._draws).__hash__())
        self._draws += 1
        weights = [len(self._epoch_order[k]) for k in available]
        return rng.choices(available, weights=weights, k=1)[0]

    def batches_per_epoch(self) -> int:
        if not self._epoch_order:
            self._shuffle_epoch()
        return sum(len(files) // self.batch_size for files in self._epoch_order.values())

    def __iter__(self) -> Iterator[List[Dict[str, Any]]]:
        """Yields batches of sample dicts; ends when the epoch exhausts."""
        if not self._epoch_order:
            self._shuffle_epoch()
        while True:
            if self._current_bucket is None or self._exhausted(self._current_bucket):
                self._current_bucket = self._pick_bucket()
                if self._current_bucket is None:
                    self.current_epoch += 1
                    self._start_epoch()
                    return
            key = self._current_bucket
            cursor = self._bucket_cursors.get(key, 0)
            files = self._epoch_order[key][cursor: cursor + self.batch_size]
            self._bucket_cursors[key] = cursor + self.batch_size
            self._seen.update(files)
            yield [
                {
                    "image_path": path,
                    "bucket": key,
                    "dataset_id": self.id,
                    "metadata": self.metadata_backend.image_metadata.get(path, {}),
                }
                for path in files
            ]

    def __len__(self) -> int:
        return self.batches_per_epoch()
