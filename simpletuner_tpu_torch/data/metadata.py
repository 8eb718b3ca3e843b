"""Metadata backend: aspect-bucket index construction & persistence.

Reference: helpers/metadata/backends/base.py:95 ``MetadataBackend`` (bucket index
construction, persistence, constraints, DP splits).  The torch port's copy of
``MetadataBackend`` from ``simpletuner_tpu/data/metadata.py``, for image and
caption datasets, and video datasets (``_discover_video``: (aspect,
frame count) bucket keys such as ``"1.73x81"``, the frame count aligned to
1 + 4k and capped by the dataset's ``video`` settings ``num_frames`` /
``min_frames``) and audio datasets (``_discover_audio``: whole-duration
bucket keys such as ``"47s"`` from the dataset's ``audio`` settings
``bucket_seconds`` / ``max_duration``, WAV files probed through scipy and
codec-token files (``.npy`` / ``.npz``) through ``token_frame_rate``): the
index maps ``bucket_key -> [file paths]`` plus per-file metadata
(original/target size, crop coords; a clip's frame counts and fps; a
waveform's duration, rate and channels), built on host threads and
persisted as JSON on the dataset's storage backend, in the same files as the
JAX package writes.  The parquet backend is not ported.
"""

from __future__ import annotations

import io
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from .backends.base import BaseDataBackend
from .buckets import BucketConfig, bucket_key_for_size, image_passes_constraints


class MetadataBackend:
    """Aspect bucket index over one dataset."""

    def __init__(
        self,
        id: str,
        data_backend: BaseDataBackend,
        bucket_config: BucketConfig,
        instance_data_dir: Optional[str] = None,
        cache_file: Optional[str] = None,
        metadata_file: Optional[str] = None,
        repeats: int = 0,
        dataset_type: str = "image",
        video_config: Optional[Dict[str, Any]] = None,
    ):
        self.id = id
        self.data_backend = data_backend
        self.bucket_config = bucket_config
        self.instance_data_dir = instance_data_dir
        self.dataset_type = dataset_type
        self.video_config = video_config or {}
        base = instance_data_dir or "."
        self.cache_file = cache_file or os.path.join(base, "aspect_ratio_bucket_indices.json")
        self.metadata_file = metadata_file or os.path.join(base, "aspect_ratio_bucket_metadata.json")
        self.repeats = repeats
        self.aspect_ratio_bucket_indices: Dict[str, List[str]] = {}
        self.image_metadata: Dict[str, Dict[str, Any]] = {}
        # multi-host: per-process caching passes each learn crop metadata for
        # only their own file shard; writes go to a rank-suffixed sidecar and
        # merge_rank_metadata() unions them after the caching barrier
        self.rank_suffix: Optional[str] = None

    # ---- probing ------------------------------------------------------------------------
    def _probe(self, path: str) -> Optional[Tuple[int, int]]:
        """Displayed (width, height), or None for a file PIL cannot read."""
        from PIL import Image

        try:
            with Image.open(io.BytesIO(self.data_backend.read(path))) as img:
                # EXIF orientations 5-8 rotate 90°: displayed W/H are swapped
                orientation = (img.getexif() or {}).get(0x0112, 1)
                if orientation in (5, 6, 7, 8):
                    return img.size[1], img.size[0]
                return img.size
        except (OSError, ValueError, SyntaxError):  # unreadable or not an image
            return None

    def discover(self, max_workers: int = 16) -> Dict[str, List[str]]:
        """Walk the dataset, probe sizes, and build the bucket index."""
        if self.dataset_type == "video":
            return self._discover_video(max_workers)
        if self.dataset_type == "audio":
            return self._discover_audio(max_workers)
        if self.dataset_type == "caption":
            return self._discover_caption()
        files = self.data_backend.list_files(instance_data_dir=self.instance_data_dir)
        known = set(self.image_metadata)
        new_files = [f for f in files if f not in known]

        def probe_one(path):
            size = self._probe(path)
            return path, size

        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            results = list(pool.map(probe_one, new_files))

        for path, size in results:
            if size is None:
                continue
            width, height = size
            ok, reason = image_passes_constraints(width, height, self.bucket_config)
            if not ok:
                self.image_metadata[path] = {"skipped": reason}
                continue
            key = bucket_key_for_size(width, height, self.bucket_config, seed_token=path)
            self.image_metadata[path] = {
                "original_size": [width, height],
                "bucket": key,
            }
            self.aspect_ratio_bucket_indices.setdefault(key, []).append(path)
        # drop deleted files
        current = set(files)
        for key in list(self.aspect_ratio_bucket_indices):
            kept = [f for f in self.aspect_ratio_bucket_indices[key] if f in current]
            if kept:
                self.aspect_ratio_bucket_indices[key] = kept
            else:
                del self.aspect_ratio_bucket_indices[key]
        return self.aspect_ratio_bucket_indices

    def _discover_video(self, max_workers: int = 16) -> Dict[str, List[str]]:
        """Video buckets: (aspect, frame count) keys (reference
        metadata/backends/base.py:350 video bucket keys)."""
        from .buckets import video_bucket_key
        from .video import VIDEO_EXTENSIONS, align_frame_count, probe_video

        files = self.data_backend.list_files(
            file_extensions=VIDEO_EXTENSIONS, instance_data_dir=self.instance_data_dir
        )
        known = set(self.image_metadata)
        new_files = [f for f in files if f not in known]
        max_frames = int(self.video_config.get("num_frames", 0) or 0)
        min_frames = int(self.video_config.get("min_frames", 1) or 1)

        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            results = list(pool.map(lambda p: (p, probe_video(self.data_backend, p)), new_files))

        for path, info in results:
            if info is None or info["frames"] < 1:
                continue
            width, height = info["width"], info["height"]
            ok, reason = image_passes_constraints(width, height, self.bucket_config)
            if not ok:
                self.image_metadata[path] = {"skipped": reason}
                continue
            frames = align_frame_count(info["frames"])
            if max_frames:
                frames = min(frames, align_frame_count(max_frames))
            if frames < min_frames:
                self.image_metadata[path] = {"skipped": f"too short ({info['frames']} frames)"}
                continue
            key = video_bucket_key(width, height, frames, self.bucket_config)
            self.image_metadata[path] = {
                "original_size": [width, height],
                "num_frames": frames,
                "total_frames": info["frames"],
                "fps": info.get("fps"),
                "bucket": key,
            }
            self.aspect_ratio_bucket_indices.setdefault(key, []).append(path)
        current = set(files)
        for key in list(self.aspect_ratio_bucket_indices):
            kept = [f for f in self.aspect_ratio_bucket_indices[key] if f in current]
            if kept:
                self.aspect_ratio_bucket_indices[key] = kept
            else:
                del self.aspect_ratio_bucket_indices[key]
        return self.aspect_ratio_bucket_indices

    def _discover_audio(self, max_workers: int = 16) -> Dict[str, List[str]]:
        """Audio buckets keyed by the duration quantized to ``bucket_seconds``
        (capped at ``max_duration``); a codec-token file's duration is its
        frame count over ``token_frame_rate``."""
        from .audio import AUDIO_EXTENSIONS, TOKEN_EXTENSIONS, duration_bucket, probe_audio, probe_token_file

        files = self.data_backend.list_files(
            file_extensions=AUDIO_EXTENSIONS + TOKEN_EXTENSIONS, instance_data_dir=self.instance_data_dir
        )
        known = set(self.image_metadata)
        new_files = [f for f in files if f not in known]
        audio_cfg = self.video_config  # the dataset's `audio` dict rides the same slot
        max_duration = float(audio_cfg.get("max_duration", 0) or 0)
        bucket_seconds = float(audio_cfg.get("bucket_seconds", 1.0) or 1.0)
        token_frame_rate = float(audio_cfg.get("token_frame_rate", 25.0) or 25.0)

        def probe_one(path):
            if path.lower().endswith(TOKEN_EXTENSIONS):
                return path, probe_token_file(self.data_backend, path, token_frame_rate)
            return path, probe_audio(self.data_backend, path)

        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            results = list(pool.map(probe_one, new_files))

        for path, info in results:
            if info is None or info["duration"] <= 0:
                continue
            duration = info["duration"]
            if max_duration:
                duration = min(duration, max_duration)
            key = duration_bucket(duration, bucket_seconds)
            self.image_metadata[path] = {
                "duration": duration,
                "sample_rate": info["sample_rate"],
                "channels": info["channels"],
                "bucket": key,
            }
            if info.get("token_file"):
                self.image_metadata[path]["token_file"] = True
                self.image_metadata[path]["frames"] = info["frames"]
            self.aspect_ratio_bucket_indices.setdefault(key, []).append(path)
        current = set(files)
        for key in list(self.aspect_ratio_bucket_indices):
            kept = [f for f in self.aspect_ratio_bucket_indices[key] if f in current]
            if kept:
                self.aspect_ratio_bucket_indices[key] = kept
            else:
                del self.aspect_ratio_bucket_indices[key]
        return self.aspect_ratio_bucket_indices

    def _discover_caption(self) -> Dict[str, List[str]]:
        """Caption-only datasets (reference helpers/metadata/backends/caption.py
        + data_backend/caption_dataset.py): every .txt file is one record in a
        single trivial bucket — no image probing, no VAE cache."""
        files = self.data_backend.list_files(
            file_extensions=(".txt",), instance_data_dir=self.instance_data_dir
        )
        for path in files:
            if path in self.image_metadata:
                continue
            self.image_metadata[path] = {"bucket": "caption"}
            self.aspect_ratio_bucket_indices.setdefault("caption", []).append(path)
        self.save_cache()
        return self.aspect_ratio_bucket_indices

    # ---- persistence ----------------------------------------------------------------------
    def save_cache(self) -> None:
        payload = {
            "config": {
                "resolution": self.bucket_config.resolution,
                "resolution_type": self.bucket_config.resolution_type,
                "crop": self.bucket_config.crop,
                "crop_aspect": self.bucket_config.crop_aspect,
            },
            "aspect_ratio_bucket_indices": self.aspect_ratio_bucket_indices,
            "updated_at": time.time(),
        }
        self.data_backend.write(self.cache_file, json.dumps(payload).encode())
        metadata_path = self.metadata_file + (self.rank_suffix or "")
        self.data_backend.write(metadata_path, json.dumps(self.image_metadata).encode())

    def merge_rank_metadata(self, num_processes: int, write_union: bool = False) -> None:
        """Union the per-rank metadata sidecars into memory (call after the
        cross-process caching barrier so every host sees crop/size metadata
        for files cached by other ranks — SDXL time-ids etc. need it)."""
        merged: Dict[str, Dict[str, Any]] = {}
        if self.data_backend.exists(self.metadata_file):
            try:
                merged.update(json.loads(self.data_backend.read(self.metadata_file)))
            except (OSError, ValueError):  # a sidecar being written or broken
                pass
        for rank in range(num_processes):
            path = f"{self.metadata_file}.rank{rank}"
            if self.data_backend.exists(path):
                try:
                    merged.update(json.loads(self.data_backend.read(path)))
                except (OSError, ValueError):
                    pass
        merged.update(self.image_metadata)  # in-memory (own shard) wins
        self.image_metadata = merged
        if write_union:
            self.data_backend.write(self.metadata_file, json.dumps(merged).encode())

    def load_cache(self) -> bool:
        try:
            payload = json.loads(self.data_backend.read(self.cache_file))
            self.aspect_ratio_bucket_indices = payload.get("aspect_ratio_bucket_indices", {})
            if self.data_backend.exists(self.metadata_file):
                self.image_metadata = json.loads(self.data_backend.read(self.metadata_file))
            return True
        except (OSError, ValueError):  # no index yet, or an unreadable one
            return False

    def refresh(self, force: bool = False, max_workers: int = 16) -> Dict[str, List[str]]:
        if not force and self.load_cache() and self.aspect_ratio_bucket_indices:
            return self.aspect_ratio_bucket_indices
        self.discover(max_workers=max_workers)
        self.save_cache()
        return self.aspect_ratio_bucket_indices

    # ---- queries -----------------------------------------------------------------------------
    def __len__(self) -> int:
        return sum(len(v) for v in self.aspect_ratio_bucket_indices.values())

    def bucket_keys(self) -> List[str]:
        return sorted(self.aspect_ratio_bucket_indices)

    def remove_image(self, path: str) -> None:
        for key in list(self.aspect_ratio_bucket_indices):
            bucket = self.aspect_ratio_bucket_indices[key]
            if path in bucket:
                bucket.remove(path)
                if not bucket:
                    del self.aspect_ratio_bucket_indices[key]

    def split_buckets_between_processes(
        self, process_index: int, num_processes: int, gradient_accumulation_steps: int = 1
    ) -> Dict[str, List[str]]:
        """Shard every bucket across DP ranks with grad-accum-aware padding
        (reference metadata base.py:741)."""
        out: Dict[str, List[str]] = {}
        for key, files in self.aspect_ratio_bucket_indices.items():
            effective = files[:]
            stride = num_processes * gradient_accumulation_steps
            keep = (len(effective) // stride) * stride
            effective = effective[:keep]
            shard = effective[process_index::num_processes]
            if shard:
                out[key] = shard
        return out
