"""VAE latent cache, image, video and audio datasets.

The torch port's copy of ``simpletuner_tpu/caching/vae_cache.py``.  Disk
layout matches the reference (reference: helpers/caching/vae.py:118
``VAECache``; filenames ``sha256(stem).pt`` preserving subfolders, :678-703)
so caches interoperate both ways.  Host threads decode, crop and resize
(``data/training_sample.py``), batches are stacked per bucket shape and
pushed through ``encode_fn`` by one dispatch thread, and writer threads fetch
the latents and persist ``.pt`` files, so decode, encode and write overlap
(reference vae.py:2037 process_buckets).  A clip (a path whose metadata
holds ``num_frames``) is decoded to that many frames, resized and cropped
(``data/video.py``) and encoded whole, and its latents are stored 4-D
(T', H', W', C), as the JAX cache stores them.  A waveform (a path whose
metadata holds ``duration``) is decoded at the file's own rate
(``data/audio.py::load_audio``), trimmed or zero-padded to its bucket's
seconds, encoded as (S, C) samples and stored (S', C') latents.  The NSFW
scan is not ported (it raises).
"""

from __future__ import annotations

import hashlib
import io
import logging
import os
import random
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.backends.base import BaseDataBackend
from ..data.buckets import BucketConfig
from ..data.metadata import MetadataBackend
from ..data.training_sample import image_to_array, prepare_image

logger = logging.getLogger(__name__)


class VAECache:
    def __init__(
        self,
        id: str,
        data_backend: BaseDataBackend,
        metadata_backend: MetadataBackend,
        cache_dir: str,
        encode_fn: Optional[Callable[[np.ndarray, int], np.ndarray]] = None,
        bucket_config: Optional[BucketConfig] = None,
        instance_data_dir: Optional[str] = None,
        batch_size: int = 4,
        crop_style: str = "random",
        max_workers: int = 8,
        seed: int = 42,
        nsfw_filter=None,
        transfer_dtype: str = "float32",
    ):
        if nsfw_filter is not None:
            raise NotImplementedError("the NSFW scan pass is not ported (ROADMAP Queue 1 item 3)")
        self.id = id
        self.data_backend = data_backend
        self.metadata_backend = metadata_backend
        self.cache_dir = cache_dir
        self.encode_fn = encode_fn
        self.bucket_config = bucket_config or metadata_backend.bucket_config
        self.instance_data_dir = instance_data_dir or metadata_backend.instance_data_dir
        self.batch_size = batch_size
        self.crop_style = crop_style
        self.max_workers = max_workers
        self.seed = seed
        # "uint8": ship raw pixels host->device and normalize on the device —
        # 4x fewer transfer bytes than the reference's fp32 tensors
        # (vae.py:1809 moves normalized float batches); encode_fn must
        # advertise handles_uint8.  8-bit sources lose nothing: uint8 ->
        # [-1,1] is exact in f32.
        self.transfer_dtype = transfer_dtype

    # ---- filenames (reference vae.py:678-703) ------------------------------------------------
    def generate_vae_cache_filename(self, filepath: str) -> Tuple[str, str]:
        if filepath.endswith(".pt"):
            return filepath, os.path.basename(filepath)
        base = os.path.splitext(os.path.basename(filepath))[0]
        base = hashlib.sha256(base.encode()).hexdigest() + ".pt"
        subfolders = ""
        if self.instance_data_dir:
            subfolders = os.path.dirname(filepath).replace(self.instance_data_dir, "").lstrip(os.sep)
        if subfolders:
            return os.path.join(self.cache_dir, subfolders, base), base
        return os.path.join(self.cache_dir, base), base

    def exists(self, filepath: str) -> bool:
        return self.data_backend.exists(self.generate_vae_cache_filename(filepath)[0])

    def load(self, filepath: str) -> np.ndarray:
        latents = self.data_backend.torch_load(self.generate_vae_cache_filename(filepath)[0])
        if isinstance(latents, dict):  # some caches store dicts
            latents = latents.get("latents", latents)
        return np.asarray(latents)

    def save(self, filepath: str, latents: np.ndarray) -> None:
        self.data_backend.torch_save(latents, self.generate_vae_cache_filename(filepath)[0])

    def get(self, filepath: str) -> np.ndarray:
        """The cached latents of ``filepath`` (the collate's read); the JAX
        cache's on-demand encode is not ported, so a missing entry raises
        KeyError as the JAX cache does without ``ondemand``."""
        if self.exists(filepath):
            return self.load(filepath)
        raise KeyError(f"no cached latents for {filepath}")

    # ---- discovery ---------------------------------------------------------------------------
    def discover_unprocessed_files(self) -> List[str]:
        """Full candidate list in deterministic (bucket-sorted) order.

        Already-cached entries are NOT filtered here: multi-process caching
        splits this list by rank, and the split must be computed identically
        on every process — an exists() filter at this level would race with
        other ranks' in-flight writes (see process_buckets).
        """
        all_files: List[str] = []
        for key in sorted(self.metadata_backend.aspect_ratio_bucket_indices):
            all_files.extend(self.metadata_backend.aspect_ratio_bucket_indices[key])
        return all_files

    # ---- the caching pass --------------------------------------------------------------------
    def _prepare_one(self, path: str) -> Optional[Tuple[str, np.ndarray, Dict[str, Any]]]:
        """Read, orient, bucket-resize and crop one image: (path, pixels,
        crop metadata), or None for an image that cannot be prepared (the
        JAX cache skips those too, so callers compare the count
        ``process_buckets`` returns with the number of images)."""
        existing = self.metadata_backend.image_metadata.get(path, {})
        if "duration" in existing:  # a waveform of an audio dataset, at the file's rate
            from ..data.audio import load_audio

            duration = float(existing.get("bucket", "1s").rstrip("s"))
            waveform = load_audio(self.data_backend, path, sample_rate=int(existing.get("sample_rate", 44100)),
                                  duration_seconds=duration)
            if waveform is None:
                logger.warning("vae cache %s: skipping %s (no WAV decodes)", self.id, path)
                return None
            return path, waveform, {"duration": duration}
        rng = random.Random((self.seed, path).__hash__())
        if "num_frames" in existing:  # a clip of a video dataset
            from ..data.video import load_video_frames, prepare_video, video_to_array

            try:
                frames = load_video_frames(self.data_backend, path, int(existing["num_frames"]))
            except OSError as exc:
                logger.warning("vae cache %s: skipping %s (%s)", self.id, path, exc)
                return None
            if frames is None:
                logger.warning("vae cache %s: skipping %s (no frame decodes)", self.id, path)
                return None
            prepared, meta = prepare_video(frames, self.bucket_config, self.crop_style, rng)
            return path, video_to_array(prepared), meta
        try:
            from PIL import Image, ImageOps

            image = Image.open(io.BytesIO(self.data_backend.read(path)))
            # honor EXIF orientation (reference image_manipulation/load.py)
            image = ImageOps.exif_transpose(image)
            sample = prepare_image(image, self.bucket_config, self.crop_style, rng)
        except (ImportError, OSError, ValueError, SyntaxError) as exc:
            logger.warning("vae cache %s: skipping %s (%s)", self.id, path, exc)
            return None
        meta = {
            "original_size": list(sample.original_size),
            "target_size": list(sample.target_size),
            "crop_coordinates": list(sample.crop_coordinates),
            "aspect_ratio": sample.aspect_ratio,
        }
        if self.transfer_dtype == "uint8":
            return path, np.asarray(sample.image, np.uint8), meta
        return path, image_to_array(sample.image), meta

    def process_buckets(self, process_index: int = 0, num_processes: int = 1) -> int:
        """Encode and store all uncached latents. Returns number processed."""
        if self.encode_fn is None:
            raise RuntimeError(f"vae cache {self.id}: no encoder attached")
        all_todo = self.discover_unprocessed_files()
        # Split the full deterministic list FIRST, then drop already-cached
        # entries within this rank's shard.  Filtering before the split would
        # make each process's `all_todo` depend on how far the *other* ranks'
        # concurrent writes have progressed — the interleaved shards then
        # disagree and files fall through uncached.
        todo = [f for f in all_todo[process_index::num_processes] if not self.exists(f)]
        if not todo:
            return 0

        # group by bucket so every encode batch has one shape
        by_bucket: Dict[str, List[str]] = {}
        for path in todo:
            bucket = self.metadata_backend.image_metadata.get(path, {}).get("bucket", "?")
            by_bucket.setdefault(bucket, []).append(path)

        from concurrent.futures import ThreadPoolExecutor

        done = 0
        write_pool = ThreadPoolExecutor(max_workers=self.max_workers)
        # one dispatch thread owns stack+h2d+encode submission so the main
        # loop never blocks on the transfer; writer threads own the d2h fetch.
        # Decode | h2d+encode | fetch+write therefore overlap (reference
        # vae.py:2037 runs the same three stages as queue-linked threads).
        encode_pool = ThreadPoolExecutor(max_workers=1)
        # bounded in-flight windows: an eager map() would buffer every decoded
        # image in the bucket (O(dataset) host RAM); cap decode at 2x reader
        # threads and pending encodes at 2 batches
        decode_window = threading.Semaphore(self.max_workers * 2)
        encode_window = threading.Semaphore(2)
        writes = []
        with ThreadPoolExecutor(max_workers=self.max_workers) as read_pool:
            for bucket, paths in by_bucket.items():
                pending = []
                idx = 0

                def _submit_upto():
                    nonlocal idx
                    while idx < len(paths) and decode_window.acquire(blocking=False):
                        pending.append(read_pool.submit(self._prepare_one, paths[idx]))
                        idx += 1

                _submit_upto()
                batch_paths: List[str] = []
                batch_arrays: List[np.ndarray] = []
                consumed = 0
                while consumed < len(pending) or idx < len(paths):
                    item = pending[consumed].result()
                    consumed += 1
                    decode_window.release()
                    _submit_upto()
                    if item is None:
                        continue
                    path, array, meta = item
                    self.metadata_backend.image_metadata.setdefault(path, {}).update(meta)
                    batch_paths.append(path)
                    batch_arrays.append(array)
                    if len(batch_paths) == self.batch_size:
                        self._flush(batch_paths, batch_arrays, write_pool, writes,
                                    encode_pool, encode_window)
                        done += len(batch_paths)
                        batch_paths, batch_arrays = [], []
                if batch_paths:
                    self._flush(batch_paths, batch_arrays, write_pool, writes,
                                encode_pool, encode_window)
                    done += len(batch_paths)
        for w in writes:
            w.result()
        encode_pool.shutdown()
        write_pool.shutdown()
        self.metadata_backend.save_cache()
        return done

    def _flush(self, paths: List[str], arrays: List[np.ndarray], pool, writes, encode_pool, encode_window) -> None:
        # The WHOLE batch is fetched as one d2h copy — per-row fetches cost
        # one device-queue round trip each and serialize against the next
        # batch's compute.
        def _fetch_then_write(batch_paths: List[str], batch_latents) -> None:
            if isinstance(batch_latents, torch.Tensor):
                batch_latents = batch_latents.to("cpu", torch.float32)
            rows = np.asarray(batch_latents)
            for p, row in zip(batch_paths, rows):
                writes.append(pool.submit(self.save, p, row))

        def _encode_and_write(batch_paths: List[str], batch_arrays: List[np.ndarray]) -> None:
            try:
                stacked = np.stack(batch_arrays)  # (B, H, W, 3), (B, T, H, W, 3) clips or (B, S, C) waveforms
                latents = self.encode_fn(stacked, len(batch_paths))
                # encode_fn may return a tensor still being computed on the
                # device; the fetch rides a writer thread so the dispatch
                # thread stages the next batch while the device computes
                writes.append(pool.submit(_fetch_then_write, batch_paths, latents))
            finally:
                encode_window.release()

        encode_window.acquire()
        writes.append(encode_pool.submit(_encode_and_write, list(paths), list(arrays)))
