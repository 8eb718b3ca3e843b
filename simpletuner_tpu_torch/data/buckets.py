"""Aspect-ratio bucketing math (reference: helpers/multiaspect/image.py
``MultiaspectImage`` + metadata/backends/base.py bucket key construction).

The torch port's whole copy of ``simpletuner_tpu/data/buckets.py``.

Buckets are keyed by the rounded aspect ratio (``aspect_bucket_rounding``
decimals).  Every image in a bucket is resized/cropped to the same pixel
dimensions, so each bucket is one batch shape for the encoders.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BucketConfig:
    resolution: float = 1024
    resolution_type: str = "pixel_area"  # pixel | area | pixel_area
    aspect_bucket_rounding: int = 2
    aspect_bucket_alignment: int = 64
    minimum_image_size: Optional[float] = None
    maximum_image_size: Optional[float] = None
    target_downsample_size: Optional[float] = None
    minimum_aspect_ratio: Optional[float] = None
    maximum_aspect_ratio: Optional[float] = None
    crop: bool = False
    crop_aspect: str = "square"  # square | preserve | closest | random
    crop_aspect_buckets: Optional[List[float]] = None
    square_padding: bool = False
    # cap upscaling when selecting from crop_aspect_buckets (reference
    # training_sample.py:251-265)
    max_upscale_threshold: Optional[float] = None

    @property
    def target_area(self) -> float:
        """Target pixel area derived from resolution_type."""
        if self.resolution_type == "area":
            return self.resolution * 1_000_000.0
        # pixel_area: resolution is the edge length of the equivalent square
        return float(self.resolution) * float(self.resolution)


def _align_down(value: float, alignment: int) -> int:
    aligned = int(value // alignment) * alignment
    return max(aligned, alignment)


def round_aspect(width: int, height: int, rounding: int = 2) -> float:
    return round(width / height, rounding)


def target_size_for_aspect(aspect: float, config: BucketConfig) -> Tuple[int, int]:
    """Pixel (width, height) for a bucket, aligned to the bucket alignment."""
    alignment = config.aspect_bucket_alignment
    if config.crop and config.crop_aspect == "square":
        if config.resolution_type == "pixel":
            edge = _align_down(config.resolution, alignment)
        else:
            edge = _align_down(config.target_area ** 0.5, alignment)
        return edge, edge
    if config.resolution_type == "pixel":
        # resolution = smaller edge
        if aspect >= 1.0:
            height = _align_down(config.resolution, alignment)
            width = _align_down(height * aspect, alignment)
        else:
            width = _align_down(config.resolution, alignment)
            height = _align_down(width / aspect, alignment)
        return width, height
    area = config.target_area
    width = _align_down((area * aspect) ** 0.5, alignment)
    height = _align_down((area / aspect) ** 0.5, alignment)
    return width, height


def _bucket_aspect_value(bucket) -> float:
    """crop_aspect_buckets entries are floats or {aspect[_ratio], weight} dicts
    (reference training_sample.py:243-248)."""
    if isinstance(bucket, dict):
        return float(bucket.get("aspect", bucket.get("aspect_ratio")))
    return float(bucket)


def select_crop_aspect(width: int, height: int, config: BucketConfig, seed_token: str = "") -> float:
    """Pick an aspect from ``crop_aspect_buckets`` for one source image.

    Reference semantics (training_sample.py:239-299):
    * ``max_upscale_threshold`` trims candidates whose target size exceeds
      original * (1 + threshold) on either edge;
    * ``closest`` picks the candidate nearest the source aspect;
    * ``random`` draws one (here deterministically per-file, keyed on the
      path, so bucket indices are stable across rebuilds and ranks).
    Falls back to the source's own bucket aspect when every candidate is
    filtered out.
    """
    source_aspect = width / height
    candidates = []
    for bucket in config.crop_aspect_buckets or []:
        aspect = _bucket_aspect_value(bucket)
        if config.max_upscale_threshold is not None:
            target_w, target_h = target_size_for_aspect(aspect, config)
            limit = 1.0 + float(config.max_upscale_threshold)
            if target_w > width * limit or target_h > height * limit:
                continue
        candidates.append(aspect)
    if not candidates:
        return round_aspect(width, height, config.aspect_bucket_rounding)
    if config.crop_aspect == "closest":
        return min(candidates, key=lambda a: abs(a - source_aspect))
    import hashlib
    import random as _random

    seed = int.from_bytes(hashlib.sha256(seed_token.encode()).digest()[:8], "little")
    weights = None
    if config.crop_aspect_buckets and isinstance(config.crop_aspect_buckets[0], dict):
        by_aspect = {_bucket_aspect_value(b): b for b in config.crop_aspect_buckets}
        weights = [float(by_aspect[a].get("weight", 1.0)) for a in candidates]
    return _random.Random(seed).choices(candidates, weights=weights, k=1)[0]


def bucket_key_for_size(width: int, height: int, config: BucketConfig, seed_token: str = "") -> str:
    """Bucket key for a source image of (width, height)."""
    if config.crop and config.crop_aspect == "square":
        return "1.0"
    if (
        config.crop
        and config.crop_aspect in ("closest", "random")
        and config.crop_aspect_buckets
    ):
        aspect = select_crop_aspect(width, height, config, seed_token)
    else:
        aspect = round_aspect(width, height, config.aspect_bucket_rounding)
    target_w, target_h = target_size_for_aspect(aspect, config)
    # canonical key = aspect of the *target* so all members share exact dims
    return str(round(target_w / target_h, config.aspect_bucket_rounding))


def image_passes_constraints(width: int, height: int, config: BucketConfig) -> Tuple[bool, str]:
    """Min-size / aspect-range pruning (reference metadata base.py:1026-1283)."""
    aspect = width / height
    if config.minimum_aspect_ratio and aspect < config.minimum_aspect_ratio:
        return False, f"aspect {aspect:.2f} < minimum_aspect_ratio"
    if config.maximum_aspect_ratio and aspect > config.maximum_aspect_ratio:
        return False, f"aspect {aspect:.2f} > maximum_aspect_ratio"
    if config.minimum_image_size:
        if config.resolution_type == "pixel":
            if min(width, height) < config.minimum_image_size:
                return False, "smaller than minimum_image_size"
        else:
            min_area = (
                config.minimum_image_size * 1_000_000.0
                if config.resolution_type == "area"
                else config.minimum_image_size ** 2
            )
            if width * height < min_area:
                return False, "area smaller than minimum_image_size"
    return True, ""


def video_bucket_key(width: int, height: int, frames: int, config: BucketConfig) -> str:
    """Video buckets additionally key on frame count (reference base.py:350)."""
    return f"{bucket_key_for_size(width, height, config)}x{frames}"


def audio_bucket_key(duration_seconds: float, bucket_seconds: float = 10.0) -> str:
    """Audio buckets by duration window (reference base.py:328)."""
    import math

    return f"audio_{int(math.ceil(max(duration_seconds, 1e-6) / bucket_seconds) * bucket_seconds)}s"


def latent_size(width: int, height: int, vae_scale: int = 8) -> Tuple[int, int]:
    return width // vae_scale, height // vae_scale
