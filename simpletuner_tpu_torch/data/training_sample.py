"""TrainingSample — the image preparation state machine (reference:
helpers/image_manipulation/training_sample.py:32 + cropping.py:58-136):
target-size calculation from the bucket, optional downsample-before-crop,
corner/center/random/face crop, final resize.

The torch port's copy of ``simpletuner_tpu/data/training_sample.py``, its PIL
path (the JAX ``prepare_image(use_native=False)``): the host C++ ``native/``
fast path is not ported.  PIL is imported when an image is prepared, and
OpenCV only for a face crop (without it, the upper-centre fallback).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Optional, Tuple

from .buckets import BucketConfig, bucket_key_for_size, target_size_for_aspect


@dataclasses.dataclass
class PreparedSample:
    image: Any  # PIL.Image
    original_size: Tuple[int, int]  # (w, h)
    target_size: Tuple[int, int]  # (w, h)
    intermediary_size: Tuple[int, int]
    crop_coordinates: Tuple[int, int]  # (left, top)
    aspect_ratio: float
    bucket_key: str


def _detect_face_center(image_array) -> Optional[Tuple[int, int]]:
    """Largest-face centre via the OpenCV Haar cascade (reference
    image_manipulation/cropping.py:181 FaceCropping)."""
    import numpy as np

    try:
        import cv2

        cascade = cv2.CascadeClassifier(cv2.data.haarcascades + "haarcascade_frontalface_default.xml")
    except (ImportError, AttributeError):  # no OpenCV, or a build without the Haar detector
        return None
    frame = np.asarray(image_array)
    if frame.ndim == 4:  # video: detect on the first frame
        frame = frame[0]
    gray = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY) if frame.shape[-1] == 3 else frame
    faces = cascade.detectMultiScale(gray, 1.1, 4)
    if len(faces) == 0:
        return None
    x, y, w, h = max(faces, key=lambda f: f[2] * f[3])
    return x + w // 2, y + h // 2


def _choose_crop(
    crop_style: str, src_w: int, src_h: int, out_w: int, out_h: int,
    rng: Optional[random.Random], image_array=None,
) -> Tuple[int, int]:
    max_left = max(src_w - out_w, 0)
    max_top = max(src_h - out_h, 0)
    if crop_style in ("center", "centre"):
        return max_left // 2, max_top // 2
    if crop_style == "corner":
        return max_left, max_top  # bottom-right corner like the reference
    if crop_style == "random":
        rng = rng or random
        return rng.randint(0, max_left), rng.randint(0, max_top)
    if crop_style == "face":
        if image_array is not None:
            center = _detect_face_center(image_array)
            if center is not None:
                cx, cy = center
                return (
                    min(max(cx - out_w // 2, 0), max_left),
                    min(max(cy - out_h // 2, 0), max_top),
                )
        # no detector / no face: bias toward the upper-center region
        # (reference fallback behavior)
        return max_left // 2, min(max_top // 4, max_top)
    raise ValueError(f"unknown crop_style {crop_style!r}")


def prepare_image(
    image,
    config: BucketConfig,
    crop_style: str = "random",
    rng: Optional[random.Random] = None,
) -> PreparedSample:
    """Resize (and crop) a PIL image into its bucket's exact pixel dimensions."""
    from PIL import Image

    if image.mode != "RGB":
        image = image.convert("RGB")
    src_w, src_h = image.size
    bucket_key = bucket_key_for_size(src_w, src_h, config)
    target_w, target_h = target_size_for_aspect(float(bucket_key), config)

    if config.crop:
        # downsample-before-crop: avoid cropping a tiny window out of a huge image
        inter_w, inter_h = src_w, src_h
        downsample_to = config.target_downsample_size
        if downsample_to:
            if config.resolution_type == "pixel":
                limit = downsample_to
                scale = limit / min(src_w, src_h)
            else:
                area = (
                    downsample_to * 1_000_000.0
                    if config.resolution_type == "area"
                    else float(downsample_to) ** 2
                )
                scale = (area / (src_w * src_h)) ** 0.5
            if scale < 1.0:
                inter_w = max(int(src_w * scale), target_w)
                inter_h = max(int(src_h * scale), target_h)
                image = image.resize((inter_w, inter_h), Image.LANCZOS)
        # cover-resize so both dims reach the target, then crop
        scale = max(target_w / inter_w, target_h / inter_h)
        if scale != 1.0:
            inter_w = max(int(round(inter_w * scale)), target_w)
            inter_h = max(int(round(inter_h * scale)), target_h)
            image = image.resize((inter_w, inter_h), Image.LANCZOS)
        import numpy as _np

        face_src = _np.asarray(image) if crop_style == "face" else None
        left, top = _choose_crop(crop_style, inter_w, inter_h, target_w, target_h, rng, face_src)
        image = image.crop((left, top, left + target_w, top + target_h))
        crop_coordinates = (left, top)
        intermediary = (inter_w, inter_h)
    else:
        image = image.resize((target_w, target_h), Image.LANCZOS)
        crop_coordinates = (0, 0)
        intermediary = (target_w, target_h)

    return PreparedSample(
        image=image,
        original_size=(src_w, src_h),
        target_size=(target_w, target_h),
        intermediary_size=intermediary,
        crop_coordinates=crop_coordinates,
        aspect_ratio=float(bucket_key),
        bucket_key=bucket_key,
    )


def prepare_like(image, reference_sample: PreparedSample) -> PreparedSample:
    """Prepare a conditioning image identically to its paired sample (reference
    training_sample.py ``prepare_like`` for edit/ControlNet pairs)."""
    from PIL import Image

    if image.mode != "RGB":
        image = image.convert("RGB")
    target_w, target_h = reference_sample.target_size
    inter_w, inter_h = reference_sample.intermediary_size
    image = image.resize((inter_w, inter_h), Image.LANCZOS)
    left, top = reference_sample.crop_coordinates
    if (inter_w, inter_h) != (target_w, target_h):
        image = image.crop((left, top, left + target_w, top + target_h))
    return PreparedSample(
        image=image,
        original_size=reference_sample.original_size,
        target_size=reference_sample.target_size,
        intermediary_size=reference_sample.intermediary_size,
        crop_coordinates=reference_sample.crop_coordinates,
        aspect_ratio=reference_sample.aspect_ratio,
        bucket_key=reference_sample.bucket_key,
    )


def image_to_array(image, normalize: bool = True):
    """PIL or uint8 ndarray -> float32 numpy (H, W, C) in [-1, 1]."""
    import numpy as np

    raw = np.asarray(image)
    array = raw.astype(np.float32) / 255.0
    if normalize:
        array = array * 2.0 - 1.0
    return array
