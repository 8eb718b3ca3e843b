"""Video decode and preparation for the data plane.

The torch port's copy of ``simpletuner_tpu/data/video.py`` (reference:
helpers/multiaspect/video.py, the frame-count bucket keys of
metadata/backends/base.py:350 and the frame alignment of caching/vae.py:1051):
``is_video_path``, ``align_frame_count`` (the largest 1 + 4k frames the
causal VAE takes), ``probe_video`` and ``load_video_frames`` (OpenCV, imported
when a clip is read), ``prepare_video`` (every frame resized and cropped to
the clip's bucket, one crop for the whole clip) and ``video_to_array``.  The
per-frame resize is the JAX package's PIL branch (LANCZOS, then the crop):
the port does not run the host C++ ``native/`` path.
"""

from __future__ import annotations

import logging
import os
import random
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .buckets import BucketConfig, bucket_key_for_size, target_size_for_aspect

logger = logging.getLogger(__name__)

VIDEO_EXTENSIONS = (".mp4", ".mov", ".avi", ".mkv", ".webm", ".m4v")


def is_video_path(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in VIDEO_EXTENSIONS


def align_frame_count(frames: int, alignment: int = 4) -> int:
    """Causal-3D-VAE frame alignment: the largest 4k + 1 <= frames (the
    Wan / LTX convention)."""
    if frames < 1:
        return 0
    return ((frames - 1) // alignment) * alignment + 1


def _capture_for(data, path: str):
    import cv2

    if isinstance(data, (bytes, bytearray)):
        # cv2 needs a file path: spill remote bytes to a temporary file
        handle = tempfile.NamedTemporaryFile(suffix=os.path.splitext(path)[1], delete=False)
        handle.write(data)
        handle.close()
        return cv2.VideoCapture(handle.name), handle.name
    return cv2.VideoCapture(path), None


def _open(data_backend, path: str):
    import cv2

    local = getattr(data_backend, "abspath", lambda p: None)(path)
    if local and os.path.exists(local):
        return cv2.VideoCapture(local), None
    return _capture_for(data_backend.read(path), path)


def probe_video(data_backend, path: str) -> Optional[Dict[str, Any]]:
    """(width, height, frames, fps) without decoding the frames; None for a
    clip OpenCV cannot open."""
    import cv2

    try:
        cap, tmp = _open(data_backend, path)
        try:
            if not cap.isOpened():
                return None
            return {
                "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                "fps": float(cap.get(cv2.CAP_PROP_FPS) or 0.0),
            }
        finally:
            cap.release()
            if tmp:
                os.unlink(tmp)
    except (OSError, cv2.error) as exc:
        logger.debug("video probe failed for %s: %s", path, exc)
        return None


def load_video_frames(data_backend, path: str, num_frames: int, frame_interval: int = 1) -> Optional[np.ndarray]:
    """Decode ``num_frames`` RGB frames (T, H, W, 3) uint8, every
    ``frame_interval``-th frame from the start; a short clip is padded by
    repeating its last frame; None when no frame decodes."""
    import cv2

    cap, tmp = _open(data_backend, path)
    frames: List[np.ndarray] = []
    try:
        index = 0
        while len(frames) < num_frames:
            ok, frame = cap.read()
            if not ok:
                break
            if index % frame_interval == 0:
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            index += 1
    finally:
        cap.release()
        if tmp:
            os.unlink(tmp)
    if not frames:
        return None
    while len(frames) < num_frames:
        frames.append(frames[-1])
    return np.stack(frames[:num_frames])


def prepare_video(
    frames: np.ndarray,  # (T, H, W, 3) uint8
    config: BucketConfig,
    crop_style: str = "center",
    rng: Optional[random.Random] = None,
) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Resize and crop every frame to the clip's bucket dims, with one crop
    for the whole clip."""
    from PIL import Image

    from .training_sample import _choose_crop

    t, src_h, src_w = frames.shape[:3]
    bucket_key = bucket_key_for_size(src_w, src_h, config)
    target_w, target_h = target_size_for_aspect(float(bucket_key), config)

    scale = max(target_w / src_w, target_h / src_h)
    inter_w = max(int(round(src_w * scale)), target_w)
    inter_h = max(int(round(src_h * scale)), target_h)
    left, top = _choose_crop(crop_style, inter_w, inter_h, target_w, target_h, rng,
                             frames if crop_style == "face" else None)

    out = np.empty((t, target_h, target_w, 3), np.uint8)
    for i in range(t):
        img = Image.fromarray(frames[i]).resize((inter_w, inter_h), Image.LANCZOS)
        out[i] = np.asarray(img.crop((left, top, left + target_w, top + target_h)))
    meta = {
        "original_size": [src_w, src_h],
        "target_size": [target_w, target_h],
        "crop_coordinates": [left, top],
        "num_frames": t,
        "bucket": bucket_key,
    }
    return out, meta


def video_to_array(frames: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8 -> float32 in [-1, 1]."""
    return frames.astype(np.float32) / 127.5 - 1.0
