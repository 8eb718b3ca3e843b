"""Audio decode + duration bucketing.

The torch port's copy of ``simpletuner_tpu/data/audio.py`` (host numpy and
scipy only; ``tests/test_torch_host_modules.py`` holds the body after this
docstring equal to the JAX module's): ``AUDIO_EXTENSIONS``,
``duration_bucket`` (whole-second buckets), ``waveform_features`` (the
log-magnitude STFT features of the speech-to-video pairing), ``probe_audio``,
``load_audio`` (scipy WAV decode, ``resample_poly``, pad or trim to a
duration) and the codec-token file readers (``load_token_matrix``,
``probe_token_file``).  WAV decodes through scipy; other containers are
skipped at the probe, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

AUDIO_EXTENSIONS = (".wav", ".flac", ".mp3", ".ogg", ".m4a")


def duration_bucket(duration_seconds: float, bucket_seconds: float = 1.0) -> str:
    """Quantize duration to its bucket key (reference audio duration buckets)."""
    steps = max(int(duration_seconds / bucket_seconds), 1)
    return f"{steps * bucket_seconds:g}s"


def waveform_features(
    waveform: np.ndarray,  # (samples, channels) float32 [-1, 1]
    sample_rate: int = 16000,
    hop: int = 320,
    n_fft: int = 512,
    n_bins: int = 64,
) -> np.ndarray:
    """Log-magnitude STFT features (frames, n_bins) — the host-side audio
    conditioning features for S2V pairing (reference wan_s2v audio pairing;
    the reference uses wav2vec-style features, same plumbing)."""
    from scipy.signal import stft

    mono = waveform.mean(axis=1) if waveform.ndim > 1 else waveform
    _, _, spec = stft(mono, fs=sample_rate, nperseg=n_fft, noverlap=n_fft - hop)
    mag = np.abs(spec)  # (freq, frames)
    # pool frequency bins down to n_bins
    freq = mag.shape[0]
    usable = (freq // n_bins) * n_bins
    pooled = mag[:usable].reshape(n_bins, -1, mag.shape[1]).mean(axis=1)
    return np.log1p(pooled.T).astype(np.float32)  # (frames, n_bins)


def probe_audio(data_backend, path: str) -> Optional[Dict[str, Any]]:
    try:
        import io

        from scipy.io import wavfile

        if not path.lower().endswith(".wav"):
            return None  # non-wav needs ffmpeg; handled by a later decoder pass
        rate, data = wavfile.read(io.BytesIO(data_backend.read(path)))
        frames = data.shape[0]
        return {
            "sample_rate": int(rate),
            "frames": int(frames),
            "channels": int(data.shape[1]) if data.ndim > 1 else 1,
            "duration": frames / rate,
        }
    except Exception as exc:
        logger.debug("audio probe failed for %s: %s", path, exc)
        return None


TOKEN_EXTENSIONS = (".npy", ".npz")


def load_token_matrix(data_backend, path: str) -> np.ndarray:
    """Pre-tokenised codec frames (reference heartmula/model.py:358-400
    ``_load_audio_tokens``): .npy/.npz with [frames, codebooks] (or its
    transpose, resolved by the model against num_codebooks)."""
    import io

    payload = np.load(io.BytesIO(data_backend.read(path)), allow_pickle=False)
    if hasattr(payload, "files"):
        if "tokens" in payload:
            payload = payload["tokens"]
        elif payload.files:
            payload = payload[payload.files[0]]
        else:
            raise ValueError(f"audio token archive {path} is empty")
    tokens = np.asarray(payload)
    if tokens.ndim != 2:
        raise ValueError(
            f"audio tokens must be 2D [frames, codebooks] (or transposed), got {tokens.shape} in {path}"
        )
    return tokens.astype(np.int64)


def probe_token_file(data_backend, path: str, frame_rate: float = 25.0) -> Optional[Dict[str, Any]]:
    """Probe a codec-token file for duration bucketing (frames / frame_rate)."""
    try:
        tokens = load_token_matrix(data_backend, path)
        frames = int(max(tokens.shape))  # frame axis is the longer one
        return {
            "sample_rate": 0,
            "frames": frames,
            "channels": 0,
            "duration": frames / max(frame_rate, 1e-6),
            "token_file": True,
        }
    except Exception as exc:
        logger.debug("token probe failed for %s: %s", path, exc)
        return None


def load_audio(
    data_backend,
    path: str,
    sample_rate: int = 44100,
    duration_seconds: Optional[float] = None,
    mono: bool = False,
) -> Optional[np.ndarray]:
    """Decode to float32 waveform (samples, channels) in [-1, 1], resampled."""
    import io

    from scipy.io import wavfile
    from scipy.signal import resample_poly

    try:
        rate, data = wavfile.read(io.BytesIO(data_backend.read(path)))
    except Exception as exc:
        logger.debug("audio decode failed for %s: %s", path, exc)
        return None
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / np.iinfo(data.dtype).max
    elif data.dtype.kind == "u":
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[:, None]
    if mono and data.shape[1] > 1:
        data = data.mean(axis=1, keepdims=True)
    if rate != sample_rate:
        from math import gcd

        g = gcd(rate, sample_rate)
        data = resample_poly(data, sample_rate // g, rate // g, axis=0).astype(np.float32)
    if duration_seconds is not None:
        target = int(duration_seconds * sample_rate)
        if data.shape[0] >= target:
            data = data[:target]
        else:
            data = np.pad(data, ((0, target - data.shape[0]), (0, 0)))
    return data
