"""The torch port's video modality against the JAX package, on the CPU.

The causal video VAE (``models/video_vae.py``) on the same seeded numpy
weights and frames, at 1 + 4k frames and at counts that are not, with its
frame-run splits of the norms and convolutions held to the unsplit
computation; the host copy ``data/video.py`` on small mp4 clips written here
with OpenCV (the JAX side forced onto its PIL resize, the port's only
branch); ``MetadataBackend._discover_video``; the video branch of the VAE
cache, whose files each package reads from the other; and the 5-D collate.
Every tolerance is stated where it is checked.
"""

import os
import random

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpletuner_tpu import native as jax_native
from simpletuner_tpu.caching.vae_cache import VAECache as JaxVAECache
from simpletuner_tpu.configuration.dataloader import DatasetConfig as JaxDatasetConfig
from simpletuner_tpu.data import buckets as jax_buckets
from simpletuner_tpu.data import video as jax_video
from simpletuner_tpu.data.backends.local import LocalDataBackend as JaxLocalDataBackend
from simpletuner_tpu.data.dataset import DatasetBundle as JaxDatasetBundle
from simpletuner_tpu.data.dataset import collate_batch as jax_collate_batch
from simpletuner_tpu.data.metadata import MetadataBackend as JaxMetadataBackend
from simpletuner_tpu.models.video_vae import VideoAutoencoderKL as JaxVideoAutoencoderKL
from simpletuner_tpu.models.video_vae import VideoVAEConfig as JaxVideoVAEConfig

from simpletuner_tpu_torch.caching.vae_cache import VAECache
from simpletuner_tpu_torch.configuration.dataloader import DatasetConfig
from simpletuner_tpu_torch.data import buckets, video
from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
from simpletuner_tpu_torch.data.dataset import DatasetBundle, collate_batch
from simpletuner_tpu_torch.data.metadata import MetadataBackend
from simpletuner_tpu_torch.models import video_vae
from simpletuner_tpu_torch.models.video_vae import VideoAutoencoderKL, VideoVAEConfig

from torch_parity import bridge, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5


def write_clip(path, frames, width, height, seed=0):
    """An mp4v clip of ``frames`` seeded frames (a moving gradient plus noise)."""
    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8, (width, height))
    ramp = np.linspace(0, 255, width, dtype=np.float32)[None, :, None]
    for i in range(frames):
        frame = (ramp + 20 * i + rng.normal(0, 12, (height, width, 3))) % 256
        writer.write(frame.astype(np.uint8))
    writer.release()
    return str(path)


# ---- the causal video VAE ---------------------------------------------------------------------------


def test_presets_match_jax():
    for name in ("wan", "tiny"):
        ours, theirs = getattr(VideoVAEConfig, name)(), getattr(JaxVideoVAEConfig, name)()
        assert ours.__dict__ == theirs.__dict__, name
        assert (ours.spatial_factor, ours.temporal_factor) == (theirs.spatial_factor, theirs.temporal_factor)
    assert (VideoVAEConfig.wan().spatial_factor, VideoVAEConfig.wan().temporal_factor) == (8, 4)


# frames in and latent frames out: 1 + 4k frames and two counts that are not
FRAMES = {9: 3, 7: 2, 1: 1}


@pytest.mark.parametrize("frames", sorted(FRAMES))
def test_encode_and_decode_match_jax(frames):
    """The tiny VAE (f32) on the same seeded weights: the moments and the
    mean within ``F32_REL`` in relative L2, the causal strides giving
    ``FRAMES`` latent frames, and the decode of the JAX latents (the
    temporal ``repeat(2)[:, 1:]`` per level: 1 + 4 (T' - 1) frames) within
    ``F32_REL``."""
    x = np.random.default_rng(frames).uniform(-1, 1, (2, frames, 16, 24, 3)).astype(np.float32)
    jvae = JaxVideoAutoencoderKL(JaxVideoVAEConfig.tiny(), dtype=jnp.float32)
    variables = numpy_variables(jvae, jnp.asarray(x), seed=1)
    vae = bridge(variables, VideoAutoencoderKL(VideoVAEConfig.tiny(), torch.float32))
    with torch.no_grad():
        moments = vae.encode_moments(t(x)).numpy()
        mean = vae.encode(t(x)).numpy()
    ref_moments = np.asarray(jvae.apply(variables, jnp.asarray(x), method=JaxVideoAutoencoderKL.encode_moments))
    ref = np.asarray(jvae.apply(variables, jnp.asarray(x), method=JaxVideoAutoencoderKL.encode))
    assert mean.shape == ref.shape == (2, FRAMES[frames], 8, 12, 4)
    assert rel(moments, ref_moments) < F32_REL and rel(mean, ref) < F32_REL
    with torch.no_grad():
        decoded = vae.decode(t(ref)).numpy()
    ref_decoded = np.asarray(jvae.apply(variables, jnp.asarray(ref), method=JaxVideoAutoencoderKL.decode))
    assert decoded.shape == ref_decoded.shape == (2, 1 + 4 * (FRAMES[frames] - 1), 16, 24, 3)
    assert decoded.dtype == np.float32 and rel(decoded, ref_decoded) < F32_REL


def test_sampled_encode_and_bf16_module():
    """``encode`` with a generator draws mean + std * N(0, 1) from it; the
    bf16 module (the trainer's) is within 5e-2 of the f32 one in relative
    L2 (a few bf16-rounded convolutions deep)."""
    x = np.random.default_rng(3).uniform(-1, 1, (1, 5, 16, 16, 3)).astype(np.float32)
    jvae = JaxVideoAutoencoderKL(JaxVideoVAEConfig.tiny(), dtype=jnp.float32)
    variables = numpy_variables(jvae, jnp.asarray(x), seed=2)
    vae = bridge(variables, VideoAutoencoderKL(VideoVAEConfig.tiny(), torch.float32))
    low = bridge(variables, VideoAutoencoderKL(VideoVAEConfig.tiny()))
    with torch.no_grad():
        mean, logvar = vae.encode_moments(t(x)).chunk(2, dim=-1)
        drawn = vae.encode(t(x), torch.Generator().manual_seed(5))
        noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(5))
        assert torch.allclose(drawn, mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * noise, rtol=0, atol=1e-6)
        assert torch.equal(vae.encode(t(x), torch.Generator().manual_seed(5), sample=False), mean)
        assert rel(low.encode(t(x)).float().numpy(), mean.numpy()) < 5e-2


def test_frame_runs_match_the_whole_clip(monkeypatch):
    """The norms' and convolutions' split into runs of frames (what keeps an
    81 x 480 x 832 clip under 2^31 elements a call) against the unsplit
    computation, with budgets small enough to split every call: within
    ``F32_REL`` (the norms' sums run in another order, and a convolution of
    another shape may take another f32 summation order)."""
    x = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (1, 9, 16, 16, 3)).astype(np.float32))
    vae = VideoAutoencoderKL(VideoVAEConfig.tiny(), torch.float32)
    from simpletuner_tpu_torch.models.layers import init_parameters

    init_parameters(vae, torch.Generator().manual_seed(0))
    with torch.no_grad():
        z, frames = vae.encode(x), vae.decode(vae.encode(x))
        calls = []
        original = torch.nn.Conv3d.forward
        monkeypatch.setattr(torch.nn.Conv3d, "forward", lambda self, v: calls.append(v.shape[2]) or original(self, v))
        monkeypatch.setattr(video_vae, "CONV_CHUNK_ELEMENTS", 3000)
        monkeypatch.setattr(video_vae, "NORM_CHUNK_ELEMENTS", 500)
        z_split = vae.encode(x)
        frames_split = vae.decode(z_split)
    assert min(calls) < 3 and max(calls) <= 4  # every convolution ran in runs of frames
    assert rel(z_split.numpy(), z.numpy()) < F32_REL and rel(frames_split.numpy(), frames.numpy()) < F32_REL


# ---- clips, discovery, caches and the collate ------------------------------------------------------------


def test_video_helpers_match_jax(tmp_path, monkeypatch):
    """``data/video.py`` against the JAX module on clips written here: the
    alignment, the probe, the decode (every frame, every other frame, a
    short clip padded with its last frame) bitwise, and ``prepare_video``
    (the JAX side on its PIL branch) bitwise with equal metadata for each
    crop style, then ``video_to_array``."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    for n in (0, 1, 4, 5, 8, 9, 81, 83):
        assert video.align_frame_count(n) == jax_video.align_frame_count(n)
    assert video.VIDEO_EXTENSIONS == jax_video.VIDEO_EXTENSIONS
    assert [video.is_video_path(p) for p in ("a.MP4", "b.mov", "c.png")] == [True, True, False]
    path = write_clip(tmp_path / "clip.mp4", 11, 40, 24)
    backend, jax_backend = LocalDataBackend("v", str(tmp_path)), JaxLocalDataBackend("v", str(tmp_path))
    info = video.probe_video(backend, path)
    assert info == jax_video.probe_video(jax_backend, path) and info["frames"] == 11
    assert (info["width"], info["height"]) == (40, 24)
    for count, interval in ((9, 1), (5, 2), (14, 1)):
        ours = video.load_video_frames(backend, path, count, interval)
        assert ours.shape == (count, 24, 40, 3) and ours.dtype == np.uint8
        assert np.array_equal(ours, jax_video.load_video_frames(jax_backend, path, count, interval))
    frames = video.load_video_frames(backend, path, 9)
    for kwargs, style in ((dict(resolution=32, resolution_type="pixel_area", aspect_bucket_alignment=8), "center"),
                          (dict(resolution=16, resolution_type="pixel", crop=True, crop_aspect="square"), "random"),
                          (dict(resolution=16, resolution_type="pixel", crop=True, crop_aspect="square"), "corner")):
        ours, meta = video.prepare_video(frames, buckets.BucketConfig(**kwargs), style, random.Random(7))
        theirs, jax_meta = jax_video.prepare_video(frames, jax_buckets.BucketConfig(**kwargs), style, random.Random(7))
        assert meta == jax_meta and np.array_equal(ours, theirs), (kwargs, style)
        assert np.array_equal(video.video_to_array(ours), jax_video.video_to_array(theirs))
    assert video.probe_video(backend, str(tmp_path / "missing.mp4")) is None


def _dataset(root):
    """Three clips: two at 48x32 (11 and 9 frames), one at 32x32 (6 frames),
    one too short for ``min_frames`` (3 frames), each with a caption."""
    root.mkdir(parents=True, exist_ok=True)
    for i, (frames, width, height) in enumerate(((11, 48, 32), (9, 48, 32), (6, 32, 32), (3, 32, 32))):
        write_clip(root / f"clip_{i}.mp4", frames, width, height, seed=i)
        (root / f"clip_{i}.txt").write_text(f"clip {i}")
    return str(root)


VIDEO_SETTINGS = {"num_frames": 9, "min_frames": 5}
BUCKETS = dict(resolution=40, resolution_type="pixel_area", aspect_bucket_alignment=16)


def _metadata(cls, backend_cls, bucket_cls, data, tmp_path, name):
    backend = backend_cls("v", data)
    metadata = cls(id="v", data_backend=backend, bucket_config=bucket_cls(**BUCKETS), instance_data_dir=data,
                   cache_file=str(tmp_path / f"{name}.json"), metadata_file=str(tmp_path / f"{name}_meta.json"),
                   dataset_type="video", video_config=dict(VIDEO_SETTINGS))
    metadata.refresh()
    return backend, metadata


def test_discover_video_matches_jax(tmp_path):
    """Bucket keys (aspect x aligned frame count, capped at ``num_frames``),
    per-clip metadata and the skipped short clip, equal to the JAX
    backend's, and the index files each package reads from the other."""
    data = _dataset(tmp_path / "data")
    _, ours = _metadata(MetadataBackend, LocalDataBackend, buckets.BucketConfig, data, tmp_path, "ours")
    _, theirs = _metadata(JaxMetadataBackend, JaxLocalDataBackend, jax_buckets.BucketConfig, data, tmp_path, "theirs")
    assert ours.aspect_ratio_bucket_indices == theirs.aspect_ratio_bucket_indices
    assert ours.image_metadata == theirs.image_metadata
    assert sorted(ours.aspect_ratio_bucket_indices) == ["1.0x5", "1.5x9"]
    assert len(ours.aspect_ratio_bucket_indices["1.5x9"]) == 2
    short = os.path.join(data, "clip_3.mp4")
    assert ours.image_metadata[short] == {"skipped": "too short (3 frames)"}
    reloaded = JaxMetadataBackend(id="v", data_backend=JaxLocalDataBackend("v", data),
                                  bucket_config=jax_buckets.BucketConfig(**BUCKETS), instance_data_dir=data,
                                  cache_file=str(tmp_path / "ours.json"), metadata_file=str(tmp_path / "ours_meta.json"))
    assert reloaded.load_cache() and reloaded.image_metadata == ours.image_metadata


def _encode(clips, count):
    """A stand-in encoder: 4x temporal (causal: frame 0, then every 4th) and
    2x2 spatial mean pooling, 4 channels."""
    clips = np.asarray(clips, np.float32)
    picked = clips[:, ::4]
    b, t_, h, w, c = picked.shape
    pooled = picked.reshape(b, t_, h // 2, 2, w // 2, 2, c).mean(axis=(3, 5))
    return np.concatenate([pooled, pooled[..., :1] ** 2], axis=-1)


def test_vae_cache_and_collate_match_jax(tmp_path, monkeypatch):
    """Each package's cache over the same clips with one stand-in encoder:
    4-D (T', H', W', C) latents bitwise equal, each read by the other
    package's cache, the crop metadata equal; then the collate of one
    sampler batch (5-D latents and the size arrays) equal."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    data = _dataset(tmp_path / "data")
    backend, ours = _metadata(MetadataBackend, LocalDataBackend, buckets.BucketConfig, data, tmp_path, "ours")
    jax_backend, theirs = _metadata(JaxMetadataBackend, JaxLocalDataBackend, jax_buckets.BucketConfig, data,
                                    tmp_path, "theirs")
    cache = VAECache("v", backend, ours, str(tmp_path / "ours_vae"), encode_fn=_encode, crop_style="center",
                     batch_size=2)
    jax_cache = JaxVAECache("v", jax_backend, theirs, str(tmp_path / "theirs_vae"), encode_fn=_encode,
                            crop_style="center", batch_size=2)
    assert cache.process_buckets() == jax_cache.process_buckets() == 3
    assert ours.image_metadata == theirs.image_metadata
    clips = [p for files in ours.aspect_ratio_bucket_indices.values() for p in files]
    for path in clips:
        latents = cache.load(path)
        assert latents.ndim == 4 and np.array_equal(latents, jax_cache.load(path))
        swapped_ours = VAECache("v", backend, ours, str(tmp_path / "theirs_vae"))
        swapped_theirs = JaxVAECache("v", jax_backend, theirs, str(tmp_path / "ours_vae"))
        assert np.array_equal(swapped_ours.load(path), swapped_theirs.load(path))
    frames = ours.image_metadata[clips[0]]["num_frames"]
    assert cache.load(clips[0]).shape[0] == (frames - 1) // 4 + 1

    class Model:
        NAME = "wan"

        @staticmethod
        def collate_text_embeds(embeds):
            return {"text_embeds": np.stack([e["text_embeds"] for e in embeds])}

    class TextCache:
        @staticmethod
        def get(caption):
            return {"text_embeds": np.full((4, 8), len(caption), np.float32)}

    values = {"id": "v", "dataset_type": "video", "instance_data_dir": data, "caption_strategy": "textfile"}
    bucket = "1.5x9"
    samples = [{"image_path": p, "bucket": bucket, "metadata": ours.image_metadata[p]}
               for p in ours.aspect_ratio_bucket_indices[bucket]]
    batch = collate_batch(samples, DatasetBundle("v", DatasetConfig(**values), backend, ours, None, cache, TextCache()),
                          Model())
    jax_batch = jax_collate_batch(samples, JaxDatasetBundle("v", JaxDatasetConfig(**values), jax_backend, theirs, None,
                                                            jax_cache, TextCache()), Model())
    assert batch["latents"].shape == (2, 3, 16, 24, 4) and batch["captions"] == jax_batch["captions"]
    for key, value in jax_batch.items():
        if isinstance(value, np.ndarray):
            assert np.array_equal(batch[key], value), key
