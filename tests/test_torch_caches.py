"""The port's caching path against the JAX package's, on the CPU.

Bucket math, the metadata backend and image preparation (the JAX PIL path,
``use_native=False``) on PNG and JPEG files written here must agree exactly.
``VAECache.process_buckets`` runs on both sides over the same images with the
same tiny VAE weights (the JAX host ``native/`` path turned off): the same
``.pt`` names, the same crop metadata, latents within f32 sum order.
``TextEmbeddingCache.compute_embeddings_for_prompts`` writes the same names
and payloads as the JAX cache, with the dedup and the rank split.
"""

import hashlib
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from simpletuner_tpu import native as jax_native
from simpletuner_tpu.caching.text_embeds import TextEmbeddingCache as JaxTextEmbeddingCache
from simpletuner_tpu.caching.vae_cache import VAECache as JaxVAECache
from simpletuner_tpu.data import buckets as jax_buckets
from simpletuner_tpu.data.backends.local import LocalDataBackend as JaxLocalDataBackend
from simpletuner_tpu.data.metadata import MetadataBackend as JaxMetadataBackend
from simpletuner_tpu.data.training_sample import image_to_array as jax_image_to_array
from simpletuner_tpu.data.training_sample import prepare_image as jax_prepare_image
from simpletuner_tpu.data.training_sample import prepare_like as jax_prepare_like
from simpletuner_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from simpletuner_tpu.models.vae import VAEConfig as JaxVAEConfig

from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
from simpletuner_tpu_torch.caching.vae_cache import VAECache
from simpletuner_tpu_torch.data import buckets
from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
from simpletuner_tpu_torch.data.metadata import MetadataBackend
from simpletuner_tpu_torch.data.training_sample import image_to_array, prepare_image, prepare_like
from simpletuner_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from simpletuner_tpu_torch.training.trainer import vae_encode_fn

from torch_parity import bridge, numpy_variables, rel

SIZES = [(96, 64), (64, 96), (80, 80), (123, 45), (45, 123), (200, 150), (64, 64), (33, 47)]

CONFIGS = [
    dict(resolution=64, resolution_type="pixel_area"),
    dict(resolution=64, resolution_type="pixel"),
    dict(resolution=0.004, resolution_type="area", aspect_bucket_alignment=16),
    dict(resolution=64, crop=True, crop_aspect="square"),
    dict(resolution=64, crop=True, crop_aspect="preserve", aspect_bucket_alignment=8),
    dict(resolution=64, crop=True, crop_aspect="closest", crop_aspect_buckets=[0.75, 1.0, 1.5]),
    dict(resolution=64, crop=True, crop_aspect="random", crop_aspect_buckets=[{"aspect": 0.75, "weight": 2},
                                                                              {"aspect": 1.5, "weight": 1}]),
    dict(resolution=64, crop=True, crop_aspect="closest", crop_aspect_buckets=[0.5, 2.0], max_upscale_threshold=0.1),
    dict(resolution=64, minimum_image_size=60, minimum_aspect_ratio=0.5, maximum_aspect_ratio=2.0),
]


@pytest.mark.parametrize("kwargs", CONFIGS, ids=range(len(CONFIGS)))
def test_bucket_math_matches_jax(kwargs):
    ours, theirs = buckets.BucketConfig(**kwargs), jax_buckets.BucketConfig(**kwargs)
    assert ours.target_area == theirs.target_area
    for width, height in SIZES:
        token = f"img_{width}x{height}.png"
        assert buckets.bucket_key_for_size(width, height, ours, token) == \
            jax_buckets.bucket_key_for_size(width, height, theirs, token)
        assert buckets.image_passes_constraints(width, height, ours) == \
            jax_buckets.image_passes_constraints(width, height, theirs)
        aspect = width / height
        assert buckets.target_size_for_aspect(aspect, ours) == jax_buckets.target_size_for_aspect(aspect, theirs)
        if ours.crop_aspect_buckets:
            assert buckets.select_crop_aspect(width, height, ours, token) == \
                jax_buckets.select_crop_aspect(width, height, theirs, token)
        assert buckets.latent_size(width, height) == jax_buckets.latent_size(width, height)
        assert buckets.video_bucket_key(width, height, 9, ours) == jax_buckets.video_bucket_key(width, height, 9, theirs)


def _write_images(directory, count=9, seed=0):
    """PNGs and JPEGs (one with an EXIF rotation), in a subfolder too."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory / "sub", exist_ok=True)
    paths = []
    for i in range(count):
        width, height = SIZES[i % len(SIZES)]
        pixels = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        folder = directory / "sub" if i % 3 == 2 else directory
        path = folder / (f"img_{i}.png" if i % 2 else f"img_{i}.jpg")
        image = Image.fromarray(pixels)
        if i == 4:
            exif = image.getexif()
            exif[0x0112] = 6  # rotated 90 degrees: displayed width and height swap
            image.save(path, exif=exif)
        else:
            image.save(path)
        paths.append(str(path))
    (directory / "broken.png").write_bytes(b"not an image")
    return paths


def test_metadata_matches_jax(tmp_path):
    _write_images(tmp_path / "data")
    data = str(tmp_path / "data")
    config = dict(resolution=64, resolution_type="pixel_area", minimum_image_size=40)
    ours = MetadataBackend("m", LocalDataBackend("m", instance_data_dir=data), buckets.BucketConfig(**config),
                           instance_data_dir=data, cache_file=str(tmp_path / "ours.json"),
                           metadata_file=str(tmp_path / "ours_meta.json"))
    theirs = JaxMetadataBackend("m", JaxLocalDataBackend("m", instance_data_dir=data),
                                jax_buckets.BucketConfig(**config), instance_data_dir=data,
                                cache_file=str(tmp_path / "theirs.json"),
                                metadata_file=str(tmp_path / "theirs_meta.json"))
    assert ours.refresh() == theirs.refresh()
    assert ours.image_metadata == theirs.image_metadata and len(ours) == len(theirs) > 0
    assert ours.bucket_keys() == theirs.bucket_keys()
    assert ours.split_buckets_between_processes(1, 2) == theirs.split_buckets_between_processes(1, 2)
    assert open(tmp_path / "ours_meta.json").read() == open(tmp_path / "theirs_meta.json").read()
    reloaded = MetadataBackend("m", LocalDataBackend("m"), buckets.BucketConfig(**config), instance_data_dir=data,
                               cache_file=str(tmp_path / "theirs.json"),
                               metadata_file=str(tmp_path / "theirs_meta.json"))
    assert reloaded.load_cache() and reloaded.aspect_ratio_bucket_indices == theirs.aspect_ratio_bucket_indices


PREPARE = [
    (dict(resolution=64), "center"),
    (dict(resolution=64, crop=True, crop_aspect="square"), "center"),
    (dict(resolution=64, crop=True, crop_aspect="square"), "corner"),
    (dict(resolution=64, crop=True, crop_aspect="preserve"), "random"),
    (dict(resolution=48, crop=True, crop_aspect="square", target_downsample_size=80), "random"),
    (dict(resolution=64, crop=True, crop_aspect="square"), "face"),
]


@pytest.mark.parametrize("kwargs,style", PREPARE, ids=range(len(PREPARE)))
def test_prepare_image_matches_jax_pil_path(tmp_path, monkeypatch, kwargs, style):
    monkeypatch.setattr(jax_native, "available", lambda: False)  # image_to_array's numpy path too
    paths = _write_images(tmp_path)
    for path in paths:
        ours = prepare_image(Image.open(path), buckets.BucketConfig(**kwargs), style, random.Random(path))
        theirs = jax_prepare_image(Image.open(path), jax_buckets.BucketConfig(**kwargs), style, random.Random(path),
                                   use_native=False)
        for field in ("original_size", "target_size", "intermediary_size", "crop_coordinates", "aspect_ratio",
                      "bucket_key"):
            assert getattr(ours, field) == getattr(theirs, field), (path, field)
        assert np.array_equal(np.asarray(ours.image), np.asarray(theirs.image)), path
        other = Image.open(paths[0])
        like, jax_like = prepare_like(other, ours), jax_prepare_like(other, theirs)
        assert np.array_equal(np.asarray(like.image), np.asarray(jax_like.image))
        assert like.crop_coordinates == jax_like.crop_coordinates
        assert np.array_equal(image_to_array(ours.image), jax_image_to_array(theirs.image))
        assert np.array_equal(image_to_array(ours.image, normalize=False),
                              jax_image_to_array(theirs.image, normalize=False))


def _jax_encode_fn(jvae, variables):
    """The JAX trainer's encode function (trainer.py:298-335) on the uint8 path."""
    jitted = jax.jit(lambda p, x: jvae.apply(p, x.astype(jnp.float32) / 127.5 - 1.0,
                                             method=JaxAutoencoderKL.encode).astype(jnp.float32))

    def encode(images, count):
        return jitted(variables, images)

    encode.handles_uint8 = True
    return encode


def test_vae_cache_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)  # the JAX PIL path, as the port has it
    paths = _write_images(tmp_path / "data", count=12)
    data = str(tmp_path / "data")
    config = dict(resolution=32, resolution_type="pixel_area", crop=True, crop_aspect="preserve")
    jvae = JaxAutoencoderKL(JaxVAEConfig.tiny())
    variables = numpy_variables(jvae, np.zeros((1, 16, 16, 3), np.float32), seed=3)
    vae = bridge(variables, AutoencoderKL(VAEConfig.tiny()))

    def run(side):
        jax_side = side == "jax"
        Backend, Meta, Cache, Config = ((JaxLocalDataBackend, JaxMetadataBackend, JaxVAECache, jax_buckets.BucketConfig)
                                        if jax_side else (LocalDataBackend, MetadataBackend, VAECache,
                                                          buckets.BucketConfig))
        backend = Backend(side, instance_data_dir=data)
        metadata = Meta(side, backend, Config(**config), instance_data_dir=data,
                        cache_file=str(tmp_path / f"{side}.json"), metadata_file=str(tmp_path / f"{side}_meta.json"))
        metadata.refresh()
        encode = _jax_encode_fn(jvae, variables) if jax_side else vae_encode_fn(vae, torch.device("cpu"))
        cache = Cache(side, backend, metadata, str(tmp_path / f"cache_{side}"), encode_fn=encode, batch_size=3,
                      crop_style="random", transfer_dtype="uint8", max_workers=2)
        done = cache.process_buckets()
        files = sorted(os.path.relpath(os.path.join(d, f), str(tmp_path / f"cache_{side}"))
                       for d, _, names in os.walk(str(tmp_path / f"cache_{side}")) for f in names)
        return done, files, {p: cache.load(p) for p in paths}, metadata.image_metadata

    done, files, latents, meta = run("port")
    jax_done, jax_files, jax_latents, jax_meta = run("jax")
    readable = len(paths)
    assert done == jax_done == readable  # the broken file is not an image at all: not listed
    assert files == jax_files and any(name.startswith("sub" + os.sep) for name in files)
    assert files[0].endswith(".pt") and len(files[0].split(os.sep)[-1]) == 64 + 3  # sha256 names
    assert meta == jax_meta
    for path in paths:
        assert latents[path].dtype == jax_latents[path].dtype == np.float32
        assert latents[path].shape == jax_latents[path].shape
        assert rel(latents[path], jax_latents[path]) < 1e-5  # f32 convs: sum order only


def _payload(prompt):
    """A deterministic per-prompt payload (md5-seeded), the same on both sides."""
    seed = int(hashlib.md5(str(prompt).encode()).hexdigest()[:8], 16)
    rng = np.random.default_rng(seed)
    return {"t5_embeds": rng.standard_normal((8, 4), dtype=np.float32),
            "pooled_embeds": rng.standard_normal(4, dtype=np.float32),
            "attention_mask": (np.arange(8) < 3).astype(np.int32)}


@pytest.mark.parametrize("rank", [(0, 1), (1, 2)])
def test_text_cache_compute_matches_jax(tmp_path, rank):
    prompts = ["a cat", "a dog", "a cat", None, "", "a bird on a wire", "x" * 300]
    calls = {"port": [], "jax": []}

    def encoder(side):
        def encode(batch):
            calls[side].append(list(batch))
            return [_payload(p) for p in batch]
        return encode

    ours = TextEmbeddingCache("t", LocalDataBackend("t"), str(tmp_path / "port"), "flux", encode_fn=encoder("port"),
                              batch_size=2)
    theirs = JaxTextEmbeddingCache("t", JaxLocalDataBackend("t"), str(tmp_path / "jax"), "flux",
                                   encode_fn=encoder("jax"), batch_size=2)
    kwargs = dict(process_index=rank[0], num_processes=rank[1])
    ours.compute_embeddings_for_prompts(prompts, **kwargs)
    theirs.compute_embeddings_for_prompts(prompts, **kwargs)
    assert calls["port"] == calls["jax"] and calls["port"]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        a = LocalDataBackend("x").torch_load(str(tmp_path / "port" / name))
        b = JaxLocalDataBackend("x").torch_load(str(tmp_path / "jax" / name))
        assert sorted(a) == sorted(b) and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in b)
    # a second pass encodes nothing; on demand, a new prompt is encoded and written
    ours.compute_embeddings_for_prompts(prompts, **kwargs)
    assert len(calls["port"]) == len(calls["jax"])
    fetched = ours.get("a new prompt")
    assert np.array_equal(fetched["t5_embeds"], _payload("a new prompt")["t5_embeds"]) and ours.exists("a new prompt")
    back = ours.compute_embeddings_for_prompts(["a new prompt"], return_embeds=True)
    assert np.array_equal(back[0]["pooled_embeds"], _payload("a new prompt")["pooled_embeds"])
    with pytest.raises(RuntimeError, match="no encoder"):
        TextEmbeddingCache("t", LocalDataBackend("t"), str(tmp_path / "none"), "flux").compute_embeddings_for_prompts(["z"])
