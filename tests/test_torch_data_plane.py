"""The port's data plane against the JAX package's, on the CPU.

The same image directory, seed and config go through the JAX
``configure_multi_databackend`` and the port's, each with its own caches
(the JAX host ``native/`` image path turned off, as the port has only the
PIL path).  Both sides encode with the same stand-in encoders (numpy
functions of the pixels and of the caption), so the latents and embeds of
the two planes are bitwise comparable; the real encoders are held by the
caching and encoder tests.  Over three epochs of two weighted datasets with
random crops and caption dropout, the batch sequences agree exactly: files,
buckets, crop coordinates, sizes, captions, latents and embeds, and the
masks Flux collates.  ``DataPlane.save_state()`` is equal as JSON, and each
side continues from the other's state as it continues from its own.
"""

import hashlib
import json
import os

import numpy as np
import pytest
from PIL import Image

from simpletuner_tpu import native as jax_native
from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.data import factory as jax_factory
from simpletuner_tpu.models.flux.model import Flux as JaxFlux

from simpletuner_tpu_torch.configuration import TrainingConfig
from simpletuner_tpu_torch.data import factory
from simpletuner_tpu_torch.models.flux import Flux

# (width, height): square, landscape and portrait sources, so the aspect
# buckets differ and random crops move
SIZES = [(96, 96), (128, 96), (96, 128), (120, 100), (100, 120)]
BATCH_KEYS = ("latents", "t5_embeds", "pooled_embeds", "t5_masks", "crop_coordinates", "original_sizes",
              "target_sizes")


def stand_in_latents(images, count):
    """(B, H, W, 3) f32 pixels -> (B, H/8, W/8, 4): 8x8 means and a product channel."""
    images = np.asarray(images, np.float32)
    b, h, w, _ = images.shape
    pooled = images.reshape(b, h // 8, 8, w // 8, 8, 3).mean(axis=(2, 4))
    return np.concatenate([pooled, pooled[..., :1] * pooled[..., 1:2]], axis=-1).astype(np.float32)


def stand_in_encode_text(prompts):
    """The Flux payload of each prompt, drawn from a generator seeded by its md5."""
    out = []
    for prompt in prompts:
        rng = np.random.default_rng(int(hashlib.md5(prompt.encode()).hexdigest()[:8], 16))
        mask = np.zeros(16, np.int32)
        mask[: min(len(prompt.split()) + 1, 16)] = 1
        out.append({"t5_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                    "pooled_embeds": rng.standard_normal(32).astype(np.float32), "attention_mask": mask})
    return out


def _write_dataset(directory, count, seed):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(count):
        w, h = SIZES[i % len(SIZES)]
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(os.path.join(directory, f"s{i}.png"))
        words = " ".join(rng.choice(["red", "cat", "tall", "tree", "sky", "old"], size=1 + i % 4))
        with open(os.path.join(directory, f"s{i}.txt"), "w") as handle:
            handle.write(f"{words}, photo {i}")


def _values(tmp_path, side):
    # "a": random square crops; "b": uncropped, in aspect buckets
    dataset = dict(type="local", dataset_type="image", resolution=64, resolution_type="pixel_area",
                   aspect_bucket_alignment=16,
                   caption_strategy="textfile", repeats=1)
    return {
        "model_family": "flux", "model_arch_preset": "tiny", "seed": 11, "train_batch_size": 2,
        "caption_dropout_probability": 0.25, "cache_dir": str(tmp_path / side / "cache"),
        "data_backend_config": [
            {**dataset, "id": "a", "instance_data_dir": str(tmp_path / "a"), "crop": True, "crop_style": "random",
             "crop_aspect": "square",
             "cache_dir_vae": str(tmp_path / side / "vae_a")},
            {**dataset, "id": "b", "instance_data_dir": str(tmp_path / "b"), "probability": 2.0,
             "cache_dir_vae": str(tmp_path / side / "vae_b")},
            {"id": "text", "type": "local", "dataset_type": "text_embeds", "default": True,
             "cache_dir": str(tmp_path / side / "text")},
        ],
    }


def _drop_metadata(tmp_path):
    """Remove the bucket index files the last plane wrote into the data dirs,
    so the next plane builds its own."""
    for sub in ("a", "b"):
        for name in os.listdir(tmp_path / sub):
            if name.startswith("aspect_ratio_bucket"):
                os.remove(tmp_path / sub / name)


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("planes")
    _write_dataset(tmp_path / "a", 7, seed=1)
    _write_dataset(tmp_path / "b", 5, seed=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        jax_config = JaxTrainingConfig(_values(tmp_path, "jax"))
        jax_model = JaxFlux(jax_config)
        mp.setattr(jax_model, "encode_text", stand_in_encode_text, raising=False)
        mp.setattr(jax_model, "text_encoders", [], raising=False)  # the factory encodes when the model has some
        theirs = jax_factory.configure_multi_databackend(jax_config, jax_model, vae_encode_fn=stand_in_latents)
    _drop_metadata(tmp_path)
    config = TrainingConfig(_values(tmp_path, "port"))
    model = Flux(config)
    model.encode_text = stand_in_encode_text
    ours = factory.configure_multi_databackend(config, model, vae_encode_fn=stand_in_latents)
    return ours, theirs


def _assert_same_batch(ours, theirs):
    assert ours["dataset_id"] == theirs["dataset_id"] and ours["bucket"] == theirs["bucket"]
    assert ours["image_paths"] == theirs["image_paths"] and ours["captions"] == theirs["captions"]
    assert sorted(k for k, v in ours.items() if isinstance(v, np.ndarray)) == \
        sorted(k for k, v in theirs.items() if isinstance(v, np.ndarray))
    for key in BATCH_KEYS:
        a, b = np.asarray(ours[key]), np.asarray(theirs[key])
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), key


def test_three_epochs_match_jax(planes):
    ours, theirs = planes
    assert sorted(ours.bundles) == sorted(theirs.bundles) == ["a", "b"]
    for bundle_id in ("a", "b"):
        assert ours.bundles[bundle_id].metadata_backend.aspect_ratio_bucket_indices == \
            theirs.bundles[bundle_id].metadata_backend.aspect_ratio_bucket_indices
    assert ours.save_state() == theirs.save_state()
    buckets, dropped, count = set(), 0, 0
    while theirs.iterator.epoch < 3:
        step = count
        a, b = ours.iterator.next_batch(step=step), theirs.iterator.next_batch(step=step)
        _assert_same_batch(a, b)
        assert ours.iterator.epoch == theirs.iterator.epoch
        buckets.add((a["dataset_id"], a["bucket"]))
        dropped += a["captions"].count("")
        count += 1
    crops = {tuple(c) for bundle in ours.bundles.values() for c in
             (m.get("crop_coordinates") for m in bundle.metadata_backend.image_metadata.values()) if c}
    # both datasets, several buckets, moved crops, dropout ran
    assert count > 12 and len(buckets) >= 4 and len(crops) > 2 and dropped > 0
    assert json.dumps(ours.save_state(), sort_keys=True) == json.dumps(theirs.save_state(), sort_keys=True)
    assert ours.tag_frequency() == theirs.tag_frequency() and ours.trigger_words() == theirs.trigger_words()


def test_each_side_continues_from_the_others_state(planes):
    ours, theirs = planes
    for _ in range(5):  # mid-epoch
        _assert_same_batch(ours.iterator.next_batch(), theirs.iterator.next_batch())
    state_ours, state_theirs = ours.save_state(), theirs.save_state()
    assert json.dumps(state_ours, sort_keys=True) == json.dumps(state_theirs, sort_keys=True)
    expected = [ours.iterator.next_batch() for _ in range(6)]
    theirs_ahead = [theirs.iterator.next_batch() for _ in range(6)]
    for a, b in zip(expected, theirs_ahead):
        _assert_same_batch(a, b)
    ours.load_state(json.loads(json.dumps(state_theirs)))
    theirs.load_state(json.loads(json.dumps(state_ours)))
    for batch in expected:
        _assert_same_batch(ours.iterator.next_batch(), batch)
        _assert_same_batch(theirs.iterator.next_batch(), batch)


def test_unported_datasets_are_refused(tmp_path):
    values = _values(tmp_path, "port")
    model = Flux(TrainingConfig(values))
    tokens = tmp_path / "tokens"
    tokens.mkdir()
    np.save(tokens / "song.npy", np.zeros((50, 8), np.int64))
    cases = [
        ({"type": "memory"}, "item 4e"),
        ({"dataset_type": "conditioning"}, "item 4f"),
        # video and audio datasets are built (tests/test_torch_video.py, test_torch_audio.py); codec-token
        # audio datasets (HeartMuLa's) are refused
        ({"dataset_type": "audio", "instance_data_dir": str(tokens)}, "item 3"),
        ({"dataset_type": "caption"}, "item 4f"),  # eval datasets are built (tests/test_torch_evaluation.py)
        ({"vae_cache_ondemand": True}, "item 4e"),
        ({"conditioning_data": ["b"]}, "item 4f"),
    ]
    for change, item in cases:
        broken = json.loads(json.dumps(values))
        broken["data_backend_config"][0].update(change)
        with pytest.raises(NotImplementedError, match=item):
            factory.configure_multi_databackend(TrainingConfig(broken), model, vae_encode_fn=stand_in_latents)
    with pytest.raises(NotImplementedError, match="item 4e"):
        factory.configure_multi_databackend(TrainingConfig({**values, "enable_nsfw_check": True}), model)
