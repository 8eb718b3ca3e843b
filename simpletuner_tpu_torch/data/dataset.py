"""Collate + multi-dataset iteration.

Counterpart of ``simpletuner_tpu/data/dataset.py``: ``DatasetBundle``,
``collate_batch`` for image, video and audio datasets with cached latents
(4-D clips stack to 5-D (B, T', H', W', C) batches, audio latents to (B, S',
C)) and text embeds (the cache reads on threads, the caption and its
dropout, the family's ``collate_text_embeds``, the speech-to-video pairing
(a dataset's ``audio: {pair_with_video: true}``: each clip's same-stem WAV
at ``sample_rate`` through ``waveform_features``, cut or zero-padded to
``max_feature_frames``, as ``audio_embeds``), the size conditioning arrays,
the regularisation flag and the family's ``collate_batch_extras`` hook, in
the JAX order) and ``MultiDatasetIterator`` (weighted round-robin with
schedule windows, epoch rollover, JSON-safe state), line for line where
ported.  Output batches are numpy dicts with static shapes per bucket (a
video bucket's key carries its frame count, ``"1.73x81"``, an audio
bucket's its seconds, ``"47s"``).  Caption-only, codec-token (HeartMuLa),
conditioning-paired (ControlNet / edit / loss masks) and image-embed batches
and text-encoder token batches raise, naming their ROADMAP item; the
per-process slice of a multi-process run is ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .captions import get_caption
from .sampler import MultiAspectSampler


class DatasetBundle:
    """Everything one primary dataset needs at train time."""

    def __init__(
        self,
        id: str,
        config,  # DatasetConfig
        data_backend,
        metadata_backend,
        sampler: MultiAspectSampler,
        vae_cache=None,
        text_cache=None,
    ):
        self.id = id
        self.config = config
        self.data_backend = data_backend
        self.metadata_backend = metadata_backend
        self.sampler = sampler
        self.vae_cache = vae_cache
        self.text_cache = text_cache


def check_collatable(bundle: DatasetBundle, model) -> None:
    """Refuse the batches ``collate_batch`` does not build (the JAX branches
    that are not ported)."""
    cfg = bundle.config
    if cfg.dataset_type not in ("image", "video", "audio", "eval"):
        raise NotImplementedError(
            f"dataset {bundle.id!r}: {cfg.dataset_type} batches are not ported (ROADMAP Queue 1 item 4f)")
    if cfg.dataset_type == "audio" and any(
            meta.get("token_file") for meta in bundle.metadata_backend.image_metadata.values()):
        raise NotImplementedError(f"dataset {bundle.id!r}: codec-token audio batches (HeartMuLa) are not ported "
                                  "(ROADMAP Queue 1 item 3)")
    if getattr(model, "trains_text_encoder", False):
        raise NotImplementedError("text-encoder token batches are not ported (ROADMAP Queue 1 item 4i)")
    if cfg.conditioning_data:
        raise NotImplementedError(
            f"dataset {bundle.id!r}: conditioning_data pairing is not ported (ROADMAP Queue 1 item 4f)")
    if cfg.conditioning_image_embeds:
        raise NotImplementedError(
            f"dataset {bundle.id!r}: conditioning_image_embeds is not ported (ROADMAP Queue 1 item 4f)")


def collate_batch(
    samples: List[Dict[str, Any]],
    bundle: DatasetBundle,
    model,
    caption_dropout_probability: float = 0.0,
    rng: Optional[random.Random] = None,
    max_workers: int = 8,
) -> Dict[str, Any]:
    """Fetch cached latents + text embeds for one sampler batch and stack."""
    rng = rng or random
    cfg = bundle.config
    check_collatable(bundle, model)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        latents = list(pool.map(lambda s: bundle.vae_cache.get(s["image_path"]), samples))

    captions = []
    for sample in samples:
        caption = get_caption(
            sample["image_path"],
            bundle.data_backend,
            strategy=cfg.caption_strategy,
            instance_prompt=cfg.instance_prompt,
            prepend_instance_prompt=cfg.prepend_instance_prompt,
            only_instance_prompt=cfg.only_instance_prompt,
            metadata_row=sample.get("metadata", {}).get("row"),
            parquet_config=cfg.parquet,
        )
        if caption_dropout_probability and rng.random() < caption_dropout_probability:
            caption = ""
        captions.append(caption)

    batch: Dict[str, Any] = {
        "latents": np.stack(latents).astype(np.float32),
        "captions": captions,
        "dataset_id": bundle.id,
        "bucket": samples[0]["bucket"],
        "image_paths": [s["image_path"] for s in samples],
    }
    embeds = [bundle.text_cache.get(c) for c in captions]
    batch.update(model.collate_text_embeds(embeds))

    # speech-to-video pairing: each clip's same-stem .wav becomes its audio
    # features; a clip without one drops the features of the whole batch, as
    # in the JAX collate
    audio_cfg = getattr(cfg, "audio", None) or {}
    if audio_cfg.get("pair_with_video"):
        from .audio import load_audio, waveform_features

        sample_rate = int(audio_cfg.get("sample_rate", 16000))
        max_frames = int(audio_cfg.get("max_feature_frames", 128))
        features = []
        for sample in samples:
            wave = load_audio(bundle.data_backend, os.path.splitext(sample["image_path"])[0] + ".wav",
                              sample_rate=sample_rate)
            if wave is None:
                features = []
                break
            feats = waveform_features(wave, sample_rate=sample_rate)
            if feats.shape[0] >= max_frames:
                feats = feats[:max_frames]
            else:
                feats = np.pad(feats, ((0, max_frames - feats.shape[0]), (0, 0)))
            features.append(feats)
        if features:
            batch["audio_embeds"] = np.stack(features)

    # size conditioning (SDXL/PixArt time-ids; reference collate.py)
    metas = [s.get("metadata", {}) for s in samples]
    if all("original_size" in m for m in metas):
        batch["original_sizes"] = np.asarray([m["original_size"] for m in metas], np.int32)
    if all("crop_coordinates" in m for m in metas):
        batch["crop_coordinates"] = np.asarray([m["crop_coordinates"] for m in metas], np.int32)
    if all("target_size" in m for m in metas):
        batch["target_sizes"] = np.asarray([m["target_size"] for m in metas], np.int32)
    if getattr(cfg, "is_regularisation_data", False):
        # prior-preservation flag; the port's train step refuses it
        batch["is_regularisation_data"] = np.asarray(1.0, np.float32)
    # the family's extras (ACE-Step's lyric ids from parquet rows or sidecar files)
    collate_extras = getattr(model, "collate_batch_extras", None)
    if collate_extras is not None:
        collate_extras(samples, bundle, batch)
    return batch


class MultiDatasetIterator:
    """Weighted sampling over multiple datasets with schedule windows and
    epoch-exhaustion tracking (reference dataloader_iterator.py)."""

    def __init__(
        self,
        bundles: Sequence[DatasetBundle],
        model,
        caption_dropout_probability: float = 0.0,
        seed: int = 42,
    ):
        if not bundles:
            raise ValueError("no datasets to iterate")
        self.bundles = list(bundles)
        self.model = model
        self.caption_dropout_probability = caption_dropout_probability
        self.rng = random.Random(seed)
        self._iters: Dict[str, Iterator] = {}
        self._exhausted: set = set()
        self.epoch = 0

    def _weight(self, bundle: DatasetBundle) -> float:
        if bundle.config.dataset_weight is not None:
            return float(bundle.config.dataset_weight)
        # --data_backend_sampling (reference get_backend_weight,
        # factory.py:4973): "uniform" ignores dataset size; "auto-weighting"
        # scales selection by sample count so large datasets are not starved
        mode = str(getattr(self.model.config, "data_backend_sampling", "uniform")
                   or "uniform").replace("_", "-")
        if mode == "auto-weighting" and bundle.config.probability is None:
            try:
                size = float(len(bundle.sampler))
            except TypeError:
                size = 1.0
            return max(size, 1.0)
        return float(bundle.config.probability or 1.0)

    def _active_bundles(self, step: int) -> List[DatasetBundle]:
        active = []
        for bundle in self.bundles:
            c = bundle.config
            if c.start_step is not None and step < c.start_step:
                continue
            if c.end_step is not None and step >= c.end_step:
                continue
            if c.start_epoch is not None and self.epoch < c.start_epoch:
                continue
            if c.end_epoch is not None and self.epoch >= c.end_epoch:
                continue
            active.append(bundle)
        return active or list(self.bundles)

    def _next_from(self, bundle: DatasetBundle) -> Optional[List[Dict[str, Any]]]:
        it = self._iters.get(bundle.id)
        if it is None:
            it = iter(bundle.sampler)
            self._iters[bundle.id] = it
        try:
            return next(it)
        except StopIteration:
            self._exhausted.add(bundle.id)
            self._iters[bundle.id] = None
            return None

    def __next__(self) -> Dict[str, Any]:
        return self.next_batch(step=0)

    def next_batch(self, step: int = 0) -> Dict[str, Any]:
        """Returns one collated batch; rolls the epoch when all datasets exhaust."""
        for _ in range(len(self.bundles) * 2 + 2):
            candidates = [b for b in self._active_bundles(step) if b.id not in self._exhausted]
            if not candidates:
                # epoch rollover: all datasets exhausted
                self.epoch += 1
                self._exhausted.clear()
                self._iters.clear()
                candidates = self._active_bundles(step)
            weights = [self._weight(b) for b in candidates]
            bundle = self.rng.choices(candidates, weights=weights, k=1)[0]
            samples = self._next_from(bundle)
            if samples is not None:
                return collate_batch(samples, bundle, self.model, self.caption_dropout_probability, self.rng)
        sizes = {
            b.id: f"{sum(len(v) for v in b.metadata_backend.aspect_ratio_bucket_indices.values())}"
            f" files (batch_size {b.sampler.batch_size}, repeats {b.config.repeats})"
            for b in self.bundles
        }
        raise RuntimeError(
            "no dataset produced a full batch; every bucket must hold at least "
            f"batch_size files per epoch (raise `repeats` or shrink the batch): {sizes}"
        )

    def save_state(self) -> Dict[str, Any]:
        version, internal, gauss = self.rng.getstate()
        return {
            "epoch": self.epoch,
            "exhausted": sorted(self._exhausted),
            "samplers": {b.id: b.sampler.save_state() for b in self.bundles},
            # bundle-selection RNG (JSON-safe form): without it a resume
            # replays a different dataset-interleaving than the original run
            "rng": [version, list(internal), gauss],
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        self.epoch = state.get("epoch", 0)
        self._exhausted = set(state.get("exhausted", []))
        # live generators hold pre-restore cursors; drop them so the next
        # draw re-derives from the restored sampler state (deterministic,
        # keyed on (seed, epoch, draws))
        self._iters.clear()
        rng_state = state.get("rng")
        if rng_state:
            version, internal, gauss = rng_state
            self.rng.setstate((version, tuple(internal), gauss))
        samplers = state.get("samplers", {})
        for bundle in self.bundles:
            if bundle.id in samplers:
                bundle.sampler.load_state(samplers[bundle.id])
