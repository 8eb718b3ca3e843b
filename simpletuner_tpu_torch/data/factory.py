"""Data-backend factory: multidatabackend.json -> live data plane.

Counterpart of ``simpletuner_tpu/data/factory.py``:
``configure_multi_databackend`` (parse the dataloader config, build storage,
metadata, sampler and caches per dataset, run the text-embed and VAE caching
passes, assemble the iterator), ``DataPlane`` (``save_state`` /
``load_state``, ``tag_frequency``, ``trigger_words``), ``build_storage_backend``
and ``bucket_config_for``.  Ported: local image and video datasets and
``text_embeds`` datasets over the port's ``LocalDataBackend``,
``MetadataBackend`` (a video dataset's ``video`` settings reach its
discovery), ``VAECache`` and ``TextEmbeddingCache``, in the JAX order and with
the JAX arguments; audio datasets (``dataset_type: audio``, their
``audio`` settings in the metadata backend's ``video_config`` slot, as the
JAX factory passes them) through the audio VAE's cache.  Refused, naming
their ROADMAP item: other storage backends (memory, S3, CSV, Hugging Face,
webshart) and streaming datasets, the parquet metadata backend, on-demand and
unhashed caches, the NSFW filter, conditioning / caption / distillation
datasets and image-embed caches.  Eval datasets (``dataset_type: eval``) are built and
cached as image datasets; they, and the datasets ``eval_dataset_id`` names,
stay out of the train iterator (the eval loss reads them).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional

from ..caching.text_embeds import TextEmbeddingCache
from ..caching.vae_cache import VAECache
from ..configuration.dataloader import DatasetConfig, get_default_text_embed_id, load_dataloader_config
from .backends.base import BaseDataBackend
from .backends.local import LocalDataBackend
from .buckets import BucketConfig
from .captions import get_caption
from .dataset import DatasetBundle, MultiDatasetIterator, check_collatable
from .metadata import MetadataBackend
from .sampler import MultiAspectSampler
from ..training.evaluation import eval_dataset_id_set

logger = logging.getLogger(__name__)


def build_storage_backend(config: DatasetConfig, compress_cache: bool = False) -> BaseDataBackend:
    if config.type == "local":
        return LocalDataBackend(config.id, config.instance_data_dir, compress_cache)
    if config.type in ("memory", "aws", "csv", "huggingface", "webshart"):
        raise NotImplementedError(
            f"dataset {config.id!r}: storage backend type {config.type!r} is not ported (ROADMAP Queue 1 item 4e)")
    raise ValueError(f"unsupported storage backend type {config.type!r}")


def bucket_config_for(config: DatasetConfig, args) -> BucketConfig:
    return BucketConfig(
        resolution=config.resolution or args.get("resolution", 1024),
        resolution_type=config.resolution_type or args.get("resolution_type", "pixel_area"),
        aspect_bucket_rounding=config.aspect_bucket_rounding or args.get("aspect_bucket_rounding", 2) or 2,
        aspect_bucket_alignment=config.aspect_bucket_alignment or args.get("aspect_bucket_alignment", 64) or 64,
        minimum_image_size=config.minimum_image_size,
        maximum_image_size=config.maximum_image_size,
        target_downsample_size=config.target_downsample_size,
        minimum_aspect_ratio=config.minimum_aspect_ratio,
        maximum_aspect_ratio=config.maximum_aspect_ratio,
        crop=bool(config.crop),
        crop_aspect=config.crop_aspect or "square",
        crop_aspect_buckets=config.crop_aspect_buckets,
        square_padding=bool(config.square_padding),
        max_upscale_threshold=(
            config.max_upscale_threshold
            if config.max_upscale_threshold is not None
            else args.get("max_upscale_threshold")
        ),
    )


def _check_ported(configs: List[DatasetConfig], args) -> None:
    """Refuse the dataset kinds and cache modes the port does not build."""
    if args.get("enable_nsfw_check"):
        raise NotImplementedError("enable_nsfw_check: the NSFW scan is not ported (ROADMAP Queue 1 item 4e)")
    for key in ("text_cache_ondemand", "vae_cache_ondemand"):
        if args.get(key):
            raise NotImplementedError(f"{key}: on-demand caches are not ported (ROADMAP Queue 1 item 4e)")
    for config in configs:
        if config.dataset_type not in ("image", "video", "audio", "eval", "text_embeds"):
            raise NotImplementedError(
                f"dataset {config.id!r}: dataset_type {config.dataset_type!r} is not ported "
                "(ROADMAP Queue 1 item 4f)")
        if config.caption_strategy == "parquet" or config.parquet:
            raise NotImplementedError(
                f"dataset {config.id!r}: the parquet metadata backend is not ported (ROADMAP Queue 1 item 4e)")
        if config.text_cache_ondemand or config.vae_cache_ondemand or not config.hash_filenames:
            raise NotImplementedError(
                f"dataset {config.id!r}: on-demand and unhashed caches are not ported (ROADMAP Queue 1 item 4e)")
        if config.image_embeds:
            raise NotImplementedError(
                f"dataset {config.id!r}: a separate image_embeds cache backend is not ported "
                "(ROADMAP Queue 1 item 4e)")
        if config.conditioning_data or config.conditioning_image_embeds:
            raise NotImplementedError(
                f"dataset {config.id!r}: conditioning pairing is not ported (ROADMAP Queue 1 item 4f)")


class DataPlane:
    """The assembled data plane: bundles + iterator + caches."""

    def __init__(self, bundles, text_caches, iterator, startup_metrics=None):
        self.bundles: Dict[str, DatasetBundle] = bundles
        self.text_caches = text_caches
        self.iterator: MultiDatasetIterator = iterator
        # per-stage startup durations + RSS (reference factory.py:1415-1451
        # FactoryRegistry performance metrics)
        self.startup_metrics: Dict[str, float] = startup_metrics or {}

    def save_state(self):
        return self.iterator.save_state()

    def load_state(self, state):
        self.iterator.load_state(state)

    def tag_frequency(self, max_files_per_dataset: int = 2000) -> Dict[str, Dict[str, int]]:
        """{dataset_id: {tag: count}} from caption content (reference
        save_hooks.py:593-610 ``ss_tag_frequency`` for ComfyUI trigger-word
        extensions).  Tags split on commas, whitespace-normalized."""
        frequency: Dict[str, Dict[str, int]] = {}
        for bundle in self.bundles.values():
            cfg = bundle.config
            if getattr(cfg, "dataset_type", "image") not in ("image", "video", "audio"):
                continue
            counts: Dict[str, int] = {}
            files = []
            for bucket_files in bundle.metadata_backend.aspect_ratio_bucket_indices.values():
                files.extend(bucket_files)
            for path in files[:max_files_per_dataset]:
                try:
                    caption = get_caption(
                        path,
                        bundle.data_backend,
                        strategy=getattr(cfg, "caption_strategy", None) or "textfile",
                        instance_prompt=getattr(cfg, "instance_prompt", None),
                        prepend_instance_prompt=bool(getattr(cfg, "prepend_instance_prompt", False)),
                        only_instance_prompt=bool(getattr(cfg, "only_instance_prompt", False)),
                    )
                except Exception:
                    continue
                for tag in str(caption or "").split(","):
                    tag = tag.strip()
                    if tag:
                        counts[tag] = counts.get(tag, 0) + 1
            if counts:
                frequency[bundle.id] = counts
        return frequency

    def trigger_words(self) -> List[str]:
        """Instance prompts across datasets (reference _collect_trigger_words)."""
        words: List[str] = []
        for bundle in self.bundles.values():
            prompt = getattr(bundle.config, "instance_prompt", None)
            if prompt and str(prompt) not in words:
                words.append(str(prompt))
        return words


def configure_multi_databackend(
    args,
    model,
    vae_encode_fn: Optional[Callable] = None,
    run_caching: bool = True,
    global_batch_size: Optional[int] = None,
) -> DataPlane:
    """Build the data plane from ``args.data_backend_config`` (one process:
    multi-process data planes are ROADMAP Queue 1 item 5).

    ``model`` supplies ``encode_text``/``collate_text_embeds`` and the family
    name for the text-cache hash suffix; ``vae_encode_fn(images_nhwc, count)
    -> latents`` feeds the VAE cache (omit it to require cached latents)."""
    configs = load_dataloader_config(
        args.get("data_backend_config"),
        require_text_embeds=True,
        global_defaults={
            "resolution": args.get("resolution"),
            "resolution_type": args.get("resolution_type"),
            "caption_strategy": args.get("caption_strategy"),
            "minimum_image_size": args.get("minimum_image_size"),
            "maximum_image_size": args.get("maximum_image_size"),
            "target_downsample_size": args.get("target_downsample_size"),
            "aspect_bucket_rounding": args.get("aspect_bucket_rounding"),
            "aspect_bucket_alignment": args.get("aspect_bucket_alignment"),
        },
    )
    _check_ported(configs, args)
    compress = bool(args.get("compress_disk_cache", False))
    metrics: Dict[str, float] = {}
    t0 = time.perf_counter()

    def stage(name: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        metrics[name] = round(now - t0, 3)
        t0 = now

    storage: Dict[str, BaseDataBackend] = {config.id: build_storage_backend(config, compress) for config in configs}

    # ---- text embed caches ----------------------------------------------------------------
    text_caches: Dict[str, TextEmbeddingCache] = {}
    for config in configs:
        if config.dataset_type != "text_embeds":
            continue
        cache_dir = config.cache_dir or os.path.join(args.get("cache_dir", "cache"), "text", config.id)
        text_caches[config.id] = TextEmbeddingCache(
            id=config.id,
            data_backend=storage[config.id],
            cache_dir=cache_dir,
            model_type=model.NAME,
            encode_fn=(lambda prompts: model.encode_text(prompts)) if hasattr(model, "text_encoders") else None,
            batch_size=config.text_encoder_batch_size or args.get("text_encoder_batch_size", 4) or 4,
            disabled=bool(config.text_cache_disable or args.get("text_cache_disable", False)),
        )
    default_text_id = get_default_text_embed_id(configs)
    stage("configure_backends_s")

    # ---- primary datasets -------------------------------------------------------------------
    bundles: Dict[str, DatasetBundle] = {}
    for config in configs:
        if config.dataset_type not in ("image", "video", "audio", "eval"):
            continue
        backend = storage[config.id]
        bucket_cfg = bucket_config_for(config, args)
        cache_base = config.instance_data_dir or os.path.join(args.get("cache_dir", "cache"), config.id)
        metadata = MetadataBackend(
            id=config.id,
            data_backend=backend,
            bucket_config=bucket_cfg,
            instance_data_dir=config.instance_data_dir,
            cache_file=os.path.join(cache_base, "aspect_ratio_bucket_indices.json"),
            metadata_file=os.path.join(cache_base, "aspect_ratio_bucket_metadata.json"),
            repeats=config.repeats,
            dataset_type=config.dataset_type if config.dataset_type != "eval" else "image",
            video_config=config.audio if config.dataset_type == "audio" else config.video,
        )
        metadata.refresh(max_workers=int(args.get("max_workers", 16) or 16))

        sampler = MultiAspectSampler(
            id=config.id,
            metadata_backend=metadata,
            # train_batch_size is per-device (reference semantics)
            batch_size=int(global_batch_size or args.get("train_batch_size", 1) or 1),
            seed=int(args.get("seed", 42) or 42),
            repeats=config.repeats,
        )
        vae_cache = VAECache(
            id=config.id,
            data_backend=backend,
            metadata_backend=metadata,
            cache_dir=config.cache_dir_vae or os.path.join(args.get("cache_dir", "cache"), "vae", config.id),
            encode_fn=vae_encode_fn,
            bucket_config=bucket_cfg,
            instance_data_dir=config.instance_data_dir,
            batch_size=int(args.get("vae_batch_size", 4) or 4),
            crop_style=config.crop_style if config.crop else "random",
            seed=int(args.get("seed", 42) or 42),
            transfer_dtype="uint8" if getattr(vae_encode_fn, "handles_uint8", False) else "float32",
        )
        text_id = config.text_embeds or default_text_id
        bundles[config.id] = DatasetBundle(
            id=config.id,
            config=config,
            data_backend=backend,
            metadata_backend=metadata,
            sampler=sampler,
            vae_cache=vae_cache,
            text_cache=text_caches.get(text_id),
        )
        check_collatable(bundles[config.id], model)

    # ---- caching passes -----------------------------------------------------------------------
    if run_caching:
        for bundle in bundles.values():
            if bundle.text_cache is not None and bundle.text_cache.encode_fn is not None:
                captions = []
                for files in bundle.metadata_backend.aspect_ratio_bucket_indices.values():
                    for path in files:
                        captions.append(
                            get_caption(
                                path,
                                bundle.data_backend,
                                strategy=bundle.config.caption_strategy,
                                instance_prompt=bundle.config.instance_prompt,
                                prepend_instance_prompt=bundle.config.prepend_instance_prompt,
                                only_instance_prompt=bundle.config.only_instance_prompt,
                                metadata_row=bundle.metadata_backend.image_metadata.get(path, {}).get("row"),
                                parquet_config=bundle.config.parquet,
                            )
                        )
                if args.get("caption_dropout_probability"):
                    captions.append("")  # dropout sentinel
                metrics["captions"] = metrics.get("captions", 0) + len(set(captions))
                bundle.text_cache.compute_embeddings_for_prompts(captions)
            stage(f"text_cache_{bundle.id}_s")
            if vae_encode_fn is not None and not args.get("vae_cache_disable"):
                metrics[f"images_{bundle.id}"] = bundle.vae_cache.process_buckets()
            stage(f"vae_cache_{bundle.id}_s")

    try:
        import resource

        metrics["peak_rss_mb"] = round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1)
    except Exception:
        pass
    logger.info("data plane ready: %s", metrics)
    # eval_dataset_id marks image datasets as held-out eval splits: they stay
    # out of the train iterator and the eval loss reads them
    eval_ids = eval_dataset_id_set(args.get("eval_dataset_id"))
    unknown_eval = eval_ids - set(bundles)
    if unknown_eval:
        raise ValueError(
            f"--eval_dataset_id references unknown dataset(s): {sorted(unknown_eval)} (have: {sorted(bundles)})")
    iterator = MultiDatasetIterator(
        [b for b in bundles.values() if b.config.dataset_type in ("image", "video", "audio") and b.id not in eval_ids],
        model,
        caption_dropout_probability=float(args.get("caption_dropout_probability", 0.0) or 0.0),
        seed=int(args.get("seed", 42) or 42),
    )
    return DataPlane(bundles, text_caches, iterator, startup_metrics=metrics)
