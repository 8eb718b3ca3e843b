"""The torch port's own copy of ``simpletuner_tpu/configuration/dataloader.py``: the port imports
nothing of the JAX package, so it keeps this host code itself.  Keep the
two in step (``tests/test_torch_host_modules.py`` holds them equal).

multidatabackend.json parsing and validation.

Accepts the reference's dataloader configuration format (reference:
documentation/DATALOADER.md, helpers/data_backend/factory.py:1083
``sort_dataset_configs_by_dependencies``, :5077 ``configure_multi_databackend``):
a JSON list of dataset dicts with ``id``, ``type`` (storage backend), ``dataset_type``
(image/video/audio/text_embeds/image_embeds/conditioning/...), bucketing and caption
options.  This module is pure config logic — no IO beyond reading the file — so it is
unit-testable on CPU and shared by the CLI, trainer and data-plane factory.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

PRIMARY_DATASET_TYPES = ("image", "video", "audio", "conditioning", "eval", "caption")
EMBED_DATASET_TYPES = ("text_embeds", "image_embeds", "conditioning_image_embeds", "distillation_cache")
ALL_DATASET_TYPES = PRIMARY_DATASET_TYPES + EMBED_DATASET_TYPES
STORAGE_BACKEND_TYPES = ("local", "aws", "csv", "huggingface", "memory", "webshart")
CROP_STYLES = ("center", "centre", "corner", "random", "face")
CROP_ASPECTS = ("square", "preserve", "closest", "random")
CAPTION_STRATEGIES = ("filename", "textfile", "parquet", "instanceprompt", "csv", "huggingface")
RESOLUTION_TYPES = ("pixel", "area", "pixel_area")


@dataclasses.dataclass
class DatasetConfig:
    """One entry of multidatabackend.json, defaults applied."""

    id: str
    type: str = "local"
    dataset_type: str = "image"
    disabled: bool = False
    instance_data_dir: Optional[str] = None
    # bucketing
    resolution: Optional[float] = None
    resolution_type: str = "pixel_area"
    minimum_image_size: Optional[float] = None
    maximum_image_size: Optional[float] = None
    target_downsample_size: Optional[float] = None
    minimum_aspect_ratio: Optional[float] = None
    maximum_aspect_ratio: Optional[float] = None
    aspect_bucket_rounding: Optional[int] = None
    aspect_bucket_alignment: Optional[int] = None
    square_padding: bool = False
    # cropping
    crop: bool = False
    crop_style: str = "random"
    crop_aspect: str = "square"
    crop_aspect_buckets: Optional[List[Any]] = None
    # cap upscaling when selecting from crop_aspect_buckets (reference
    # training_sample.py:251-265: keep buckets whose target size is within
    # original * (1 + threshold))
    max_upscale_threshold: Optional[float] = None
    # captions
    caption_strategy: str = "filename"
    instance_prompt: Optional[str] = None
    prepend_instance_prompt: bool = False
    only_instance_prompt: bool = False
    caption_filter_list: Optional[str] = None
    parquet: Optional[Dict[str, Any]] = None
    # regularization (DreamBooth prior preservation: LoRA batches from this
    # dataset regress the parent/base model prediction, reference
    # trainer.py:6565-6581)
    is_regularisation_data: bool = False
    # sampling
    repeats: int = 0
    probability: float = 1.0
    dataset_weight: Optional[float] = None
    start_epoch: Optional[int] = None
    end_epoch: Optional[int] = None
    start_step: Optional[int] = None
    end_step: Optional[int] = None
    # caches / linkage
    cache_dir: Optional[str] = None
    cache_dir_vae: Optional[str] = None
    text_embeds: Optional[str] = None
    image_embeds: Optional[str] = None
    conditioning_image_embeds: Optional[str] = None
    conditioning_data: Optional[Any] = None  # str or list of ids
    conditioning: Optional[List[Dict[str, Any]]] = None  # auto-generated conditioning specs
    conditioning_type: Optional[str] = None
    source_dataset_id: Optional[str] = None
    # distillation_cache datasets (reference data_backend/config/distillation_cache.py)
    distillation_type: str = "generic"
    default: bool = False  # default text_embeds dataset
    write_batch_size: Optional[int] = None
    text_encoder_batch_size: Optional[int] = None
    text_cache_ondemand: bool = False
    text_cache_disable: bool = False
    vae_cache_clear_each_epoch: bool = False
    vae_cache_ondemand: bool = False
    hash_filenames: bool = True
    shorten_filenames: bool = False
    preserve_data_backend_cache: bool = False
    skip_file_discovery: str = ""
    # video
    video: Optional[Dict[str, Any]] = None
    # audio
    audio: Optional[Dict[str, Any]] = None
    # storage-backend specific (aws_*, csv_*, huggingface, ...) kept verbatim
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "DatasetConfig":
        known = {f.name for f in dataclasses.fields(cls) if f.name != "extra"}
        kwargs: Dict[str, Any] = {}
        extra: Dict[str, Any] = {}
        for key, value in raw.items():
            if key in ("disable",):  # reference also accepts this spelling
                kwargs["disabled"] = bool(value)
            elif key == "is_regularization_data":  # reference accepts both spellings
                kwargs["is_regularisation_data"] = bool(value)
            elif key in known:
                kwargs[key] = value
            else:
                extra[key] = value
        if "id" not in kwargs:
            raise DataloaderConfigError("dataset entry missing required 'id'")
        # The reference's example configs use "a|b|c" placeholder strings for
        # choice fields; take the first option.
        for choice_field in ("crop_style", "crop_aspect", "resolution_type", "caption_strategy"):
            value = kwargs.get(choice_field)
            if isinstance(value, str) and "|" in value:
                kwargs[choice_field] = value.split("|", 1)[0]
        kwargs["extra"] = extra
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        data = dataclasses.asdict(self)
        extra = data.pop("extra")
        data.update(extra)
        return data


class DataloaderConfigError(ValueError):
    pass


def _validate(configs: Sequence[DatasetConfig], require_text_embeds: bool = True) -> None:
    errors: List[str] = []
    seen = set()
    ids = {c.id for c in configs}
    default_text_embeds = [c for c in configs if c.dataset_type == "text_embeds" and c.default]
    for config in configs:
        if config.id in seen:
            errors.append(f"duplicate dataset id {config.id!r}")
        seen.add(config.id)
        if config.dataset_type not in ALL_DATASET_TYPES:
            errors.append(f"{config.id}: unknown dataset_type {config.dataset_type!r}")
        if config.type not in STORAGE_BACKEND_TYPES:
            errors.append(f"{config.id}: unknown backend type {config.type!r}")
        if config.crop and config.crop_style not in CROP_STYLES:
            errors.append(f"{config.id}: unknown crop_style {config.crop_style!r}")
        if config.crop and config.crop_aspect not in CROP_ASPECTS:
            errors.append(f"{config.id}: unknown crop_aspect {config.crop_aspect!r}")
        if config.caption_strategy and config.caption_strategy not in CAPTION_STRATEGIES:
            errors.append(f"{config.id}: unknown caption_strategy {config.caption_strategy!r}")
        if config.resolution_type not in RESOLUTION_TYPES:
            errors.append(f"{config.id}: unknown resolution_type {config.resolution_type!r}")
        if config.type == "local" and config.dataset_type in PRIMARY_DATASET_TYPES and not config.disabled:
            if not config.instance_data_dir:
                errors.append(f"{config.id}: local dataset requires instance_data_dir")
        # storage-backend required fields caught at parse time, not first use
        # (reference factory golden fixtures: error_missing_aws_fields)
        if config.type == "aws" and not config.disabled and not config.extra.get("aws_bucket_name"):
            errors.append(f"{config.id}: aws backend requires aws_bucket_name")
        if config.type == "csv" and not config.disabled and not (
            config.extra.get("csv_file") or config.instance_data_dir
        ):
            errors.append(f"{config.id}: csv_url backend requires csv_file")
        if config.type == "huggingface" and not config.disabled and not (
            config.extra.get("dataset_name") or config.instance_data_dir
        ):
            errors.append(f"{config.id}: huggingface backend requires dataset_name")
        for link_attr in ("text_embeds", "image_embeds"):
            target = getattr(config, link_attr)
            if target and target not in ids:
                errors.append(f"{config.id}: {link_attr} references unknown dataset {target!r}")
        # conditioning_image_embeds may name a dataset entry OR an implicit
        # auto-built cache id (the factory creates the vision-embed cache)
        if config.conditioning_data:
            targets = config.conditioning_data if isinstance(config.conditioning_data, list) else [config.conditioning_data]
            for target in targets:
                if target not in ids:
                    errors.append(f"{config.id}: conditioning_data references unknown dataset {target!r}")
    if len(default_text_embeds) > 1:
        errors.append("multiple text_embeds datasets marked default=true")
    primaries = [c for c in configs if c.dataset_type in ("image", "video", "audio") and not c.disabled]
    text_embed_sets = [c for c in configs if c.dataset_type == "text_embeds" and not c.disabled]
    if require_text_embeds and primaries and not text_embed_sets:
        errors.append("at least one text_embeds dataset is required when training datasets are present")
    if errors:
        raise DataloaderConfigError("; ".join(errors))


def sort_by_dependencies(configs: Sequence[DatasetConfig]) -> List[DatasetConfig]:
    """Topological sort: embed caches first, then datasets that others condition on,
    then the rest (reference: factory.py:1083)."""
    by_id = {c.id: c for c in configs}
    order: List[DatasetConfig] = []
    placed = set()

    def place(config: DatasetConfig) -> None:
        if config.id in placed:
            return
        placed.add(config.id)
        deps: List[str] = []
        for attr in ("text_embeds", "image_embeds", "conditioning_image_embeds", "source_dataset_id"):
            target = getattr(config, attr)
            if target:
                deps.append(target)
        if config.conditioning_data:
            targets = config.conditioning_data if isinstance(config.conditioning_data, list) else [config.conditioning_data]
            deps.extend(targets)
        for dep in deps:
            if dep in by_id:
                place(by_id[dep])
        order.append(config)

    # embeds first for stable ordering
    for config in configs:
        if config.dataset_type in EMBED_DATASET_TYPES:
            place(config)
    for config in configs:
        place(config)
    return order


def load_dataloader_config(
    path_or_list: Any,
    global_defaults: Optional[Dict[str, Any]] = None,
    require_text_embeds: bool = True,
) -> List[DatasetConfig]:
    """Parse, default-fill, validate and dependency-sort a multidatabackend config.

    ``path_or_list`` may be a filesystem path to the JSON file or an already-parsed
    list of dicts.  ``global_defaults`` supplies trainer-level fallbacks (resolution,
    resolution_type, caption_strategy, ...) like the reference's args fallback chain.
    """
    if isinstance(path_or_list, (str, Path)):
        raw = json.loads(Path(path_or_list).read_text())
    else:
        raw = path_or_list
    if not isinstance(raw, list):
        raise DataloaderConfigError("multidatabackend config must be a JSON list")
    defaults = global_defaults or {}
    configs: List[DatasetConfig] = []
    for entry in raw:
        if not isinstance(entry, dict):
            raise DataloaderConfigError(f"dataset entry must be a dict, got {type(entry)}")
        merged = dict(entry)
        for key in (
            "resolution",
            "resolution_type",
            "caption_strategy",
            "minimum_image_size",
            "maximum_image_size",
            "target_downsample_size",
            "aspect_bucket_rounding",
            "aspect_bucket_alignment",
            "instance_prompt",
        ):
            if key not in merged and defaults.get(key) is not None:
                merged[key] = defaults[key]
        configs.append(DatasetConfig.from_dict(merged))
    _validate(configs, require_text_embeds=require_text_embeds)
    active = [c for c in configs if not c.disabled]
    return sort_by_dependencies(active)


def get_default_text_embed_id(configs: Sequence[DatasetConfig]) -> Optional[str]:
    for config in configs:
        if config.dataset_type == "text_embeds" and config.default:
            return config.id
    for config in configs:
        if config.dataset_type == "text_embeds":
            return config.id
    return None
