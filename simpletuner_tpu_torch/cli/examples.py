"""Example training configs: complete runnable recipes, one per headline
configuration.

The torch port's copy of ``simpletuner_tpu/cli/examples.py``: the same names,
descriptions and configs, so ``examples`` lists and writes what the JAX
command lists and writes.  Recipes of families or options the port does not
train yet are kept; training them raises, naming their ROADMAP item."""

from __future__ import annotations

import json
import os
from typing import Any, Dict

EXAMPLES: Dict[str, Dict[str, Any]] = {
    "flux.peft-lora": {
        "description": "Flux.1-dev rank-16 LoRA @1024px, bf16 base",
        "config": {
            "model_family": "flux",
            "model_type": "lora",
            "lora_rank": 16,
            "pretrained_model_name_or_path": "black-forest-labs/FLUX.1-dev",
            "resolution": 1024,
            "resolution_type": "pixel_area",
            "train_batch_size": 1,
            "max_train_steps": 5000,
            "optimizer": "adamw_bf16",
            "learning_rate": 1e-4,
            "lr_scheduler": "constant_with_warmup",
            "lr_warmup_steps": 100,
            "gradient_checkpointing": True,
            "checkpointing_steps": 500,
            "validation_steps": 250,
            "validation_prompt": "a photo of a sks person",
            "validation_num_inference_steps": 20,
            "flux_guidance_value": 1.0,
            "report_to": "tensorboard",
            "data_backend_config": "config/multidatabackend.json",
            "output_dir": "output/flux-lora",
        },
    },
    "sdxl.full-ema": {
        "description": "SDXL full-rank fine-tune with EMA @1024px",
        "config": {
            "model_family": "sdxl",
            "model_type": "full",
            "pretrained_model_name_or_path": "stabilityai/stable-diffusion-xl-base-1.0",
            "resolution": 1024,
            "resolution_type": "pixel_area",
            "train_batch_size": 4,
            "max_train_steps": 30000,
            "optimizer": "adamw",
            "learning_rate": 1e-5,
            "lr_scheduler": "cosine",
            "use_ema": True,
            "ema_decay": 0.9999,
            "gradient_checkpointing": True,
            "checkpointing_steps": 1000,
            "snr_gamma": 5.0,
            "report_to": "tensorboard",
            "data_backend_config": "config/multidatabackend.json",
            "output_dir": "output/sdxl-full",
        },
    },
    "sd15.lora": {
        "description": "SD 1.5 rank-16 LoRA @512px",
        "config": {
            "model_family": "sd1x",
            "model_type": "lora",
            "lora_rank": 16,
            "pretrained_model_name_or_path": "stable-diffusion-v1-5/stable-diffusion-v1-5",
            "resolution": 512,
            "resolution_type": "pixel_area",
            "train_batch_size": 4,
            "max_train_steps": 3000,
            "optimizer": "adamw",
            "learning_rate": 1e-4,
            "lr_scheduler": "constant",
            "checkpointing_steps": 500,
            "data_backend_config": "config/multidatabackend.json",
            "output_dir": "output/sd15-lora",
        },
    },
    "flux.tread": {
        "description": "Flux LoRA with TREAD token dropout (20-40% speedup)",
        "config": {
            "model_family": "flux",
            "model_type": "lora",
            "lora_rank": 16,
            "pretrained_model_name_or_path": "black-forest-labs/FLUX.1-dev",
            "resolution": 1024,
            "train_batch_size": 1,
            "max_train_steps": 5000,
            "optimizer": "adamw_bf16",
            "learning_rate": 1e-4,
            "gradient_checkpointing": True,
            "tread_config": {"routes": [{"selection_ratio": 0.5, "start_layer": 2, "end_layer": -2}]},
            "data_backend_config": "config/multidatabackend.json",
            "output_dir": "output/flux-tread",
        },
    },
    "multidatabackend": {
        "description": "dataloader config template (multidatabackend.json)",
        "config": [
            {
                "id": "my-images",
                "type": "local",
                "instance_data_dir": "/data/images",
                "crop": True,
                "crop_style": "center",
                "crop_aspect": "square",
                "resolution": 1024,
                "resolution_type": "pixel_area",
                "caption_strategy": "textfile",
                "cache_dir_vae": "cache/vae/my-images",
                "text_embeds": "embeds",
            },
            {
                "id": "embeds",
                "dataset_type": "text_embeds",
                "type": "local",
                "default": True,
                "cache_dir": "cache/text",
            },
        ],
    },
}


def _family_example(family: str, meta: Dict[str, Any]) -> Dict[str, Any]:
    """Baseline LoRA recipe for a family (reference: one examples/ dir per
    family with a runnable config)."""
    modality = meta.get("modality", "image")
    resolution = {"image": 1024, "video": 480, "audio": 0}[modality]
    config: Dict[str, Any] = {
        "model_family": family,
        "model_type": "lora",
        "lora_rank": 16,
        "train_batch_size": 1,
        "max_train_steps": 5000,
        "optimizer": "adamw_bf16",
        "learning_rate": 1e-4,
        "lr_scheduler": "constant_with_warmup",
        "lr_warmup_steps": 100,
        "gradient_checkpointing": True,
        "checkpointing_steps": 500,
        "report_to": "tensorboard",
        "data_backend_config": "config/multidatabackend.json",
        "output_dir": f"output/{family}-lora",
    }
    if resolution:
        config["resolution"] = resolution
        config["resolution_type"] = "pixel_area"
    return {"description": f"{family} rank-16 LoRA baseline ({modality})", "config": config}


def _register_family_examples() -> None:
    from ..models.registry import ModelRegistry

    for family in ModelRegistry.families():
        key = f"{family}.lora"
        if key not in EXAMPLES and not any(n.startswith(family + ".") for n in EXAMPLES):
            EXAMPLES[key] = _family_example(family, ModelRegistry.metadata(family))


_register_family_examples()


# ---------------------------------------------------------------------------------
# Reference-recipe variants (reference simpletuner/examples/* — 116 recipes).
# Each entry mirrors one reference recipe name with the JAX package's settings:
# ramtorch/block-swap memory recipes map onto remat + int8 frozen base,
# cp-fa3 multi-GPU recipes onto the context mesh axis, SDNQ/NF4 quant onto
# int8/int4 MXU contraction.  (key, family, description, overrides)
# ---------------------------------------------------------------------------------

_TREAD = {"tread_config": {"routes": [{"selection_ratio": 0.5, "start_layer": 2, "end_layer": -2}]}}
_LOKR = {"lora_type": "lycoris", "lycoris_algo": "lokr", "lora_rank": 16}
_CTRL = {"controlnet": True}
_INT8 = {"base_model_precision": "int8-quanto", "quantized_matmul": "full"}
_CP2 = {"context_parallel_size": 2, "fsdp_size": 2}

_VARIANTS = [
    # lycoris-lokr recipes (reference *.lycoris-lokr)
    ("sdxl.lycoris-lokr", "sdxl", "SDXL LoKr (reference sdxl.lycoris-lokr)", _LOKR),
    ("pixart.lycoris-lokr", "pixart_sigma", "PixArt LoKr", _LOKR),
    ("sana.lycoris-lokr", "sana", "Sana LoKr", _LOKR),
    ("omnigen.lycoris-lokr", "omnigen", "OmniGen LoKr", _LOKR),
    ("cascade-stage-c.lycoris-lokr", "stable_cascade", "Stable Cascade stage-C LoKr", _LOKR),
    ("cosmos2image.lycoris-lokr", "cosmos", "Cosmos-2 image LoKr", _LOKR),
    ("cosmos3-image.lycoris-lokr", "cosmos3", "Cosmos-3 image LoKr", _LOKR),
    ("cosmos3-image-16g.lycoris-lokr", "cosmos3",
     "Cosmos-3 image LoKr on one 16G chip (int8 base + full remat)",
     {**_LOKR, **_INT8, "gradient_checkpointing": True}),
    ("boogu-image.lycoris-lokr", "boogu_image", "Boogu-Image LoKr", _LOKR),
    ("zlab-i1.lycoris-lokr", "zlab_i1", "ZLab-I1 LoKr", _LOKR),
    ("longcat-image-edit.lycoris-lokr", "longcat_image",
     "LongCat-Image edit-conditioning LoKr", {**_LOKR, "model_flavour": "edit"}),
    ("kandinsky5-image-t2i.lycoris-lokr", "kandinsky5_image", "Kandinsky-5 image LoKr", _LOKR),
    ("flux2-klein-i2i.lycoris-lokr", "flux2",
     "FLUX.2 Klein image-to-image LoKr", {**_LOKR, "model_flavour": "klein"}),
    # controlnet recipes (reference *.peft-controlnet-lora)
    ("flux.controlnet-lora", "flux", "Flux ControlNet LoRA", _CTRL),
    ("sd3.controlnet-lora", "sd3", "SD3 ControlNet LoRA", _CTRL),
    ("sdxl.controlnet-lora", "sdxl", "SDXL ControlNet LoRA", _CTRL),
    ("auraflow.controlnet-lora", "auraflow", "AuraFlow ControlNet LoRA", _CTRL),
    ("pixart.controlnet-lora", "pixart_sigma", "PixArt ControlNet LoRA", _CTRL),
    ("hidream.controlnet-lora", "hidream", "HiDream ControlNet LoRA", _CTRL),
    # TREAD recipes (reference *.peft-lora+TREAD)
    ("flux2.tread", "flux2", "FLUX.2 LoRA with TREAD token dropout", _TREAD),
    ("wan-1.3b.tread", "wan", "Wan 1.3B LoRA + TREAD", _TREAD),
    ("wan-2.2-i2v-high.tread", "wan",
     "Wan 2.2 I2V (high-noise expert) LoRA + TREAD",
     {**_TREAD, "model_flavour": "i2v-14b-2.2-high"}),
    ("wan-2.2-i2v-low.tread", "wan",
     "Wan 2.2 I2V (low-noise expert) LoRA + TREAD",
     {**_TREAD, "model_flavour": "i2v-14b-2.2-low"}),
    # memory recipes: reference +ramtorch/+16G map onto int8 base + remat
    ("longcat-video.16g", "longcat_video",
     "LongCat-Video LoRA on one 16G chip (int8 base, full remat — the "
     "reference +ramtorch recipe's TPU equivalent)",
     {**_INT8, "gradient_checkpointing": True}),
    ("ltxvideo2-t2v.16g", "ltxvideo2",
     "LTX-2 19B t2v LoRA on 16G (int8 + remat; reference +16G recipe)",
     {**_INT8, "gradient_checkpointing": True}),
    ("wan2.1-t2v-14b.16g", "wan",
     "Wan 2.1 14B t2v LoRA on 16G (int8 + remat; reference +ramtorch)",
     {**_INT8, "gradient_checkpointing": True, "model_flavour": "t2v-14b"}),
    ("wan-s2v.16g", "wan_s2v",
     "Wan speech-to-video LoRA on 16G (int8 + remat)",
     {**_INT8, "gradient_checkpointing": True}),
    ("wan2.2-ti2v-5b.16g", "wan",
     "Wan 2.2 TI2V 5B LoRA on 16G", {**_INT8, "gradient_checkpointing": True,
                                     "model_flavour": "ti2v-5b-2.2"}),
    # multi-chip recipes: reference 8xh100+cp-fa3 -> context mesh axis
    ("ltxvideo2-1080p.cp", "ltxvideo2",
     "LTX-2 1080p LoRA across 8 chips (fsdp x context mesh; reference "
     "8xh100 +cp-fa3 recipe)", {**_CP2, "gradient_checkpointing": True}),
    ("ltxvideo2-720p.cp", "ltxvideo2",
     "LTX-2 720p LoRA across 8 chips (fsdp x context)", _CP2),
    ("wan2.1-i2v-14b.cp", "wan",
     "Wan 2.1 I2V 14B across 8 chips (fsdp x context)",
     {**_CP2, "model_flavour": "i2v-14b-480p"}),
    ("wan2.1-t2v-14b.cp", "wan",
     "Wan 2.1 T2V 14B across 8 chips (fsdp x context)",
     {**_CP2, "model_flavour": "t2v-14b"}),
    # conditioning recipes (reference ltxvideo2 +*-conditioning)
    ("ltxvideo2.first-frame", "ltxvideo2",
     "LTX-2 LoRA with first-frame conditioning",
     {"ltx2_first_frame_conditioning_probability": 0.5}),
    ("ltxvideo2.intrinsic", "ltxvideo2",
     "LTX-2 LoRA with intrinsic (prefix+mask) conditioning",
     {"ltx2_prefix_conditioning_probability": 0.3,
      "ltx2_mask_conditioning_probability": 0.2}),
    ("ltxvideo2.reference-conditioning", "ltxvideo2",
     "LTX-2 IC-LoRA with reference-video conditioning",
     {"ltx2_reference_temporal_scale_factor": 1}),
    ("z-image-turbo.canny", "z_image",
     "Z-Image turbo LoRA with canny conditioning",
     {"model_flavour": "turbo", "controlnet": True}),
    # quantization / fp8 recipes
    ("ideogram-fp8.lora", "ideogram",
     "Ideogram fp8-base LoRA (the family's fp8-first convention)",
     {"base_model_precision": "fp8-torchao"}),
    ("flux.int8", "flux", "Flux LoRA on an int8 MXU-contracted base", _INT8),
    ("flux.int4", "flux",
     "Flux LoRA on a packed-int4 base (13G -> 6.5G weights)",
     {"base_model_precision": "int4-quanto", "quantized_matmul": "full"}),
    # flavour recipes
    ("kontext.lora", "flux",
     "Flux Kontext edit-conditioning LoRA", {"model_flavour": "kontext"}),
    ("deepfloyd-if-i-m.lora", "deepfloyd",
     "DeepFloyd IF stage-I medium LoRA @64px",
     {"model_flavour": "i-m-400m", "resolution": 64}),
    ("deepfloyd-if-ii-m.lora", "deepfloyd",
     "DeepFloyd IF stage-II SR LoRA @256px",
     {"model_flavour": "ii-m-450m", "resolution": 256}),
    ("hunyuanvideo-t2v.lora", "hunyuanvideo",
     "HunyuanVideo t2v LoRA", {"model_flavour": "t2v-480p"}),
    ("sd1x-dreamshaper.lora", "sd1x",
     "SD1.x fine-tune from a community checkpoint",
     {"pretrained_model_name_or_path": "Lykon/dreamshaper-8"}),
    ("anima-anyflow.lora", "anima",
     "Anima LoRA with AnyFlow distillation",
     {"distillation_method": "anyflow"}),
    # distillation recipes
    ("flux.lcm-distill", "flux", "Flux LCM distillation",
     {"distillation_method": "lcm", "model_type": "lora"}),
    ("sd3.dmd-distill", "sd3", "SD3 DMD distillation",
     {"distillation_method": "dmd", "model_type": "lora"}),
    ("wan.self-forcing", "wan", "Wan self-forcing distillation",
     {"distillation_method": "self_forcing"}),
    # training-technique recipes
    ("sdxl.snr-ema", "sdxl", "SDXL full-rank + EMA + min-SNR",
     {"model_type": "full", "use_ema": True, "snr_gamma": 5.0, "lora_rank": None}),
    ("flux.masked-loss", "flux", "Flux LoRA with masked loss datasets", {}),
    ("flux.crepa", "flux", "Flux LoRA with CREPA representation alignment",
     {"crepa_block_index": 8, "crepa_lambda": 0.5, "crepa_encoder_name": "dinov2-base"}),
    ("ltxvideo2.crepa", "ltxvideo2", "LTX-2 LoRA with CREPA cross-frame alignment",
     {"crepa_block_index": 8, "crepa_lambda": 0.5, "crepa_encoder_name": "dinov2-base"}),
    ("flux.scheduled-sampling", "flux", "Flux LoRA with scheduled-sampling rollout",
     {"scheduled_sampling_max_steps": 3}),
    ("sdxl.te-lora", "sdxl", "SDXL LoRA + text-encoder LoRA",
     {"train_text_encoder": True, "text_encoder_lr": 5e-5}),
    ("sd1x.slider", "sd1x", "SD1.x slider LoRA (+/- concept strength)",
     {"slider_positive_prompt": "a smiling person",
      "slider_negative_prompt": "a frowning person"}),
    ("flux.singlora", "flux", "Flux SingLoRA (symmetric one-matrix adapter)",
     {"peft_lora_mode": "singlora", "singlora_ramp_up_steps": 100}),
    ("flux.sla", "flux", "Flux LoRA with sparse-linear attention",
     {"attention_mechanism": "sla", "sla_config": {"topk": 0.2}}),
]


def _register_variants() -> None:
    from ..models.registry import ModelRegistry

    for key, family, description, overrides in _VARIANTS:
        if key in EXAMPLES:
            continue
        base = _family_example(family, ModelRegistry.metadata(family))
        config = dict(base["config"])
        for field, value in overrides.items():
            if value is None:
                config.pop(field, None)
            else:
                config[field] = value
        config["output_dir"] = f"output/{key.replace('.', '-')}"
        EXAMPLES[key] = {"description": description, "config": config}


_register_variants()


def write_example(name: str, output_dir: str) -> str:
    if name not in EXAMPLES:
        raise SystemExit(f"unknown example {name!r}; run `simpletuner-tpu-torch examples` to list")
    os.makedirs(output_dir, exist_ok=True)
    filename = "multidatabackend.json" if name == "multidatabackend" else "config.json"
    path = os.path.join(output_dir, filename)
    with open(path, "w") as handle:
        json.dump(EXAMPLES[name]["config"], handle, indent=2)
    return path
