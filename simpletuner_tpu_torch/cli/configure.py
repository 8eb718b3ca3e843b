"""Interactive config wizard: a linear prompt-driven wizard that writes
config.json + multidatabackend.json.

The torch port's copy of ``simpletuner_tpu/cli/configure.py``: the same
questions, defaults and files, over the port's model registry (every JAX
family is listed) and the port's optimizer registry."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


def _ask(prompt: str, default: Any = None, choices: Optional[List[str]] = None, answers=None) -> str:
    if answers is not None:
        value = answers.pop(0) if answers else ""
        return str(value) if value != "" else ("" if default is None else str(default))
    suffix = f" [{default}]" if default is not None else ""
    if choices:
        suffix = f" ({'/'.join(choices)})" + suffix
    raw = input(f"{prompt}{suffix}: ").strip()
    if not raw and default is not None:
        return str(default)
    if choices and raw and raw not in choices:
        print(f"  please pick one of {choices}")
        return _ask(prompt, default, choices, answers)
    return raw


def run_wizard(output_dir: str = "config", answers: Optional[List[str]] = None) -> Dict[str, str]:
    """Returns {"config": path, "dataloader": path}.  ``answers`` makes the
    wizard scriptable (one entry per question, "" = accept default)."""
    from ..models.registry import ModelRegistry
    from ..training.optimizers import optimizer_names

    families = ModelRegistry.families()
    print("simpletuner-tpu-torch configuration wizard\n")

    family = _ask("Model family", "flux", families, answers)
    meta = ModelRegistry.metadata(family)
    model_type = _ask("Training type", "lora", ["lora", "full", "controlnet"], answers)
    config: Dict[str, Any] = {
        "model_family": family,
        "model_type": model_type,
    }
    if model_type == "lora":
        config["lora_rank"] = int(_ask("LoRA rank", 16, answers=answers))
        algo = _ask("Adapter algorithm", "lora", ["lora", "lokr"], answers)
        if algo == "lokr":
            config["lora_type"] = "lycoris"
            config["lycoris_config"] = {"algo": "lokr"}
    pretrained = _ask("Pretrained model path (safetensors file/dir, empty = random init)", "", answers=answers)
    if pretrained:
        config["pretrained_transformer_path"] = pretrained
    config["resolution"] = int(_ask("Training resolution", 1024 if meta.get("modality") == "image" else 480, answers=answers))
    config["train_batch_size"] = int(_ask("Per-device batch size", 1, answers=answers))
    config["max_train_steps"] = int(_ask("Max training steps", 5000, answers=answers))
    config["learning_rate"] = float(_ask("Learning rate", 1e-4, answers=answers))
    config["optimizer"] = _ask("Optimizer", "adamw_bf16", sorted(optimizer_names()), answers)
    config["lr_scheduler"] = _ask("LR schedule", "constant_with_warmup", answers=answers)
    config["lr_warmup_steps"] = int(_ask("Warmup steps", 100, answers=answers))
    config["gradient_checkpointing"] = _ask("Gradient checkpointing?", "y", ["y", "n"], answers) == "y"
    precision = _ask("Base model precision", "no_change", ["no_change", "int8", "fp8"], answers)
    if precision != "no_change":
        config["base_model_precision"] = precision
    config["checkpointing_steps"] = int(_ask("Checkpoint every N steps", 500, answers=answers))
    prompt = _ask("Validation prompt (empty = disable)", "", answers=answers)
    if prompt:
        config["validation_prompt"] = prompt
        config["validation_steps"] = int(_ask("Validate every N steps", 250, answers=answers))
    config["report_to"] = _ask("Tracker", "tensorboard", ["tensorboard", "wandb", "none"], answers)
    config["output_dir"] = _ask("Output directory", "output", answers=answers)

    data_dir = _ask("Training images/videos/audio directory", "/data/images", answers=answers)
    caption = _ask("Caption strategy", "textfile", ["textfile", "filename", "parquet", "instanceprompt"], answers)
    dataset_type = {"image": "image", "video": "video", "audio": "audio"}.get(meta.get("modality", "image"), "image")
    dataloader = [
        {
            "id": "train",
            "dataset_type": dataset_type,
            "type": "local",
            "instance_data_dir": data_dir,
            "crop": True,
            "crop_style": "center",
            "crop_aspect": "square",
            "resolution": config["resolution"],
            "resolution_type": "pixel_area",
            "caption_strategy": caption,
            "cache_dir_vae": "cache/vae/train",
            "text_embeds": "embeds",
        },
        {
            "id": "embeds",
            "dataset_type": "text_embeds",
            "type": "local",
            "default": True,
            "cache_dir": "cache/text",
        },
    ]
    config["data_backend_config"] = os.path.join(output_dir, "multidatabackend.json")

    os.makedirs(output_dir, exist_ok=True)
    config_path = os.path.join(output_dir, "config.json")
    dataloader_path = os.path.join(output_dir, "multidatabackend.json")
    with open(config_path, "w") as handle:
        json.dump(config, handle, indent=2)
    with open(dataloader_path, "w") as handle:
        json.dump(dataloader, handle, indent=2)
    print(f"\nwrote {config_path} and {dataloader_path}")
    print(f"run: simpletuner-tpu-torch train --config {config_path}")
    return {"config": config_path, "dataloader": dataloader_path}
