"""Model cards + safetensors modelspec metadata.

Reference: helpers/publishing/metadata.py (hub model card with license,
widget prompts, training details) and helpers/training/save_hooks.py:614-686
(safetensors modelspec: architecture/title/resolution/trigger-words).

The torch port's own copy of ``simpletuner_tpu/publishing/metadata.py``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

_ARCHITECTURES = {
    "flux": "flux-1-dev",
    "sdxl": "stable-diffusion-xl-v1-base",
    "sd1x": "stable-diffusion-v1",
    "sd2x": "stable-diffusion-v2",
    "sd3": "stable-diffusion-3-medium",
    "pixart_sigma": "pixart-sigma",
    "auraflow": "auraflow",
    "wan": "wan-2.1",
    "ace_step": "ace-step-v1",
}

_LICENSES = {
    "flux": "other",
    "sdxl": "creativeml-openrail-m",
    "sd1x": "creativeml-openrail-m",
    "sd2x": "creativeml-openrail-m",
    "sd3": "other",
    "pixart_sigma": "openrail++",
    "auraflow": "apache-2.0",
    "wan": "apache-2.0",
    "ace_step": "apache-2.0",
}


def safetensors_modelspec(
    model,
    config,
    adapter_type: str = "lora",
    trigger_words=None,
    tag_frequency=None,
) -> Dict[str, str]:
    """ModelSpec-style metadata written into exported safetensors headers
    (reference save_hooks.py:614-686: sai spec + description + ComfyUI
    trigger-word keys ``trained_words``/``ss_tag_frequency`` + comment)."""
    import json as _json

    resolution = int(config.get("resolution", model.DEFAULT_RESOLUTION) or 1024)
    spec = {
        "modelspec.sai_model_spec": "1.0.0",
        "modelspec.architecture": _ARCHITECTURES.get(model.NAME, model.NAME) + (
            "/lora" if adapter_type in ("lora", "lycoris") else ""
        ),
        "modelspec.implementation": "simpletuner_tpu",
        "modelspec.title": config.get("tracker_run_name") or f"{model.NAME}-{adapter_type}",
        "modelspec.resolution": f"{resolution}x{resolution}",
        "modelspec.date": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    description = getattr(model, "MODEL_DESCRIPTION", None)
    if description:
        spec["modelspec.description"] = str(description)
    words = list(trigger_words or [])
    explicit = config.get("modelspec_trigger_words")
    if explicit:
        if isinstance(explicit, str):
            explicit = [w.strip() for w in explicit.split(",") if w.strip()]
        for w in reversed(list(explicit)):
            if w not in words:
                words.insert(0, w)
    trigger = config.get("instance_prompt")
    if trigger and str(trigger) not in words:
        words.insert(0, str(trigger))
    if words:
        spec["modelspec.trigger_phrase"] = words[0]
        # ComfyUI-Lora-Auto-Trigger-Words compatibility
        spec["trained_words"] = ", ".join(words)
    if tag_frequency:
        spec["ss_tag_frequency"] = _json.dumps(tag_frequency)
    comment = config.get("modelspec_comment")
    if comment:
        spec["modelspec.comment"] = str(comment)
    return spec


def build_model_card(
    model,
    config,
    validation_prompts: Optional[List[str]] = None,
    validation_images: Optional[List[str]] = None,
    train_steps: Optional[int] = None,
) -> str:
    """README.md for the exported model (reference metadata.py model cards)."""
    base = model.huggingface_path() or model.NAME
    adapter = config.get("model_type", "lora")
    license_id = _LICENSES.get(model.NAME, "other")
    widgets = ""
    for prompt in (validation_prompts or [])[:4]:
        widgets += f'- text: "{prompt}"\n'

    lines = [
        "---",
        f"license: {license_id}",
        f"base_model: {base}",
        "tags:",
        f"- {model.NAME}",
        "- simpletuner-tpu",
        f"- {adapter}",
        "- text-to-image" if model.MODALITY == "image" else f"- text-to-{model.MODALITY}",
    ]
    if widgets:
        lines += ["widget:", widgets.rstrip()]
    lines += [
        "---",
        "",
        f"# {config.get('tracker_run_name') or (model.NAME + ' ' + adapter)}",
        "",
        f"{adapter.upper() if adapter == 'lora' else adapter} derived from"
        f" [`{base}`](https://huggingface.co/{base}), trained with"
        " [simpletuner-tpu](https://github.com/simpletuner-tpu) on TPU.",
        "",
        "## Training settings",
        "",
        f"- Steps: {train_steps if train_steps is not None else config.get('max_train_steps')}",
        f"- Learning rate: {config.get('learning_rate')}",
        f"- Optimizer: {config.get('optimizer')}",
        f"- Resolution: {config.get('resolution')}",
        f"- Precision: {config.get('mixed_precision', 'bf16')}"
        + (f" (base {config.get('base_model_precision')})" if config.get("base_model_precision") not in (None, "no_change") else ""),
    ]
    if config.get("lora_rank") and adapter == "lora":
        lines.append(f"- LoRA rank: {config.get('lora_rank')}")
    if config.get("model_card_note"):
        # --model_card_note: freeform operator note at the top of the card
        lines += ["", str(config.get("model_card_note"))]
    if config.get("instance_prompt"):
        lines += ["", f"Trigger phrase: `{config.get('instance_prompt')}`"]
    if validation_images:
        lines += ["", "## Validation samples", ""]
        for path in validation_images[:4]:
            lines.append(f"![validation]({path})")
    lines.append("")
    return "\n".join(lines)
