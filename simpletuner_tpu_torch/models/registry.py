"""Model family registry.

Counterpart of ``simpletuner_tpu/models/registry.py``: ``get_model_family``
builds the family a config names.  Only ``flux`` is ported; every other
family of the JAX registry is refused by name (ROADMAP Queue 1 item 6), and
an unknown name raises as in the JAX registry.
"""

from __future__ import annotations

from typing import Any

# the JAX registry's families (models/registry.py:9-51) and aliases (:53-59)
JAX_FAMILIES = (
    "flux", "sd1x", "sd2x", "sdxl", "sd3", "pixart_sigma", "auraflow", "wan", "ltxvideo", "ltxvideo2", "ace_step",
    "chroma", "krea2", "kolors", "hunyuanvideo", "flux2", "lumina2", "sana", "deepfloyd", "mageflow", "z_image",
    "cosmos3", "cosmos", "hidream", "qwen_image", "longcat_image", "longcat_video", "anima", "ideogram",
    "kandinsky5_image", "kandinsky5_video", "sanavideo", "boogu_image", "ernie", "stable_cascade", "wan_s2v",
    "heartmula", "omnigen", "z_image_omni", "zlab_i1",
)
ALIASES = {"sd15": "sd1x", "sd21": "sd2x", "pixart": "pixart_sigma", "ltx2": "ltxvideo2",
           "kandinsky5-image": "kandinsky5_image"}


def get_model_family(config: Any):
    """The model family object for ``config.model_family``."""
    family = getattr(config, "model_family", None)
    if not family:
        raise ValueError("config.model_family is required")
    name = ALIASES.get(family, family)
    if name not in JAX_FAMILIES:
        raise KeyError(f"unknown model family {family!r}; known: {list(JAX_FAMILIES)}")
    if name != "flux":
        raise NotImplementedError(f"model_family={family!r} is not ported (only flux; ROADMAP Queue 1 item 6)")
    if getattr(config, "train_text_encoder", False):
        raise NotImplementedError("train_text_encoder is not ported (ROADMAP Queue 1 item 4i)")
    from .flux import Flux

    return Flux(config)
