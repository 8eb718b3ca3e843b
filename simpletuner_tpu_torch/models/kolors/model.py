"""Kolors family.

Counterpart of ``simpletuner_tpu/models/kolors/model.py``: the SDXL UNet of
``models/sdxl`` (``UNetConfig.sdxl()`` with the cross-attention 4,096 wide
and ``addition_embed_dim`` 6 x 256 + 4096, or ``tiny_xl`` narrowed to the
tiny encoder's 32 under the tiny preset) conditioned on ChatGLM3-6B at 256
tokens from ``text_encoder`` (the decoder-LLM encoder of
``models/llm_encoder.py`` on the ``chatglm3_6b`` preset): its final-norm
states are the cross-attention context and its pooled vector (the last
non-pad token's state) the added conditioning's pooled part.  Everything
else is SDXL's: the epsilon DDPM objective, the micro-conditioning time ids,
the 4-channel ``VAEConfig.sdxl()`` the trainer builds for it, and the
collate, which drops the mask, so the cross-attention runs unmasked against
all 256 ChatGLM keys (ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..common import TextEncoderSpec
from ..sdxl.model import SDXL
from ..unet import UNetConfig


class Kolors(SDXL):
    NAME = "kolors"
    DEFAULT_FLAVOUR = "1.0"
    HUGGINGFACE_PATHS = {"1.0": "Kwai-Kolors/Kolors-diffusers"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="chatglm", family="chatglm", subfolder="text_encoder", max_length=256),
    )

    def __init__(self, config: Any, arch: Optional[UNetConfig] = None):
        if arch is None:
            if getattr(config, "model_arch_preset", None) == "tiny":
                arch = dataclasses.replace(UNetConfig.tiny_xl(), cross_attention_dim=32, addition_embed_dim=6 * 8 + 32)
            else:
                arch = dataclasses.replace(UNetConfig.sdxl(), cross_attention_dim=4096,
                                           addition_embed_dim=6 * 256 + 4096)
        super().__init__(config, arch=arch)

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: the ChatGLM states, the pooled vector (the
        last valid token's state) and the mask."""
        (glm,) = self.text_encoders
        out = glm.encode(prompts)
        pooled = out.get("pooled", out["last_hidden_state"][:, -1])
        return [
            {
                "text_embeds": np.asarray(out["last_hidden_state"][i], np.float32),
                "pooled_embeds": np.asarray(pooled[i], np.float32),
                "attention_mask": np.asarray(out["attention_mask"][i]),
            }
            for i in range(len(prompts))
        ]
