"""Chroma family.

Counterpart of ``simpletuner_tpu/models/chroma/model.py``: ``Chroma(Flux)``,
the 8.9B Flux-topology flow model of ``transformer.py`` (``ChromaConfig()``,
or ``tiny`` under the tiny preset) on the port's Flux family: Flux's
packing, ids, ``prepare_batch``, transformer inputs (with
``--flux_attention_masked_training`` segment ids), sampling conditioning,
collate and ``flux_lora_target`` presets (through ``flux_key_map``).  Text
is T5-XXL only, at 512 tokens from ``text_encoder``; its spec names no
tokenizer subfolder, so the tokenizer comes from ``tokenizer_2``, as in the
JAX package (ROADMAP Queue 3).  ``pooled_embeds`` is zeros of the Flux
pooled width (768) in ``encode_text`` and the example batch, which the DiT
does not read.  Chroma has no guidance embedding, so a validation render
with ``validation_guidance`` > 1 runs true CFG; as Flux's, it renders
unmasked.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..common import TextEncoderSpec
from ..flux.model import Flux
from .transformer import ChromaConfig, ChromaTransformer


class Chroma(Flux):
    NAME = "chroma"
    DEFAULT_FLAVOUR = "base"
    HUGGINGFACE_PATHS = {"base": "lodestones/Chroma"}
    # T5 only: no CLIP pooled stream
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="t5-xxl", family="t5-xxl", subfolder="text_encoder", max_length=512),
    )

    def __init__(self, config: Any, arch: Optional[ChromaConfig] = None):
        if arch is None:
            arch = ChromaConfig.tiny() if getattr(config, "model_arch_preset", None) == "tiny" else ChromaConfig()
        super().__init__(config, arch=arch)

    def create_module(self) -> ChromaTransformer:
        """The DiT (``build_module``): remat of every block, no Flux remat policy."""
        return self.build_module(ChromaTransformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // 8
        txt_len = 16 if self.arch.txt_in_features < 512 else 512
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.latent_channels), device=device),
            "t5_embeds": torch.zeros((batch_size, txt_len, self.arch.txt_in_features), device=device),
            "pooled_embeds": torch.zeros((batch_size, self.arch.vec_in_features), device=device),
        }

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: the T5 sequence embeds, zero ``pooled_embeds`` and the T5 mask."""
        (t5,) = self.text_encoders
        out = t5.encode(prompts)
        return [
            {
                "t5_embeds": np.asarray(out["last_hidden_state"][i], np.float32),
                "pooled_embeds": np.zeros((self.arch.vec_in_features,), np.float32),
                "attention_mask": np.asarray(out["attention_mask"][i]),
            }
            for i in range(len(prompts))
        ]
