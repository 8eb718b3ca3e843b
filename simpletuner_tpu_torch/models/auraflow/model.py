"""AuraFlow family.

Counterpart of ``simpletuner_tpu/models/auraflow/model.py``: the
flow-matching DiT of ``transformer.py`` (``AuraFlowConfig()``, AuraFlow
v0.3's published size, or ``tiny`` under the tiny preset), Pile-T5 at 256
tokens read through the ``t5-xxl`` family from ``text_encoder`` (its spec
names no tokenizer subfolder, so the tokenizer is read from ``tokenizer_2``,
as in the JAX package: ROADMAP Queue 3), 4 latent channels with the SDXL
VAE's scaling factor 0.13025 (the trainer builds the SD ``VAEConfig()`` for
it, as the JAX trainer does), ``get_model_inputs``,
``inference_conditioning``, ``encode_text`` (the last hidden state, with
the mask kept) and ``collate_text_embeds``, which drops the mask as the JAX
family does: the attention runs unmasked over all 256 caption tokens.
AuraFlow has no guidance embedding, so a validation render with
``validation_guidance`` > 1 runs true CFG.  Refused, naming its ROADMAP
Queue 1 item: the ControlNet (``auraflow.controlnet-lora``, 7).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from .transformer import AuraFlowConfig, AuraFlowTransformer

class AuraFlow(ModelFoundation):
    NAME = "auraflow"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    LATENT_CHANNEL_COUNT = 4
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "v0.3"
    HUGGINGFACE_PATHS = {"v0.3": "fal/AuraFlow-v0.3", "v0.2": "fal/AuraFlow-v0.2"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="pile-t5", family="t5-xxl", subfolder="text_encoder", max_length=256),
    )
    DEFAULT_LORA_TARGET = ("attn_q", "attn_k", "attn_v", "attn_proj")
    VAE_SCALING_FACTOR = 0.13025

    def __init__(self, config: Any, arch: Optional[AuraFlowConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = AuraFlowConfig.tiny()
        else:
            self.arch = AuraFlowConfig()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def create_module(self) -> AuraFlowTransformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(AuraFlowTransformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // 8
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.arch.in_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 32, self.arch.text_dim), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {
            "latents": prepared["noisy_latents"],
            "timesteps": prepared["timesteps"],
            "context": prepared["text_embeds"],
        }

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "control_latents" in prepared:
            raise NotImplementedError("the AuraFlow ControlNet is not ported (ROADMAP Queue 1 item 7)")
        return module(**self.get_model_inputs(prepared))

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"text_embeds": batch["text_embeds"]}

    # ---- host-side text encoding ------------------------------------------------------------
    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: the Pile-T5 last hidden state and its mask."""
        (t5,) = self.text_encoders
        out = t5.encode(prompts)
        return [
            {
                "text_embeds": np.asarray(out["last_hidden_state"][i], np.float32),
                "attention_mask": np.asarray(out["attention_mask"][i]),
            }
            for i in range(len(prompts))
        ]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}
