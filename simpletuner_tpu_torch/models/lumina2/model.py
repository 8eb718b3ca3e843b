"""Lumina-Image 2.0 family.

Counterpart of ``simpletuner_tpu/models/lumina2/model.py``: the flow-matching
Next-DiT of ``transformer.py`` (``Lumina2Config()``, the published 2.6B
size, or ``tiny`` under the tiny preset), Gemma-2 2B hidden states at 256
tokens from ``text_encoder`` (the decoder-LLM encoder of
``models/llm_encoder.py``; the final-norm state, ROADMAP Queue 3), 16
latent channels with the Flux VAE (scaling 0.3611, shift 0.1159: the
trainer builds ``VAEConfig.flux()`` for every 16-channel family, as the JAX
trainer does).  The transformer takes the reversed timestep ``1 - sigma``
and its output is negated (diffusers' Lumina2 convention), so the trained
target is the usual ``noise - latents`` velocity.  The caption mask rides
every path (``encode_text``, ``collate_text_embeds`` as
``text_attention_mask``, ``inference_conditioning``) into the DiT's segment
ids.  Lumina2 has no guidance embedding, so a validation render with
``validation_guidance`` > 1 runs true CFG.  ``DEFAULT_LORA_TARGET`` names the
attention modules but, as in the JAX package, no code reads it: without
``lora_target_modules`` every adapter-carrying linear is adapted.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from .transformer import Lumina2Config, Lumina2Transformer


class Lumina2(ModelFoundation):
    NAME = "lumina2"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    LATENT_CHANNEL_COUNT = 16
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "2.0"
    HUGGINGFACE_PATHS = {"2.0": "Alpha-VLLM/Lumina-Image-2.0"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="gemma-2", family="gemma-2", subfolder="text_encoder", max_length=256),
    )
    DEFAULT_LORA_TARGET = ("attn_q", "attn_k", "attn_v", "attn_proj")
    VAE_SCALING_FACTOR = 0.3611  # the Flux VAE
    VAE_SHIFT_FACTOR = 0.1159

    def __init__(self, config: Any, arch: Optional[Lumina2Config] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = Lumina2Config.tiny()
        else:
            self.arch = Lumina2Config()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("lumina2 is a flow-matching family")

    def create_module(self) -> Lumina2Transformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(Lumina2Transformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // 8
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.arch.in_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 32, self.arch.cap_feat_dim), device=device),
            "text_attention_mask": torch.ones((batch_size, 32), dtype=torch.int32, device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {
            "latents": prepared["noisy_latents"],
            # the reversed timestep (diffusers' Lumina2 ``1 - t / T``)
            "timesteps": 1.0 - prepared["timesteps"],
            "context": prepared["text_embeds"],
            "context_mask": prepared.get("text_attention_mask"),
        }

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        # the reverse flow: the transformer's output is negated
        return -module(**self.get_model_inputs(prepared))

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cond = {"text_embeds": batch["text_embeds"]}
        if "text_attention_mask" in batch:
            cond["text_attention_mask"] = batch["text_attention_mask"]
        return cond

    # ---- host-side text encoding ------------------------------------------------------------
    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: Gemma-2's final-norm hidden states and the mask."""
        (gemma,) = self.text_encoders
        out = gemma.encode(prompts)
        return [
            {
                "text_embeds": np.asarray(out["last_hidden_state"][i], np.float32),
                "attention_mask": np.asarray(out["attention_mask"][i]),
            }
            for i in range(len(prompts))
        ]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        batch = {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}
        if all("attention_mask" in e for e in embeds):
            batch["text_attention_mask"] = np.stack([np.asarray(e["attention_mask"]) for e in embeds])
        return batch
