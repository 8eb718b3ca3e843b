"""Zlab-i1 family.

Counterpart of ``simpletuner_tpu/models/zlab_i1/model.py``: the 3B
timestep-free U-ViT of ``transformer.py`` (``ZlabI1Config()``, 2016 wide, 28
heads of 72, 29 blocks, or ``tiny`` under the tiny preset) on 32-channel
FLUX.2 VAE latents, conditioned on 2304-wide Gemma-2 states (the
``gemma-2`` spec at 256 tokens from ``text_encoder``, standing for the
T5Gemma encoder) with their mask.  ``transform_latents`` normalizes 32-channel
latents per channel over the 2x pixel-unshuffled layout (tiny archs skip it);
the network predicts x0 - noise (flow direction -1), so ``model_predict``
negates it onto the trained noise - x0 target.

Neither package has a VAE for FLUX.2's 32 channels (ROADMAP Queue 3): the
trainer builds the 16-channel Flux VAE for every family with 16 channels or
more, so the published arch trains and renders only from latents a caller
supplies (a seeded batch through ``build_train_step``, the sampler without a
decode).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from .latent_utils import normalize_flux2_latents
from .transformer import ZlabI1Config, ZlabI1Transformer


class ZlabI1(ModelFoundation):
    NAME = "zlab_i1"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    LATENT_CHANNEL_COUNT = 32
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "3b"
    HUGGINGFACE_PATHS = {"3b": "zlab-princeton/i1-3B"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="t5gemma", family="gemma-2", subfolder="text_encoder", max_length=256),
    )
    DEFAULT_LORA_TARGET = ("qkv_image", "qkv_text", "proj_image", "proj_text", "w12", "w3")
    VAE_SCALING_FACTOR = 1.0

    def __init__(self, config: Any, arch: Optional[ZlabI1Config] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = ZlabI1Config.tiny()
        else:
            self.arch = ZlabI1Config()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError(f"{self.NAME} is a flow-matching family")

    def create_module(self) -> ZlabI1Transformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(ZlabI1Transformer)

    def transform_latents(self, latents: torch.Tensor) -> torch.Tensor:
        # the channel statistics are the published 32-channel layout's
        if latents.shape[-1] == 32:
            return normalize_flux2_latents(latents.to(torch.float32))
        return latents

    def example_batch(self, batch_size: int = 1, resolution: Optional[int] = None,
                      device=None) -> Dict[str, torch.Tensor]:
        # the native grid by default (the learned pos_embed's)
        latent = (resolution or self.arch.input_size * 8) // 8
        tokens = self.arch.text_num_tokens
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.arch.in_channels), device=device),
            "text_embeds": torch.zeros((batch_size, tokens, self.arch.text_embed_dim), device=device),
            "text_attention_mask": torch.ones((batch_size, tokens), dtype=torch.int32, device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        inputs = {
            "latents": prepared["noisy_latents"],
            "timesteps": prepared["timesteps"],
            "context": prepared["text_embeds"],
            "context_mask": prepared.get("text_attention_mask"),
        }
        if "caption_dropout" in prepared:
            inputs["caption_dropout"] = prepared["caption_dropout"]
        return inputs

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        # flow direction -1: the network predicts x0 - noise
        return -module(**self.get_model_inputs(prepared))

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cond = {"text_embeds": batch["text_embeds"]}
        if "text_attention_mask" in batch:
            cond["text_attention_mask"] = batch["text_attention_mask"]
        return cond

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: the encoder's last hidden state and the mask."""
        (encoder,) = self.text_encoders
        out = encoder.encode(prompts)
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
