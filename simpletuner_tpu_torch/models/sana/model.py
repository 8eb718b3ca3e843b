"""Sana family.

Counterpart of ``simpletuner_tpu/models/sana/model.py``: the flow DiT of
``transformer.py`` (``SanaConfig()``, the 1600M: 20 blocks, 2240 wide;
``tiny`` under the tiny preset) over 32-channel latents, conditioned on the
``gemma`` spec (Gemma-2 2B's last hidden state) at 300 tokens from
``text_encoder``, with the complex-human-instruction wrapper
(``CHI_TEMPLATE``) around each prompt under ``sana_complex_human_instruction``.
The DiT takes raw sigmas (the x 1000 is inside its sinusoid).

Mirrored as the JAX family keeps them (ROADMAP Queue 3): the collate keeps
only ``text_embeds``, so the cross-attention attends Gemma's pad keys;
``600m-1024`` builds the same 1600M ``SanaConfig()`` as ``1600m-1024``;
``VAE_SCALING_FACTOR`` is DC-AE's 0.41407, which neither package has: both
trainers build the 16-channel ``VAEConfig.flux()`` for every family of 16
channels or more, so the published 32-channel ``patch_in`` cannot take the
latents its VAE makes (the tiny preset's 4 channels train, with the tiny SD
VAE), and ``Validation`` divides by 0.41407 before its decode.
``DEFAULT_LORA_TARGET`` is read by no code.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from .transformer import SanaConfig, SanaTransformer


class Sana(ModelFoundation):
    NAME = "sana"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    LATENT_CHANNEL_COUNT = 32
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "1600m-1024"
    HUGGINGFACE_PATHS = {
        "1600m-1024": "Efficient-Large-Model/Sana_1600M_1024px_diffusers",
        "600m-1024": "Efficient-Large-Model/Sana_600M_1024px_diffusers",
    }
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="gemma-2", family="gemma", subfolder="text_encoder", max_length=300),
    )
    DEFAULT_LORA_TARGET = ("attn1_q", "attn1_k", "attn1_v", "attn1_proj")
    VAE_SCALING_FACTOR = 0.41407
    # the reference pipeline's complex human instruction: a fixed block
    # before the user prompt
    CHI_TEMPLATE = (
        "Given a user prompt, generate an 'Enhanced prompt' that provides "
        "detailed visual descriptions suitable for image generation. Here are "
        "examples of how to transform or refine prompts: User Prompt: A cat "
        "sleeping -> Enhanced: A small, fluffy white cat curled up in a round "
        "shape, sleeping peacefully on a warm sunny windowsill. User Prompt: "
        "{prompt} -> Enhanced:"
    )

    def __init__(self, config: Any, arch: Optional[SanaConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = SanaConfig.tiny()
        else:
            self.arch = SanaConfig()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("sana is a flow-matching family")

    def create_module(self) -> SanaTransformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(SanaTransformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // 8
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.arch.in_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 32, self.arch.text_dim), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"latents": prepared["noisy_latents"], "timesteps": prepared["timesteps"],
                "context": prepared["text_embeds"]}

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        return module(**self.get_model_inputs(prepared))

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"text_embeds": batch["text_embeds"]}

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt (wrapped in ``CHI_TEMPLATE`` under
        ``sana_complex_human_instruction``): Gemma's last hidden state (pads
        kept) and its mask."""
        (gemma,) = self.text_encoders
        if getattr(self.config, "sana_complex_human_instruction", False):
            prompts = [self.CHI_TEMPLATE.format(prompt=p) for p in prompts]
        out = gemma.encode(prompts)
        return [{"text_embeds": np.asarray(out["last_hidden_state"][i], np.float32),
                 "attention_mask": np.asarray(out["attention_mask"][i])} for i in range(len(prompts))]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}
