"""Qwen-Image family.

Counterpart of ``simpletuner_tpu/models/qwen_image/model.py``: the
flow-matching MMDiT of ``transformer.py`` (``QwenImageConfig()``, the
published 20B size, or ``tiny`` under the tiny preset), conditioned on
Qwen2.5-VL hidden states at 1024 tokens from ``text_encoder`` (the
decoder-LLM encoder of ``models/llm_encoder.py`` on the ``qwen25_7b``
preset), over 2x2-packed latents (Flux's ``pack_latents`` /
``unpack_latents``) of 16 channels: the trainer builds ``VAEConfig.flux()``
for every family with 16 channels or more, as the JAX trainer does.

Mirrored as the JAX family keeps them (ROADMAP Queue 3): the text is
unmasked, since ``collate_text_embeds`` drops the mask and
``get_model_inputs`` passes no segment ids, so all 1024 padded Qwen tokens
attend; the latents are cached with the Flux VAE config (a published
Qwen-Image ``vae/`` is another layout, which neither package loads).
``DEFAULT_LORA_TARGET`` names the image attention, but no code reads it:
without ``lora_target_modules`` every adapter-carrying linear is adapted.
The JAX ``model_predict_with_intermediates`` (the CREPA tap) is refused by
name (ROADMAP Queue 1 item 4h).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from ..flux.transformer import pack_latents, unpack_latents
from .transformer import QwenImageConfig, QwenImageTransformer


class QwenImage(ModelFoundation):
    NAME = "qwen_image"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    LATENT_CHANNEL_COUNT = 16
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "v1"
    HUGGINGFACE_PATHS = {"v1": "Qwen/Qwen-Image", "edit": "Qwen/Qwen-Image-Edit"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="qwen2.5-vl", family="qwen2.5-vl", subfolder="text_encoder", max_length=1024),
    )
    DEFAULT_LORA_TARGET = ("img_attn_q", "img_attn_k", "img_attn_v", "img_attn_proj")
    VAE_SCALING_FACTOR = 0.3611
    VAE_SHIFT_FACTOR = 0.1159

    def __init__(self, config: Any, arch: Optional[QwenImageConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = QwenImageConfig.tiny()
        else:
            self.arch = QwenImageConfig()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels // 4  # 2x2 packing

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError(f"{self.NAME} is a flow-matching family")

    def create_module(self) -> QwenImageTransformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(QwenImageTransformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // 8
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.latent_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 32, self.arch.txt_in_features), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        noisy = prepared["noisy_latents"]
        return {
            "img": pack_latents(noisy),
            "img_hw": (noisy.shape[1] // 2, noisy.shape[2] // 2),
            "txt": prepared["text_embeds"],
            "timesteps": prepared["timesteps"],
        }

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        height, width = prepared["noisy_latents"].shape[1:3]
        return unpack_latents(module(**self.get_model_inputs(prepared)), height, width)

    def model_predict_with_intermediates(self, module: nn.Module, prepared: Dict[str, torch.Tensor]):
        raise NotImplementedError(f"the {self.NAME} per-block intermediates tap (CREPA) is not ported "
                                  "(ROADMAP Queue 1 item 4h)")

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"text_embeds": batch["text_embeds"]}

    # ---- host-side text encoding ------------------------------------------------------------
    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: the Qwen final-norm states (pads kept) and the mask."""
        (qwen,) = self.text_encoders
        out = qwen.encode(prompts)
        return [
            {
                "text_embeds": np.asarray(out["last_hidden_state"][i], np.float32),
                "attention_mask": np.asarray(out["attention_mask"][i]),
            }
            for i in range(len(prompts))
        ]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """The states; the mask is dropped, as the JAX family drops it."""
        return {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}
