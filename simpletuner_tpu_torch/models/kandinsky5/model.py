"""Kandinsky 5.0 families (video and image).

Counterpart of ``simpletuner_tpu/models/kandinsky5/model.py``: the
flow-matching DiT of ``transformer.py`` (``Kandinsky5Config()``, the Lite
size, with ``visual_cond`` for an I2V flavour; ``tiny`` under the tiny
preset), conditioned on Qwen2.5-VL hidden states at 512 tokens from
``text_encoder`` (the decoder-LLM encoder of ``models/llm_encoder.py`` on
the ``qwen25_7b`` preset) and CLIP-L's pooled state from ``text_encoder_2``.
The DiT takes the timestep at the scheduler's scale (sigma x 1000).  An I2V
flavour packs [noisy latents, first-frame condition, mask] on the channel
axis (zeros and a zero mask when the batch carries no condition).

Mirrored as the JAX families keep them (ROADMAP Queue 3): 4 latent channels
(``LATENT_CHANNEL_COUNT``, the arch's ``in_visual_dim``), so the trainer
builds the 4-channel SD VAE (``VAEConfig()``, scaling 0.18215 in the cache)
for the image flavour and a Wan-config video VAE with 4 latents for the
video flavour, while ``VAE_SCALING_FACTOR`` stays at the base class's 1.0;
``collate_text_embeds`` drops the Qwen mask, so the 512 padded states go
through the text blocks and every cross-attention unmasked; both encoders
read their tokenizer from ``tokenizer/`` (the LLM builder's and the CLIP
builder's default).  ``DEFAULT_LORA_TARGET`` names ``out_layer``, which is
also the feed-forward output and every modulation head; no code reads it,
so without ``lora_target_modules`` every adapter-carrying linear is adapted.
``Kandinsky5Image`` is the same DiT at T = 1 (the frame axis inserted before
the DiT and dropped after).  The JAX ``model_predict_with_intermediates``
(the CREPA tap) is refused by name (ROADMAP Queue 1 item 4h).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from ..video_vae import VideoVAEConfig
from .transformer import Kandinsky5Config, Kandinsky5Transformer


class Kandinsky5Video(ModelFoundation):
    NAME = "kandinsky5_video"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    MODALITY = "video"
    LATENT_CHANNEL_COUNT = 4
    DEFAULT_RESOLUTION = 512
    DEFAULT_FLAVOUR = "lite-t2v"
    HUGGINGFACE_PATHS = {
        "lite-t2v": "ai-forever/Kandinsky-5.0-T2V-Lite-sft-5s",
        "lite-i2v": "ai-forever/Kandinsky-5.0-I2V-Lite-sft-5s",
    }
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="qwen2.5-vl", family="qwen2.5-vl", subfolder="text_encoder", max_length=512),
        TextEncoderSpec(name="clip-l", family="clip-l", subfolder="text_encoder_2", max_length=77, output="pooled"),
    )
    DEFAULT_LORA_TARGET = ("to_query", "to_key", "to_value", "out_layer")

    def __init__(self, config: Any, arch: Optional[Kandinsky5Config] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = Kandinsky5Config.tiny()
        else:
            self.arch = Kandinsky5Config(visual_cond="i2v" in str(self.flavour or ""))

    @property
    def latent_channels(self) -> int:
        return self.arch.in_visual_dim

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError(f"{self.NAME} is a flow-matching family")

    def create_module(self) -> Kandinsky5Transformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(Kandinsky5Transformer)

    def video_vae_config(self) -> VideoVAEConfig:
        base = VideoVAEConfig.tiny() if getattr(self.config, "model_arch_preset", None) == "tiny" else \
            VideoVAEConfig.wan()
        return dataclasses.replace(base, latent_channels=self.arch.in_visual_dim)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        return {
            "latents": torch.zeros((batch_size, 2, 8, 8, self.arch.in_visual_dim), device=device),
            "text_embeds": torch.zeros((batch_size, 10, self.arch.in_text_dim), device=device),
            "pooled_embeds": torch.zeros((batch_size, self.arch.in_text_dim2), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        noisy = prepared["noisy_latents"]  # (B, T, H, W, C)
        if self.arch.visual_cond:
            cond, mask = prepared.get("i2v_cond_latents"), prepared.get("i2v_cond_mask")
            if cond is None:
                cond = torch.zeros_like(noisy)
                mask = torch.zeros(noisy.shape[:-1] + (1,), dtype=noisy.dtype, device=noisy.device)
            elif mask is None:
                mask = torch.ones(noisy.shape[:-1] + (1,), dtype=noisy.dtype, device=noisy.device)
            noisy = torch.cat([noisy, cond, mask], dim=-1)
        return {
            "latents": noisy,
            "text_embeds": prepared["text_embeds"],
            "pooled_embeds": prepared["pooled_embeds"],
            # the scheduler's scale (sigma x 1000)
            "timesteps": prepared["timesteps"].to(torch.float32) * 1000.0,
        }

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        return module(**self.get_model_inputs(prepared))

    def model_predict_with_intermediates(self, module: nn.Module, prepared: Dict[str, torch.Tensor]):
        raise NotImplementedError("the Kandinsky 5.0 per-block intermediates tap (CREPA) is not ported "
                                  "(ROADMAP Queue 1 item 4h)")

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"text_embeds": batch["text_embeds"], "pooled_embeds": batch["pooled_embeds"]}

    # ---- host-side text encoding ------------------------------------------------------------
    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: Qwen2.5-VL's final-norm states (pads kept),
        CLIP-L's pooled state and the Qwen mask."""
        qwen, clip = self.text_encoders
        seq, pooled = qwen.encode(prompts), clip.encode(prompts)
        return [
            {
                "text_embeds": np.asarray(seq["last_hidden_state"][i], np.float32),
                "pooled_embeds": np.asarray(pooled["pooled"][i], np.float32),
                "attention_mask": np.asarray(seq["attention_mask"][i]),
            }
            for i in range(len(prompts))
        ]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """The states and pooled vectors; the mask is dropped, as the JAX family drops it."""
        return {
            "text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds]),
            "pooled_embeds": np.stack([np.asarray(e["pooled_embeds"]) for e in embeds]),
        }


class Kandinsky5Image(Kandinsky5Video):
    """The same DiT at T = 1 (the image flavour rides the video transformer
    with single-frame latents)."""

    NAME = "kandinsky5_image"
    MODALITY = "image"
    DEFAULT_FLAVOUR = "lite"
    HUGGINGFACE_PATHS = {"lite": "ai-forever/Kandinsky-5.0-T2I-Lite"}

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = max(resolution // 8, 8)
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.arch.in_visual_dim), device=device),
            "text_embeds": torch.zeros((batch_size, 10, self.arch.in_text_dim), device=device),
            "pooled_embeds": torch.zeros((batch_size, self.arch.in_text_dim2), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        prepared = dict(prepared)
        prepared["noisy_latents"] = prepared["noisy_latents"][:, None]  # T = 1
        return super().get_model_inputs(prepared)

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        return module(**self.get_model_inputs(prepared))[:, 0]  # the frame axis dropped
