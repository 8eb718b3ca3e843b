"""Sana-Video family.

Counterpart of ``simpletuner_tpu/models/sanavideo/model.py``: the
linear-attention video DiT of ``transformer.py`` (``SanaVideoConfig()``, the
2B: 20 blocks, 2240 wide; ``tiny`` under the tiny preset) over the causal
video VAE at the arch's 16 latent channels (``video_vae_config``:
``VideoVAEConfig.wan()``, ``tiny`` at the tiny arch's 4), unscaled,
conditioned on the ``gemma-2`` spec at 300 tokens from ``text_encoder``.  The
DiT takes the timestep at the scheduler's scale (sigma x 1000); the collate
keeps the mask as ``text_attention_mask``, which the DiT turns into key ids.
``DEFAULT_LORA_TARGET`` is read by no code.  The JAX
``model_predict_with_intermediates`` (the CREPA tap) is refused by name
(ROADMAP Queue 1 item 4h).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from ..video_vae import VideoVAEConfig
from .transformer import SanaVideoConfig, SanaVideoTransformer


class SanaVideo(ModelFoundation):
    NAME = "sanavideo"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    MODALITY = "video"
    LATENT_CHANNEL_COUNT = 16
    DEFAULT_RESOLUTION = 480
    DEFAULT_FLAVOUR = "2b"
    HUGGINGFACE_PATHS = {"2b": "Efficient-Large-Model/SANA-Video_2B_480p"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="gemma-2", family="gemma-2", subfolder="text_encoder", max_length=300),
    )
    DEFAULT_LORA_TARGET = ("attn1_q", "attn1_k", "attn1_v", "attn1_proj",
                           "attn2_q", "attn2_k", "attn2_v", "attn2_proj")

    def __init__(self, config: Any, arch: Optional[SanaVideoConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = SanaVideoConfig.tiny()
        else:
            self.arch = SanaVideoConfig()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("sanavideo is a flow-matching family")

    def create_module(self) -> SanaVideoTransformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(SanaVideoTransformer)

    def video_vae_config(self) -> VideoVAEConfig:
        base = VideoVAEConfig.tiny() if getattr(self.config, "model_arch_preset", None) == "tiny" \
            else VideoVAEConfig.wan()
        return dataclasses.replace(base, latent_channels=self.arch.in_channels)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        del resolution
        return {
            "latents": torch.zeros((batch_size, 2, 8, 8, self.arch.in_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 10, self.arch.caption_channels), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        inputs = {
            "latents": prepared["noisy_latents"],
            "timesteps": prepared["timesteps"].to(torch.float32) * 1000.0,
            "context": prepared["text_embeds"],
        }
        if "text_attention_mask" in prepared:
            inputs["context_mask"] = prepared["text_attention_mask"]
        return inputs

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        return module(**self.get_model_inputs(prepared))

    def model_predict_with_intermediates(self, module: nn.Module, prepared: Dict[str, torch.Tensor]):
        raise NotImplementedError("the sanavideo per-block intermediates tap (CREPA) is not ported "
                                  "(ROADMAP Queue 1 item 4h)")

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cond = {"text_embeds": batch["text_embeds"]}
        if "text_attention_mask" in batch:
            cond["text_attention_mask"] = batch["text_attention_mask"]
        return cond

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: Gemma-2's last hidden state (pads kept) and its mask."""
        (gemma,) = self.text_encoders
        out = gemma.encode(prompts)
        return [{"text_embeds": np.asarray(out["last_hidden_state"][i], np.float32),
                 "attention_mask": np.asarray(out["attention_mask"][i])} for i in range(len(prompts))]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        out = {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}
        if all("attention_mask" in e for e in embeds):
            out["text_attention_mask"] = np.stack([np.asarray(e["attention_mask"]) for e in embeds])
        return out
