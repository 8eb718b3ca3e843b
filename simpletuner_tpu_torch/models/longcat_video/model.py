"""LongCat-Video family.

Counterpart of ``simpletuner_tpu/models/longcat_video/model.py``: the
flow-matching video DiT of ``transformer.py`` (``LongCatVideoConfig()``, the
published 13.6B: 48 blocks, 4096 wide, 32 heads of 128; ``tiny`` under the
tiny preset), T5-XXL at 512 tokens read through the ``t5-xxl`` family from
``text_encoder`` (its tokenizer from ``tokenizer_2``, as the T5 spec reads
it), the causal video VAE at the arch's 16 latent channels
(``video_vae_config``: ``VideoVAEConfig.wan()``, ``tiny`` at the tiny arch's
4), unscaled.  The DiT takes the timestep at the scheduler's scale (sigma x
1000); ``encode_text`` keeps the whole last hidden state and the mask, the
collate keeps the mask as ``text_attention_mask`` and the DiT masks the T5
pads as keys.

Mirrored as the JAX family keeps it: ``DEFAULT_LORA_TARGET`` leaves out the
FFN, which the key map includes; no code reads it, so without
``lora_target_modules`` every adapter-carrying linear (the FFN's too) is
adapted (ROADMAP Queue 3).  The JAX ``model_predict_with_intermediates`` (the
CREPA tap) is refused by name (ROADMAP Queue 1 item 4h).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from ..video_vae import VideoVAEConfig
from .transformer import LongCatVideoConfig, LongCatVideoTransformer


class LongcatVideo(ModelFoundation):
    NAME = "longcat_video"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    MODALITY = "video"
    LATENT_CHANNEL_COUNT = 16
    DEFAULT_RESOLUTION = 480
    DEFAULT_FLAVOUR = "v1"
    HUGGINGFACE_PATHS = {"v1": "meituan-longcat/LongCat-Video"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="t5-xxl", family="t5-xxl", subfolder="text_encoder", max_length=512),
    )
    DEFAULT_LORA_TARGET = ("qkv", "attn_proj", "crs_q", "crs_kv", "crs_proj")

    def __init__(self, config: Any, arch: Optional[LongCatVideoConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = LongCatVideoConfig.tiny()
        else:
            self.arch = LongCatVideoConfig()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("longcat_video is a flow-matching family")

    def create_module(self) -> LongCatVideoTransformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(LongCatVideoTransformer)

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
        raise NotImplementedError("the longcat_video per-block intermediates tap (CREPA) is not ported "
                                  "(ROADMAP Queue 1 item 4h)")

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cond = {"text_embeds": batch["text_embeds"]}
        if "text_attention_mask" in batch:
            cond["text_attention_mask"] = batch["text_attention_mask"]
        return cond

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: the T5 last hidden state (pads kept) and its mask."""
        (t5,) = self.text_encoders
        out = t5.encode(prompts)
        return [{"text_embeds": np.asarray(out["last_hidden_state"][i], np.float32),
                 "attention_mask": np.asarray(out["attention_mask"][i])} for i in range(len(prompts))]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        out = {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}
        if all("attention_mask" in e for e in embeds):
            out["text_attention_mask"] = np.stack([np.asarray(e["attention_mask"]) for e in embeds])
        return out
