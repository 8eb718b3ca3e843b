"""HunyuanVideo 1.5 family.

Counterpart of ``simpletuner_tpu/models/hunyuanvideo/model.py``: the
flow-matching MMDiT of ``transformer.py`` (``HunyuanVideo15Config()``, the
8.3B published size; ``tiny`` under the tiny preset), Qwen2.5-VL hidden
states at 256 tokens from ``text_encoder`` (the decoder-LLM encoder on the
``qwen25_7b`` preset) and ByT5 states at 77 tokens from ``text_encoder_2``,
read through the ``t5-xxl`` family (a T5 encoder at the file's
``config.json`` sizes; its tokenizer from ``tokenizer_2`` through
``T5TokenizerFast``), 32 latent channels of the causal video VAE at the Wan
config (``video_vae_config``; ``tiny`` under the tiny preset).  Both masks
ride every path (``encode_text``, ``collate_text_embeds`` as ``text_mask``
and ``text_mask_2``, ``inference_conditioning``) into the DiT's segment ids.
``get_model_inputs`` packs [noisy latents, condition, mask] when the arch's
``in_channels`` is ``2 C + 1``: for an I2V flavour the clean first latent
frame (later frames zero) and a frame-0 mask, for T2V zeros and a zero
mask, so the published 65 channels go in either way.

Mirrored as the JAX family keeps them (ROADMAP Queue 3): the video cache
holds the video VAE's unscaled latents while a render divides by
``VAE_SCALING_FACTOR`` (0.476986) before the decode; the JAX preset's 8x
Wan VAE with the (1, 1, 1) patch gives about 4x the tokens of the published
16x VAE; the image-embed stream is in ``example_batch`` but in no collated
batch.  The SR upsampler (``load_sr_upsampler``) and the intermediates tap
(CREPA) are refused by name (ROADMAP Queue 1 items 6 and 4h).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from ..video_vae import VideoVAEConfig
from .transformer import HunyuanVideo15Config, HunyuanVideo15Transformer


class HunyuanVideo(ModelFoundation):
    NAME = "hunyuanvideo"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    MODALITY = "video"
    LATENT_CHANNEL_COUNT = 32
    DEFAULT_RESOLUTION = 480
    DEFAULT_FLAVOUR = "t2v-480p"
    HUGGINGFACE_PATHS = {
        "t2v-480p": "tencent/HunyuanVideo-1.5",
        "i2v-480p": "tencent/HunyuanVideo-1.5",
    }
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="qwen2.5-vl", family="qwen2.5-vl", subfolder="text_encoder", max_length=256),
        TextEncoderSpec(name="byt5", family="t5-xxl", subfolder="text_encoder_2", max_length=77),
    )
    DEFAULT_LORA_TARGET = ("img_attn_q", "img_attn_k", "img_attn_v", "img_attn_proj")
    VAE_SCALING_FACTOR = 0.476986

    def __init__(self, config: Any, arch: Optional[HunyuanVideo15Config] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = HunyuanVideo15Config.tiny()
        else:
            self.arch = HunyuanVideo15Config()

    @property
    def is_i2v(self) -> bool:
        return bool(self.flavour and "i2v" in str(self.flavour))

    @property
    def latent_channels(self) -> int:
        return self.arch.out_channels

    def video_vae_config(self) -> VideoVAEConfig:
        if getattr(self.config, "model_arch_preset", None) == "tiny":
            return VideoVAEConfig.tiny()
        return dataclasses.replace(VideoVAEConfig.wan(), latent_channels=self.arch.out_channels)

    @staticmethod
    def load_sr_upsampler(kind: str, path: str, tiny: bool = False):
        raise NotImplementedError("the HunyuanVideo 1.5 SR latent upsampler is not ported (ROADMAP Queue 1 item 6)")

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("hunyuanvideo is a flow-matching family")

    def create_module(self) -> HunyuanVideo15Transformer:
        """The DiT (``build_module``): remat of every dual-stream block."""
        return self.build_module(HunyuanVideo15Transformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // self.video_vae_config().spatial_factor
        return {
            "latents": torch.zeros((batch_size, 3, latent, latent, self.latent_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 32, self.arch.text_dim), device=device),
            "text_embeds_2": torch.zeros((batch_size, 16, self.arch.text2_dim), device=device),
            # zeros mark t2v
            "image_embeds": torch.zeros((batch_size, 8, self.arch.image_embed_dim), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        noisy = prepared["noisy_latents"]
        if self.arch.in_channels == 2 * noisy.shape[-1] + 1:
            # the i2v packing: [noisy, first-frame condition latents, frame mask]
            mask = torch.zeros(noisy.shape[:-1] + (1,), dtype=noisy.dtype, device=noisy.device)
            clean = prepared.get("latents")
            if self.is_i2v:
                clean = torch.zeros_like(noisy) if clean is None else clean
                cond = torch.cat([clean[:, :1], torch.zeros_like(clean[:, 1:])], dim=1).to(noisy.dtype)
                mask[:, 0] = 1.0
            else:
                cond = torch.zeros_like(noisy)
            noisy = torch.cat([noisy, cond, mask], dim=-1)
        inputs = {"latents": noisy, "timesteps": prepared["timesteps"], "context": prepared["text_embeds"]}
        for ours, theirs in (("context_mask", "text_mask"), ("context_2", "text_embeds_2"),
                             ("context_2_mask", "text_mask_2"), ("image_embeds", "image_embeds")):
            if theirs in prepared:
                inputs[ours] = prepared[theirs]
        return inputs

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        return module(**self.get_model_inputs(prepared))

    def model_predict_with_intermediates(self, module: nn.Module, prepared: Dict[str, torch.Tensor]):
        raise NotImplementedError("the HunyuanVideo per-block intermediates tap (CREPA) is not ported "
                                  "(ROADMAP Queue 1 item 4h)")

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in batch.items() if k != "latents"}

    # ---- host-side text encoding ------------------------------------------------------------
    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: Qwen2.5-VL's final-norm states and mask,
        ByT5's last hidden state and mask."""
        qwen, byt5 = self.text_encoders
        out_q, out_b = qwen.encode(prompts), byt5.encode(prompts)
        return [
            {
                "text_embeds": np.asarray(out_q["last_hidden_state"][i], np.float32),
                "text_mask": np.asarray(out_q["attention_mask"][i]),
                "text_embeds_2": np.asarray(out_b["last_hidden_state"][i], np.float32),
                "text_mask_2": np.asarray(out_b["attention_mask"][i]),
                "attention_mask": np.asarray(out_q["attention_mask"][i]),
            }
            for i in range(len(prompts))
        ]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {key: np.stack([np.asarray(e[key]) for e in embeds])
                for key in ("text_embeds", "text_mask", "text_embeds_2", "text_mask_2")}
