"""Z-Image-Omni family.

Counterpart of ``simpletuner_tpu/models/z_image_omni/model.py``: the
flow-matching single-stream DiT of ``transformer.py`` (``ZImageOmniConfig()``,
the published 30-block 3840-wide size, or ``tiny`` under the tiny preset)
conditioned on the 2560-wide Qwen states (the ``qwen2.5`` spec at 512 tokens
from ``text_encoder``) with their mask, 16 latent channels with the Flux VAE.
The transformer takes the reversed timestep ``1 - sigma`` and its output is
negated.  Edit and omni inputs ride the batch: ``control_latents`` (clean
reference latents, the transformer's ``cond_latents``) and
``siglip_embeds``; the data plane that would pair them is not ported
(ROADMAP Queue 1 item 4f), so they come from batches a caller builds.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from .transformer import ZImageOmniConfig, ZImageOmniTransformer


class ZImageOmni(ModelFoundation):
    NAME = "z_image_omni"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    LATENT_CHANNEL_COUNT = 16
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "omni"
    HUGGINGFACE_PATHS = {"omni": "Tongyi-MAI/Z-Image-Omni"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="qwen", family="qwen2.5", subfolder="text_encoder", max_length=512),
    )
    DEFAULT_LORA_TARGET = ("attn_q", "attn_k", "attn_v", "attn_proj")
    VAE_SCALING_FACTOR = 0.3611
    VAE_SHIFT_FACTOR = 0.1159

    def __init__(self, config: Any, arch: Optional[ZImageOmniConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = ZImageOmniConfig.tiny()
        else:
            self.arch = ZImageOmniConfig()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError(f"{self.NAME} is a flow-matching family")

    def create_module(self) -> ZImageOmniTransformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(ZImageOmniTransformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // 8
        shape = (batch_size, latent, latent, self.arch.in_channels)
        return {
            "latents": torch.zeros(shape, device=device),
            "text_embeds": torch.zeros((batch_size, 32, self.arch.cap_feat_dim), device=device),
            "text_attention_mask": torch.ones((batch_size, 32), dtype=torch.int32, device=device),
            "control_latents": torch.zeros(shape, device=device),
            "siglip_embeds": torch.zeros((batch_size, 4, 4, self.arch.siglip_feat_dim), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        inputs = {
            "latents": prepared["noisy_latents"],
            "timesteps": 1.0 - prepared["timesteps"],  # the transformer's clean end is t = 1
            "context": prepared["text_embeds"],
            "context_mask": prepared.get("text_attention_mask"),
        }
        if "control_latents" in prepared:
            inputs["cond_latents"] = prepared["control_latents"]
        if "siglip_embeds" in prepared:
            inputs["siglip_embeds"] = prepared["siglip_embeds"]
        return inputs

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        return -module(**self.get_model_inputs(prepared))

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cond = {"text_embeds": batch["text_embeds"]}
        for key in ("text_attention_mask", "control_latents", "siglip_embeds"):
            if key in batch:
                cond[key] = batch[key]
        return cond

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: the Qwen last hidden state and the mask."""
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
        batch = {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}
        if all("attention_mask" in e for e in embeds):
            batch["text_attention_mask"] = np.stack([np.asarray(e["attention_mask"]) for e in embeds])
        return batch
