"""ERNIE-Image family.

Counterpart of ``simpletuner_tpu/models/ernie/model.py``: the single-stream
DiT of ``transformer.py`` (``ErnieConfig()``, 3072 wide, 24 layers, or
``tiny`` under the tiny preset) over 32-channel latents packed 2 x 2 in
(ph, pw, c) order to its 128 input channels, conditioned on the final-norm
hidden states of the ``qwen2.5`` spec (the 2560-wide qwen2-layout trunk) at
512 tokens from ``text_encoder``; the timesteps reach the DiT at scheduler
scale (sigma x 1000) and the text lengths come from the mask (the full
length without one).

Mirrored as the JAX family keeps them (ROADMAP Queue 3):
``LATENT_CHANNEL_COUNT`` is 32 while the trainer builds the 16-channel
``VAEConfig.flux()`` for every family of 16 channels or more, so the
published ``x_embedder`` (128 features) cannot take the latents its VAE
makes, in both packages (the tiny preset's 16 packed channels train); the
render payload keeps the mask as ``attention_mask``, which
``inference_conditioning`` does not read, so renders take every text token
as valid.  ``DEFAULT_LORA_TARGET`` is read by no code.  The JAX
``model_predict_with_intermediates`` (the CREPA tap) is refused by name
(ROADMAP Queue 1 item 4h).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from .transformer import ErnieConfig, ErnieTransformer


def pack_2x2(latents: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C) in (ph, pw, c) order."""
    batch, height, width, channels = latents.shape
    packed = latents.reshape(batch, height // 2, 2, width // 2, 2, channels).permute(0, 1, 3, 2, 4, 5)
    return packed.reshape(batch, height // 2, width // 2, 4 * channels)


def unpack_2x2(out: torch.Tensor, height: int, width: int, channels: int) -> torch.Tensor:
    """Inverse of :func:`pack_2x2` to (B, height, width, channels)."""
    batch = out.shape[0]
    out = out.reshape(batch, height // 2, width // 2, 2, 2, channels).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(batch, height, width, channels)


class Ernie(ModelFoundation):
    NAME = "ernie"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    LATENT_CHANNEL_COUNT = 32
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "v1"
    HUGGINGFACE_PATHS = {"v1": "baidu/ERNIE-4.5-VL-image"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="ernie-vl", family="qwen2.5", subfolder="text_encoder", max_length=512),
    )
    DEFAULT_LORA_TARGET = ("to_q", "to_k", "to_v", "to_out")

    def __init__(self, config: Any, arch: Optional[ErnieConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = ErnieConfig.tiny()
        else:
            self.arch = ErnieConfig()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels // 4  # 2x2 packing of the cache latents

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("ernie is a flow-matching family")

    def create_module(self) -> ErnieTransformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(ErnieTransformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = max(resolution // 8, 8)
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.latent_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 8, self.arch.text_in_dim), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        noisy = prepared["noisy_latents"]  # (B, H, W, C)
        text = prepared["text_embeds"]
        mask = prepared.get("text_attention_mask")
        if mask is None:
            lens = torch.full((noisy.shape[0],), text.shape[1], dtype=torch.int32, device=noisy.device)
        else:
            lens = mask.to(torch.int32).sum(dim=1, dtype=torch.int32)
        return {
            "latents": pack_2x2(noisy),
            "timesteps": prepared["timesteps"].to(torch.float32) * 1000.0,
            "text_embeds": text,
            "text_lens": lens,
        }

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        out = module(**self.get_model_inputs(prepared))
        _, height, width, channels = prepared["noisy_latents"].shape
        return unpack_2x2(out, height, width, channels)

    def model_predict_with_intermediates(self, module: nn.Module, prepared: Dict[str, torch.Tensor]):
        raise NotImplementedError("the ernie per-block intermediates tap (CREPA) is not ported "
                                  "(ROADMAP Queue 1 item 4h)")

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cond = {"text_embeds": batch["text_embeds"]}
        if "text_attention_mask" in batch:
            cond["text_attention_mask"] = batch["text_attention_mask"]
        return cond

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: the trunk's final-norm states and the mask."""
        (encoder,) = self.text_encoders
        out = encoder.encode(prompts)
        return [{"text_embeds": np.asarray(out["last_hidden_state"][i], np.float32),
                 "attention_mask": np.asarray(out["attention_mask"][i])} for i in range(len(prompts))]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        out = {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}
        if all("attention_mask" in e for e in embeds):
            out["text_attention_mask"] = np.stack([np.asarray(e["attention_mask"]) for e in embeds])
        return out
