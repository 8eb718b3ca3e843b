"""PixArt-Sigma family.

Counterpart of ``simpletuner_tpu/models/pixart/model.py``: the epsilon DiT of
``transformer.py`` (``PixartConfig.sigma_1024()``, ``sigma_512()`` for the
``512-ms`` flavour, ``tiny`` under the tiny preset), the IDDPM ``linear``
beta ladder from 1e-4 to 0.02 (the hub ``scheduler_config.json``, read by
``ddpm_schedule_config`` from the class attributes), T5-XXL at 300 tokens
(``text_encoder``), scaling factor 0.13025, ``get_model_inputs``,
``inference_conditioning``, ``encode_text`` (the last hidden state, with the
mask kept) and ``collate_text_embeds``, which drops the mask as the JAX
family does: cross-attention runs unmasked over all 300 keys.  Refused,
naming their ROADMAP Queue 1 items: the ControlNet (PixArt-delta, 7) and the
staged stage-1 / stage-2 validation (``pixart_validation_pipeline_mode:
full-pipeline``, 4d).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from .transformer import PixartConfig, PixartTransformer

class PixartSigma(ModelFoundation):
    STAGED_VALIDATION_PREFIX = "pixart"
    NAME = "pixart_sigma"
    PREDICTION_TYPE = "epsilon"
    MODEL_TYPE = "transformer"
    # PixArt ships the IDDPM linear schedule, not SD's scaled_linear
    DDPM_BETA_START = 0.0001
    DDPM_BETA_END = 0.02
    DDPM_BETA_SCHEDULE = "linear"
    LATENT_CHANNEL_COUNT = 4
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "1024-ms"
    HUGGINGFACE_PATHS = {
        "1024-ms": "PixArt-alpha/PixArt-Sigma-XL-2-1024-MS",
        "512-ms": "PixArt-alpha/PixArt-Sigma-XL-2-512-MS",
    }
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="t5-xxl", family="t5-xxl", subfolder="text_encoder", max_length=300),
    )
    DEFAULT_LORA_TARGET = ("attn_q", "attn_k", "attn_v", "attn_proj")
    VAE_SCALING_FACTOR = 0.13025  # SDXL VAE

    def __init__(self, config: Any, arch: Optional[PixartConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = PixartConfig.tiny()
        elif getattr(config, "model_flavour", None) == "512-ms":
            self.arch = PixartConfig.sigma_512()
        else:
            self.arch = PixartConfig.sigma_1024()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def create_module(self) -> PixartTransformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(PixartTransformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // 8
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.arch.in_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 32, self.arch.text_dim), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {
            "latents": prepared["noisy_latents"],
            "timesteps": prepared["timesteps"],
            "context": prepared["text_embeds"],
        }

    # ---- controlnet (PixArt-delta) ------------------------------------------------------------
    def controlnet_module(self):
        raise NotImplementedError("the PixArt ControlNet is not ported (ROADMAP Queue 1 item 7)")

    def init_controlnet_params(self, generator, batch):
        raise NotImplementedError("the PixArt ControlNet is not ported (ROADMAP Queue 1 item 7)")

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "control_latents" in prepared:
            raise NotImplementedError("the PixArt ControlNet is not ported (ROADMAP Queue 1 item 7)")
        return module(**self.get_model_inputs(prepared))

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"text_embeds": batch["text_embeds"]}

    # ---- host-side text encoding ------------------------------------------------------------
    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: the T5 last hidden state and its mask."""
        (t5,) = self.text_encoders
        out = t5.encode(prompts)
        return [
            {
                "text_embeds": np.asarray(out["last_hidden_state"][i], np.float32),
                "attention_mask": np.asarray(out["attention_mask"][i]),
            }
            for i in range(len(prompts))
        ]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}
