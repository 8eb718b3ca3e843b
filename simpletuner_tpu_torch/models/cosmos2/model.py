"""Cosmos-Predict2 text-to-image family: EDM x0 prediction.

Counterpart of ``simpletuner_tpu/models/cosmos2/model.py`` (``Cosmos2Image``)
on the shared Cosmos core (``models/cosmos1/transformer.py``; the 2B preset,
the 14B one under ``model_flavour: 14b``, or ``tiny``), conditioned on T5
(the ``t5-xxl`` spec named ``t5-11b``, 512 tokens from ``text_encoder``, its
tokenizer from ``tokenizer_2`` as the spec reads it), the states past the
mask zeroed in ``encode_text`` and the mask dropped in the collate.

The training math is EDM's, not the flow path of the base class:

* sigma is drawn log-normal, u ~ U(eps, 1 - eps) -> exp(sqrt(2) erfinv(2u - 1)),
  clamped to [0.002, 80], on the device from the step's own generator (the
  noise first, then u), so a captured step draws anew at each replay;
* the noise is additive, x_t = x0 + sigma eps, and the target is x0;
* ``model_predict`` preconditions: the core takes x_t / (sigma + 1) as a
  one-frame clip at timestep sigma / (sigma + 1), and the x0 estimate is
  x_t / (sigma + 1) - sigma / (sigma + 1) r;
* the loss is the x0 MSE weighted by (sigma^2 + 1) / sigma^2 (2.5e5 at
  sigma_min, so it stays in f32).

A batch may carry ``override_noise`` and ``override_sigmas``.  Validation
samples with the EDM Euler ladder (``schedulers/edm_euler.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from ..cosmos1.transformer import Cosmos1Config, Cosmos1Transformer

_F32_EPS = float(np.finfo(np.float32).eps)


class Cosmos2Image(ModelFoundation):
    NAME = "cosmos"
    PREDICTION_TYPE = "sample"
    MODEL_TYPE = "transformer"
    LATENT_CHANNEL_COUNT = 16
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "2b"
    HUGGINGFACE_PATHS = {
        "2b": "nvidia/Cosmos-Predict2-2B-Text2Image",
        "14b": "nvidia/Cosmos-Predict2-14B-Text2Image",
    }
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="t5-11b", family="t5-xxl", subfolder="text_encoder", max_length=512),
    )
    DEFAULT_LORA_TARGET = ("to_q", "to_k", "to_v", "to_out")

    # the EDM constants
    sigma_min = 0.002
    sigma_max = 80.0
    sigma_data = 1.0
    sigma_schedule_order = 7.0

    def __init__(self, config: Any, arch: Optional[Cosmos1Config] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = Cosmos1Config.tiny()
        elif getattr(config, "model_flavour", None) == "14b":
            self.arch = Cosmos1Config.predict2_14b()
        else:
            self.arch = Cosmos1Config.predict2_2b()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "sample"):
            raise ValueError("cosmos is an EDM sample-prediction family")
        if getattr(self.config, "aspect_bucket_alignment", 16) != 16:
            self.config.aspect_bucket_alignment = 16

    def create_module(self) -> Cosmos1Transformer:
        """The Cosmos core (``build_module``): remat of every block."""
        return self.build_module(Cosmos1Transformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = max(resolution // 8, 8)
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.arch.in_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 12, self.arch.text_embed_dim), device=device),
        }

    # ---- EDM training math ------------------------------------------------------------------

    def prepare_batch(self, generator: torch.Generator, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Log-normal sigmas and additive noise; the target is x0."""
        self.check_training_config()
        prepared = dict(batch)
        latents = prepared["latents"].to(torch.float32)
        override_noise = prepared.pop("override_noise", None)
        override_sigmas = prepared.pop("override_sigmas", None)
        prepared.pop("override_timesteps", None)
        noise = torch.randn(latents.shape, generator=generator, device=latents.device, dtype=torch.float32)
        if override_noise is not None:
            noise = override_noise.to(torch.float32)
        batch_size = latents.shape[0]
        if override_sigmas is not None:
            sigmas = override_sigmas.to(torch.float32)
        else:
            u = torch.rand((batch_size,), generator=generator, device=latents.device, dtype=torch.float32)
            u = u * (1.0 - 2.0 * _F32_EPS) + _F32_EPS
            log_sigma = math.sqrt(2.0) * torch.special.erfinv(2.0 * u - 1.0)
            sigmas = torch.exp(log_sigma).clamp(self.sigma_min, self.sigma_max)
        prepared["sigmas"] = sigmas
        prepared["timesteps"] = sigmas
        expand = sigmas.reshape((batch_size,) + (1,) * (latents.dim() - 1))
        prepared["noisy_latents"] = latents + expand * noise
        prepared["noise"] = noise
        prepared["target"] = latents
        return prepared

    def _sigmas(self, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        return prepared.get("sigmas", prepared["timesteps"]).to(torch.float32)

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        xt = prepared["noisy_latents"]
        sigmas = self._sigmas(prepared)
        expand = sigmas.reshape((xt.shape[0],) + (1,) * (xt.dim() - 1))
        latent_in = xt.to(torch.float32) / (expand + 1.0)  # c_in = 1 / (sigma + 1)
        if latent_in.dim() == 4:  # a one-frame clip
            latent_in = latent_in[:, None]
        return {
            "latents": latent_in,
            "timesteps": sigmas / (sigmas + 1.0),
            "context": prepared["text_embeds"],
            "padding_mask_value": 0.0,
        }

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        xt = prepared["noisy_latents"].to(torch.float32)
        expand = self._sigmas(prepared).reshape((xt.shape[0],) + (1,) * (xt.dim() - 1))
        r_pred = module(**self.get_model_inputs(prepared))
        if xt.dim() == 4:
            r_pred = r_pred[:, 0]
        inv = 1.0 / (expand + 1.0)
        # x0 = c_skip x_t + c_out r
        return inv * xt - expand * inv * r_pred.to(torch.float32)

    def compute_loss(self, model_pred: torch.Tensor, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The EDM-weighted x0 MSE, in f32."""
        x0 = prepared["target"].to(torch.float32)
        sigmas = prepared["sigmas"].to(torch.float32)
        shape = (x0.shape[0],) + (1,) * (x0.dim() - 1)
        weight = (sigmas ** 2 + self.sigma_data ** 2) / (sigmas * self.sigma_data) ** 2
        loss = (model_pred.to(torch.float32) - x0).square() * weight.reshape(shape)
        mask = prepared.get("loss_mask")
        if mask is not None:
            loss = loss * mask.to(torch.float32)
        loss_weight = prepared.get("loss_weight")
        if loss_weight is not None:
            loss = loss * loss_weight.reshape(shape)
        return loss.mean()

    # ---- inference and text -------------------------------------------------------------------

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"text_embeds": batch["text_embeds"]}

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: T5's states, zero past the mask, and the mask."""
        (t5,) = self.text_encoders
        out = t5.encode(prompts)
        results = []
        for i in range(len(prompts)):
            mask = np.asarray(out["attention_mask"][i])
            embeds = np.asarray(out["last_hidden_state"][i], np.float32) * mask[:, None].astype(np.float32)
            results.append({"text_embeds": embeds, "attention_mask": mask})
        return results

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}
