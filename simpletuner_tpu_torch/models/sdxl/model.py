"""SDXL family.

Counterpart of ``simpletuner_tpu/models/sdxl/model.py``: the epsilon UNet
(``UNetConfig.sdxl()``, or ``tiny_xl`` under the tiny preset), CLIP-L and
CLIP-G at 77 tokens (``text_encoder``, ``text_encoder_2``), the micro-
conditioning time ids (the base's 6: original H/W, crop, target H/W; the
refiner's 5 ending in ``data_aesthetic_score``), ``get_model_inputs``,
``inference_conditioning``, ``encode_text`` (CLIP-L seq ++ CLIP-G seq on the
channels, CLIP-G pooled), ``collate_text_embeds`` and ``check_user_config``.
Validation renders through the DDPM schedulers (DDIM by default) with true
CFG when ``validation_guidance`` > 1.  Two JAX behaviours are kept for parity
(ROADMAP Queue 3): the preset puts attention in every level, and CLIP-G's
``penultimate`` output is not honoured (the encoders return the last hidden
state).  Refused, naming their ROADMAP Queue 1 items: staged base/refiner
validation (``sdxl_validation_pipeline_mode: full-pipeline``, 4d), in-step
text-encoder training (4i) and ControlNet (7).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from ..unet import UNet2DCondition, UNetConfig, make_sdxl_added_cond

class SDXL(ModelFoundation):
    STAGED_VALIDATION_PREFIX = "sdxl"
    NAME = "sdxl"
    PREDICTION_TYPE = "epsilon"
    MODEL_TYPE = "unet"
    LATENT_CHANNEL_COUNT = 4
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "base-1.0"
    HUGGINGFACE_PATHS = {
        "base-1.0": "stabilityai/stable-diffusion-xl-base-1.0",
        "refiner-1.0": "stabilityai/stable-diffusion-xl-refiner-1.0",
    }
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="clip-l", family="clip-l", subfolder="text_encoder", max_length=77),
        TextEncoderSpec(name="clip-g", family="clip-g", subfolder="text_encoder_2", max_length=77,
                        output="penultimate"),
    )
    DEFAULT_LORA_TARGET = ("to_q", "to_k", "to_v", "to_out")
    VAE_SCALING_FACTOR = 0.13025

    def __init__(self, config: Any, arch: Optional[UNetConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = UNetConfig.tiny_xl()
        else:
            self.arch = UNetConfig.sdxl()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    @property
    def _is_refiner(self) -> bool:
        return bool(self.flavour and "refiner" in str(self.flavour))

    @property
    def _num_time_ids(self) -> int:
        return 5 if self._is_refiner else 6

    @property
    def _pooled_dim(self) -> int:
        # addition_embed_dim = n_ids x fourier + pooled
        return self.arch.addition_embed_dim - self._num_time_ids * self.arch.addition_time_embed_dim

    def _aesthetic_score(self) -> float:
        return float(getattr(self.config, "data_aesthetic_score", 7.0) or 7.0)

    def _default_time_ids(self, size: float, batch_size: int, device=None) -> torch.Tensor:
        row = [size, size, 0.0, 0.0, self._aesthetic_score()] if self._is_refiner else \
            [size, size, 0.0, 0.0, size, size]
        return torch.tensor([row], dtype=torch.float32, device=device).repeat(batch_size, 1)

    def create_module(self) -> UNet2DCondition:
        """The UNet, with LoRA adapters on every ``LoRADense`` the targets
        allow (the attention projections and the GEGLU feed-forward carry a
        rank; f32 masters, B = 0 at init), remat of every resnet and spatial
        transformer, and the int8 product mode of a quantized base."""
        return self.build_module(UNet2DCondition)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // 8
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.arch.in_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 77, self.arch.cross_attention_dim), device=device),
            "pooled_embeds": torch.zeros((batch_size, self._pooled_dim), device=device),
            "time_ids": self._default_time_ids(float(resolution), batch_size, device),
        }

    def _time_ids(self, prepared: Dict[str, torch.Tensor], batch_size: int) -> torch.Tensor:
        if "time_ids" in prepared:
            return prepared["time_ids"]
        device = prepared["noisy_latents"].device
        # from the collate's size conditioning: original H W, crop, target H W
        # (the refiner: the target replaced by the aesthetic score)
        if all(k in prepared for k in ("original_sizes", "crop_coordinates", "target_sizes")):
            parts = [prepared["original_sizes"].float(), prepared["crop_coordinates"].float()]
            if self._is_refiner:
                parts.append(torch.full((batch_size, 1), self._aesthetic_score(), dtype=torch.float32,
                                        device=device))
            else:
                parts.append(prepared["target_sizes"].float())
            return torch.cat(parts, dim=-1)
        res = float(getattr(self.config, "resolution", 1024) or 1024)
        return self._default_time_ids(res, batch_size, device)

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch_size = prepared["noisy_latents"].shape[0]
        added = make_sdxl_added_cond(self._time_ids(prepared, batch_size), prepared["pooled_embeds"],
                                     self.arch.addition_time_embed_dim)
        return {
            "sample": prepared["noisy_latents"],
            "timesteps": prepared["timesteps"],
            "encoder_hidden_states": prepared["text_embeds"],
            "added_cond": added,
        }

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "control_latents" in prepared:
            raise NotImplementedError("UNet ControlNet is not ported (ROADMAP Queue 1 item 7)")
        return module(**self.get_model_inputs(prepared))

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        latents = batch["latents"]
        return {
            "text_embeds": batch["text_embeds"],
            "pooled_embeds": batch["pooled_embeds"],
            "time_ids": self._default_time_ids(float(latents.shape[1] * 8), latents.shape[0], latents.device),
        }

    # ---- host-side text encoding ------------------------------------------------------------
    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: ``text_embeds`` (CLIP-L and CLIP-G
        sequences side by side on the channels), ``pooled_embeds`` (CLIP-G
        pooled) and CLIP-L's ``attention_mask``."""
        clip_l, clip_g = self.text_encoders
        out_l, out_g = clip_l.encode(prompts), clip_g.encode(prompts)
        pooled_g = out_g.get("pooled", out_g["last_hidden_state"][:, 0])
        return [
            {
                "text_embeds": np.concatenate([np.asarray(out_l["last_hidden_state"][i], np.float32),
                                               np.asarray(out_g["last_hidden_state"][i], np.float32)], axis=-1),
                "pooled_embeds": np.asarray(pooled_g[i], np.float32),
                "attention_mask": np.asarray(out_l["attention_mask"][i]),
            }
            for i in range(len(prompts))
        ]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {
            "text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds]),
            "pooled_embeds": np.stack([np.asarray(e["pooled_embeds"]) for e in embeds]),
        }

    # ---- in-step text-encoder training (the two CLIPs) ------------------------------------------
    def tokenize_captions(self, captions):
        raise NotImplementedError("SDXL text-encoder training is not ported (ROADMAP Queue 1 item 4i)")

    def apply_text_encoder(self, te_params, batch):
        raise NotImplementedError("SDXL text-encoder training is not ported (ROADMAP Queue 1 item 4i)")

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) == "flow_matching":
            raise ValueError("sdxl is an epsilon/v-prediction family")
