"""Wan video family.

Counterpart of ``simpletuner_tpu/models/wan/model.py``: the flow-matching
video DiT of ``transformer.py`` (``WanConfig.b14()`` for a flavour with
"14b" in its name, else ``b1_3()``; ``tiny`` under the tiny preset), umT5-XXL
at 512 tokens read through the ``t5-xxl`` family from ``text_encoder``
(its tokenizer from ``tokenizer_2``, as the JAX T5 spec reads it), 16 latent
channels of the causal video VAE (``video_vae_config``: ``VideoVAEConfig.wan()``,
``tiny`` under the tiny preset) unscaled, ``get_model_inputs`` (an I2V
flavour takes the noisy latents, the clean first latent frame broadcast
over time and a 4-channel frame-0 mask: 36 channels in, 16 out),
``inference_conditioning``, ``encode_text`` (the whole last hidden state,
pad positions included, and the mask) and ``collate_text_embeds``, which
drops the mask as the JAX family does: the cross-attention runs unmasked.
``check_user_config`` applies the Wan 2.2 expert flavours' stage defaults
(flow shift, validation steps and guidance) unless the user set them.  The
two-expert validation (``wan_validation_load_other_stage``) needs the staged
render, which is refused by name (ROADMAP Queue 1 item 4d).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from ..video_vae import VideoVAEConfig
from .transformer import WanConfig, WanTransformer


class Wan(ModelFoundation):
    NAME = "wan"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    MODALITY = "video"
    LATENT_CHANNEL_COUNT = 16
    DEFAULT_RESOLUTION = 480
    DEFAULT_FLAVOUR = "t2v-1.3b"
    HUGGINGFACE_PATHS = {
        "t2v-1.3b": "Wan-AI/Wan2.1-T2V-1.3B-Diffusers",
        "t2v-14b": "Wan-AI/Wan2.1-T2V-14B-Diffusers",
        "i2v-14b-480p": "Wan-AI/Wan2.1-I2V-14B-480P-Diffusers",
        "i2v-14b-2.2-high": "Wan-AI/Wan2.2-I2V-A14B-Diffusers",
        "i2v-14b-2.2-low": "Wan-AI/Wan2.2-I2V-A14B-Diffusers",
        "flf2v-14b-2.2-high": "Wan-AI/Wan2.2-FLF2V-A14B-Diffusers",
        "flf2v-14b-2.2-low": "Wan-AI/Wan2.2-FLF2V-A14B-Diffusers",
        "ti2v-5b-2.2": "Wan-AI/Wan2.2-TI2V-5B-Diffusers",
        "animegen-t2v-high": "Wan-AI/Wan2.2-T2V-A14B-Diffusers",
        "animegen-t2v-low": "Wan-AI/Wan2.2-T2V-A14B-Diffusers",
    }
    # the Wan 2.2 expert flavours: each trains one denoising expert; the
    # high-noise expert denoises sigma in [boundary_ratio, 1]
    WAN_STAGE_OVERRIDES = {
        **{flavour: {"trained_stage": stage, "stage_subfolder": "transformer_2" if stage == "high" else "transformer",
                     "other_stage_subfolder": "transformer" if stage == "high" else "transformer_2",
                     "flow_shift": 5.0, "sample_steps": 40, "boundary_ratio": 0.90,
                     "guidance": {"high": 3.5, "low": 3.5}}
           for flavour, stage in (("i2v-14b-2.2-high", "high"), ("i2v-14b-2.2-low", "low"),
                                  ("flf2v-14b-2.2-high", "high"), ("flf2v-14b-2.2-low", "low"))},
        **{flavour: {"trained_stage": stage, "stage_subfolder": "transformer_2" if stage == "high" else "transformer",
                     "other_stage_subfolder": "transformer" if stage == "high" else "transformer_2",
                     "flow_shift": 5.0, "sample_steps": 40, "boundary_ratio": 0.875,
                     "guidance": {"high": 1.0, "low": 1.0}}
           for flavour, stage in (("animegen-t2v-high", "high"), ("animegen-t2v-low", "low"))},
    }
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="umt5-xxl", family="t5-xxl", subfolder="text_encoder", max_length=512),
    )
    DEFAULT_LORA_TARGET = ("attn_q", "attn_k", "attn_v", "attn_proj", "ffn_in", "ffn_out")
    VAE_SCALING_FACTOR = 1.0

    def __init__(self, config: Any, arch: Optional[WanConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = WanConfig.tiny()
        elif self.flavour and "14b" in self.flavour:
            self.arch = WanConfig.b14()
        else:
            self.arch = WanConfig.b1_3()
        if self.is_i2v and arch is None:
            # noisy latents ++ first-frame condition ++ 4-channel mask in; the
            # head stays at the base latent width (diffusers Wan I2V: 36 in, 16 out)
            self.arch = dataclasses.replace(self.arch, in_channels=self.arch.in_channels * 2 + 4,
                                            out_channels=self.arch.out_channels or self.arch.in_channels)

    @property
    def is_i2v(self) -> bool:
        return bool(self.flavour and "i2v" in self.flavour)

    @property
    def latent_channels(self) -> int:
        if self.is_i2v:
            return (self.arch.in_channels - 4) // 2
        return self.arch.in_channels

    def video_vae_config(self) -> VideoVAEConfig:
        if getattr(self.config, "model_arch_preset", None) == "tiny":
            return VideoVAEConfig.tiny()
        return VideoVAEConfig.wan()

    def create_module(self) -> WanTransformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(WanTransformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // self.video_vae_config().spatial_factor
        frames = 3  # latent frames (1 + 4k decoded)
        return {
            "latents": torch.zeros((batch_size, frames, latent, latent, self.latent_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 64, self.arch.text_dim), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        noisy = prepared["noisy_latents"]
        if self.is_i2v:
            # first-frame conditioning: the clean frame 0 over time and a frame-0 mask
            clean = prepared.get("latents")
            clean = torch.zeros_like(noisy) if clean is None else clean
            first = clean[:, :1].expand(clean.shape).to(noisy.dtype)
            mask = torch.zeros(noisy.shape[:-1] + (4,), dtype=noisy.dtype, device=noisy.device)
            mask[:, 0] = 1.0
            noisy = torch.cat([noisy, first, mask], dim=-1)
        return {"latents": noisy, "timesteps": prepared["timesteps"], "context": prepared["text_embeds"]}

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        return module(**self.get_model_inputs(prepared))

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"text_embeds": batch["text_embeds"]}

    # ---- host-side text encoding ------------------------------------------------------------
    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: the umT5 last hidden state (pad positions
        kept) and its mask."""
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

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("wan is a flow-matching family")
        stage = self._wan_stage_info()
        if stage is not None:
            # the expert flavours pin the 2.2 flow shift and sampling defaults
            # unless the user set their own
            was = getattr(self.config, "was_provided", lambda _k: False)
            if not was("flow_schedule_shift"):
                self.config.flow_schedule_shift = stage["flow_shift"]
            if not was("validation_num_inference_steps"):
                self.config.validation_num_inference_steps = stage["sample_steps"]
            if not was("validation_guidance"):
                self.config.validation_guidance = stage["guidance"][stage["trained_stage"]]

    # ---- Wan 2.2 two-expert validation -------------------------------------------------------
    def _wan_stage_info(self) -> Optional[Dict[str, Any]]:
        return self.WAN_STAGE_OVERRIDES.get(str(getattr(self.config, "model_flavour", "") or ""))

    def supports_multistage_validation(self) -> bool:
        """True for an expert flavour with ``wan_validation_load_other_stage``
        (which ``Validation`` refuses, ROADMAP Queue 1 item 4d)."""
        return self._wan_stage_info() is not None and bool(
            getattr(self.config, "wan_validation_load_other_stage", False))

    def validation_stage_plan(self, module: nn.Module):
        if not self.supports_multistage_validation():
            return None
        raise NotImplementedError("the Wan 2.2 two-expert validation render (wan_validation_load_other_stage) is "
                                  "not ported (ROADMAP Queue 1 item 4d)")
