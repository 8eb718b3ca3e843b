"""SD 1.x / 2.x families.

Counterpart of ``simpletuner_tpu/models/sd1x/model.py``: ``SD1x`` (epsilon,
``UNetConfig.sd15()``) and ``SD2x`` (v-prediction, ``UNetConfig.sd21()``),
``tiny`` resolving to ``UNetConfig.tiny()`` for both, one CLIP text encoder
at 77 tokens (``text_encoder``: CLIP-L for 1.x, the OpenCLIP-H exported as a
``CLIPTextModel`` for 2.x, read from its own ``config.json``), scaling factor
0.18215, ``get_model_inputs``, ``inference_conditioning``, ``encode_text``
(the last hidden state, with the mask kept) and ``collate_text_embeds`` (the
mask dropped).  The UNet is the JAX preset's: ``attention_head_dim`` 64 is
the head *dim* (5 / 10 / 20 heads), where the published SD 1.5 UNet runs 8
heads at every level (ROADMAP Queue 3).  Validation renders through the DDPM
schedulers with true CFG when ``validation_guidance`` > 1.  Refused, naming
their ROADMAP Queue 1 items: GLIGEN grounding (``max_grounding_entities`` >
0, 7), the ControlNet branch (7) and text-encoder training (4i).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from ..unet import UNet2DCondition, UNetConfig


class SD1x(ModelFoundation):
    NAME = "sd1x"
    PREDICTION_TYPE = "epsilon"
    SUPPORTS_TEXT_ENCODER_TRAINING = True  # the JAX flags; the port refuses the training itself (4i)
    SUPPORTS_FULL_TEXT_ENCODER_TRAINING = True
    MODEL_TYPE = "unet"
    LATENT_CHANNEL_COUNT = 4
    DEFAULT_RESOLUTION = 512
    DEFAULT_FLAVOUR = "1.5"
    HUGGINGFACE_PATHS = {
        "1.5": "stable-diffusion-v1-5/stable-diffusion-v1-5",
        "1.4": "CompVis/stable-diffusion-v1-4",
        "dreamshaper": "Lykon/dreamshaper-8",
    }
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="clip-l", family="clip-l", subfolder="text_encoder", max_length=77),
    )
    DEFAULT_LORA_TARGET = ("to_q", "to_k", "to_v", "to_out")
    VAE_SCALING_FACTOR = 0.18215

    def __init__(self, config: Any, arch: Optional[UNetConfig] = None):
        super().__init__(config)
        if int(getattr(config, "max_grounding_entities", 0) or 0) > 0:
            raise NotImplementedError("GLIGEN grounding (max_grounding_entities > 0) is not ported "
                                      "(ROADMAP Queue 1 item 7)")
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = UNetConfig.tiny()
        else:
            self.arch = self.default_arch()

    def default_arch(self) -> UNetConfig:
        return UNetConfig.sd15()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def create_module(self) -> UNet2DCondition:
        """The UNet (``build_module``): remat of every resnet and spatial transformer."""
        return self.build_module(UNet2DCondition)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // 8
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.arch.in_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 77, self.arch.cross_attention_dim), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if "grounding_boxes" in prepared:
            raise NotImplementedError("GLIGEN grounding is not ported (ROADMAP Queue 1 item 7)")
        return {
            "sample": prepared["noisy_latents"],
            "timesteps": prepared["timesteps"],
            "encoder_hidden_states": prepared["text_embeds"],
        }

    # ---- controlnet ---------------------------------------------------------------------------
    def controlnet_module(self):
        raise NotImplementedError("the SD 1.x / 2.x ControlNet is not ported (ROADMAP Queue 1 item 7)")

    def init_controlnet_params(self, generator, batch):
        raise NotImplementedError("the SD 1.x / 2.x ControlNet is not ported (ROADMAP Queue 1 item 7)")

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "control_latents" in prepared:
            raise NotImplementedError("the SD 1.x / 2.x ControlNet is not ported (ROADMAP Queue 1 item 7)")
        return module(**self.get_model_inputs(prepared))

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"text_embeds": batch["text_embeds"]}

    # ---- host-side text encoding ------------------------------------------------------------
    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: the CLIP last hidden state and its mask."""
        (clip,) = self.text_encoders
        out = clip.encode(prompts)
        return [
            {
                "text_embeds": np.asarray(out["last_hidden_state"][i], np.float32),
                "attention_mask": np.asarray(out["attention_mask"][i]),
            }
            for i in range(len(prompts))
        ]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}

    # ---- in-step text-encoder training --------------------------------------------------------
    def tokenize_captions(self, captions):
        raise NotImplementedError(f"{self.NAME} text-encoder training is not ported (ROADMAP Queue 1 item 4i)")

    def apply_text_encoder(self, te_params, batch):
        raise NotImplementedError(f"{self.NAME} text-encoder training is not ported (ROADMAP Queue 1 item 4i)")


class SD2x(SD1x):
    NAME = "sd2x"
    PREDICTION_TYPE = "v_prediction"
    DEFAULT_FLAVOUR = "2.1"
    HUGGINGFACE_PATHS = {
        "2.1": "stabilityai/stable-diffusion-2-1",
        "2.0": "stabilityai/stable-diffusion-2",
    }

    def default_arch(self) -> UNetConfig:
        return UNetConfig.sd21()
