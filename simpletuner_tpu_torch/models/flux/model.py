"""Flux family, the inference subset.

Counterpart of ``simpletuner_tpu/models/flux/model.py``: flavour -> guidance
embedding, latent channels, VAE factors, the conditioning for sampling, the
transformer inputs (with ``--flux_attention_masked_training`` segment ids) and
``model_predict``.  Training-side hooks (prepare_batch, LoRA targets,
ControlNet, Kontext, QK-clip, LoRA targeting) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation
from .transformer import (
    FluxConfig,
    FluxTransformer,
    make_img_ids,
    make_txt_ids,
    pack_latents,
    unpack_latents,
)

class Flux(ModelFoundation):
    NAME = "flux"
    PREDICTION_TYPE = "flow_matching"
    DEFAULT_FLAVOUR = "dev"
    VAE_SCALING_FACTOR = 0.3611
    VAE_SHIFT_FACTOR = 0.1159

    def __init__(self, config: Any, arch: Optional[FluxConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = FluxConfig.tiny()
        else:
            self.arch = FluxConfig(
                guidance_embed=self.flavour in (None, "dev", "krea", "kontext")
            )

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels // 4  # 2x2 packing

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if getattr(self.config, "mixed_precision", "bf16") == "bf16" else torch.float32

    def create_module(self) -> FluxTransformer:
        """The base transformer.  Adapters arrive with checkpoint loading,
        which is not ported: a fresh LoRA has B = 0 and renders exactly as the
        base, so the render path builds no adapter branches."""
        precision = getattr(self.config, "base_model_precision", None) or "no_change"
        if precision != "no_change":
            raise NotImplementedError(f"base_model_precision={precision!r}: quantized bases are not ported")
        return FluxTransformer(config=self.arch, dtype=self.dtype)

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        img = pack_latents(prepared["noisy_latents"])
        inputs = {
            "img": img,
            "img_ids": prepared["img_ids"],
            "txt": prepared["t5_embeds"],
            "txt_ids": prepared["txt_ids"],
            "timesteps": prepared["timesteps"],
            "vec": prepared.get("pooled_embeds"),
            "guidance": prepared.get("guidance"),
        }
        if getattr(self.config, "flux_attention_masked_training", False) and "t5_masks" in prepared:
            # padded T5 tokens get segment id -1 (pad): the flash kernel
            # excludes them as keys and as queries; text first, then image
            masks = prepared["t5_masks"]
            txt_seg = torch.where(masks.to(torch.int32) > 0, 0, -1).to(torch.int32)
            img_seg = torch.zeros((img.shape[0], img.shape[1]), dtype=torch.int32, device=img.device)
            inputs["segment_ids"] = torch.cat([txt_seg, img_seg], dim=1)
        return inputs

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        latents = batch["latents"]
        batch_size, height, width = latents.shape[0], latents.shape[1], latents.shape[2]
        device = latents.device
        cond = {
            "t5_embeds": batch["t5_embeds"],
            "pooled_embeds": batch["pooled_embeds"],
            "img_ids": make_img_ids(batch_size, height, width, device=device),
            "txt_ids": make_txt_ids(batch_size, batch["t5_embeds"].shape[1], device=device),
        }
        guidance = batch.get("guidance", getattr(self.config, "validation_guidance_real", None) or 3.5)
        cond["guidance"] = torch.as_tensor(guidance, dtype=torch.float32, device=device).expand(batch_size)
        if getattr(self.config, "flux_attention_masked_training", False) and "t5_masks" in batch:
            cond["t5_masks"] = batch["t5_masks"]
        return cond

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        tokens = module(**self.get_model_inputs(prepared))
        height, width = prepared["noisy_latents"].shape[1:3]
        return unpack_latents(tokens, height, width)

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        out = {
            "t5_embeds": np.stack([np.asarray(e["t5_embeds"]) for e in embeds]),
            "pooled_embeds": np.stack([np.asarray(e["pooled_embeds"]) for e in embeds]),
        }
        if all("attention_mask" in e for e in embeds):
            out["t5_masks"] = np.stack([np.asarray(e["attention_mask"]).reshape(-1) for e in embeds])
        return out
