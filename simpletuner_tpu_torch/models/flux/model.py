"""Flux family.

Counterpart of ``simpletuner_tpu/models/flux/model.py``: flavour -> guidance
embedding, latent channels, VAE factors, the ``flux_lora_target`` presets,
the module with its adapters, remat settings and int8 product mode,
``prepare_batch`` (ids and
guidance), the conditioning for sampling, the transformer inputs (with
``--flux_attention_masked_training`` segment ids) and ``model_predict``.
ControlNet, Kontext, TREAD, FlowMap and QK-clip are not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation
from ..layers import apply_lora_target, set_quantized_matmul
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
    SLIDER_LORA_TARGET = ("to_k", "to_q", "to_v", "to_out.0", "to_qkv")
    VAE_SCALING_FACTOR = 0.3611
    VAE_SHIFT_FACTOR = 0.1159

    # --flux_lora_target presets: diffusers module paths, matched through the
    # flux LoRA key map with PEFT suffix semantics.  Single-block q/k/v/proj_mlp
    # ride one fused linear1, so any matching split name adapts all of it.
    LORA_TARGET_PRESETS = {
        "all": [
            "to_k", "to_q", "to_v", "to_qkv", "add_qkv_proj",
            "add_k_proj", "add_q_proj", "add_v_proj", "to_out.0", "to_add_out",
        ],
        "context": [
            "add_k_proj", "add_q_proj", "add_v_proj", "add_qkv_proj", "to_add_out",
        ],
        "context+ffs": [
            "add_k_proj", "add_q_proj", "add_v_proj", "add_qkv_proj",
            "to_add_out", "ff_context.net.0.proj", "ff_context.net.2",
        ],
        "all+ffs": [
            "to_k", "to_q", "to_v", "to_qkv", "add_qkv_proj",
            "add_k_proj", "add_q_proj", "add_v_proj", "to_out.0", "to_add_out",
            "ff.net.0.proj", "ff.net.2", "ff_context.net.0.proj",
            "ff_context.net.2", "proj_mlp", "proj_out",
        ],
        "all+ffs+embedder": [
            "x_embedder",
            "to_k", "to_q", "to_v", "to_qkv", "add_qkv_proj",
            "add_k_proj", "add_q_proj", "add_v_proj", "to_out.0", "to_add_out",
            "ff.net.0.proj", "ff.net.2", "ff_context.net.0.proj",
            "ff_context.net.2", "proj_mlp", "proj_out",
        ],
        "ai-toolkit": [
            "to_q", "to_k", "to_qkv", "add_qkv_proj", "to_v",
            "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0", "to_add_out",
            "ff.net.0.proj", "ff.net.2", "ff_context.net.0.proj",
            "ff_context.net.2", "norm.linear", "norm1.linear",
            "norm1_context.linear", "proj_mlp", "proj_out",
        ],
        "tiny": ["single_transformer_blocks.7.proj_out",
                 "single_transformer_blocks.20.proj_out"],
        "nano": ["single_transformer_blocks.7.proj_out"],
    }

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

    def family_lora_targets(self):
        preset = getattr(self.config, "flux_lora_target", None) or "all"
        if preset == "controlnet":
            raise NotImplementedError(
                "flux_lora_target=controlnet (LoRA over ControlNet modules) is not supported; use "
                "model_type=controlnet for full ControlNet training"
            )
        if preset not in self.LORA_TARGET_PRESETS:
            raise ValueError(f"unknown flux_lora_target {preset!r}; available: {sorted(self.LORA_TARGET_PRESETS)}")
        return self.LORA_TARGET_PRESETS[preset]

    def create_module(self) -> FluxTransformer:
        """The transformer, with LoRA adapters on the targeted modules in
        ``model_type=lora`` (f32 masters, B = 0 at init), the remat settings
        and the int8 product mode of a quantized base.  The base itself is
        quantized by ``create_train_state(quantize_mode=model.base_precision)``,
        after the weights are initialised or loaded, as in the JAX trainer."""
        cfg = self.config
        rank = self.lora_rank
        module = FluxTransformer(
            config=self.arch,
            dtype=self.dtype,
            lora_rank=rank,
            lora_alpha=self.lora_alpha,
            lora_algo=self.lora_algo if rank else "lora",
            lora_mod_layers=rank > 0 and getattr(cfg, "flux_lora_target", None) == "ai-toolkit",
            remat=bool(getattr(cfg, "gradient_checkpointing", False)),
            remat_policy=getattr(cfg, "gradient_checkpointing_policy", None) or "full",
            remat_skip_last=int(getattr(cfg, "gradient_checkpointing_skip_last", 0) or 0),
            remat_interval=int(getattr(cfg, "gradient_checkpointing_interval", 0) or 1),
        )
        set_quantized_matmul(module, self.quantized_matmul)
        if rank:
            apply_lora_target(module, self._build_lora_target_predicate())
        return module

    def prepare_batch(self, generator: torch.Generator, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        prepared = super().prepare_batch(generator, batch)
        latents = batch["latents"]
        batch_size, height, width = latents.shape[0], latents.shape[1], latents.shape[2]
        device = latents.device
        prepared["img_ids"] = make_img_ids(batch_size, height, width, device=device)
        prepared["txt_ids"] = make_txt_ids(batch_size, batch["t5_embeds"].shape[1], device=device)
        mode = getattr(self.config, "flux_guidance_mode", "constant") or "constant"
        if mode == "random-range":
            low = getattr(self.config, "flux_guidance_min", 0.0) or 0.0
            high = getattr(self.config, "flux_guidance_max", 4.0) or 4.0
            draw = torch.rand((batch_size,), generator=generator, device=device)
            prepared["guidance"] = low + (high - low) * draw
        else:
            value = getattr(self.config, "flux_guidance_value", 1.0)
            prepared["guidance"] = torch.full(
                (batch_size,), 1.0 if value is None else float(value), dtype=torch.float32, device=device
            )
        return prepared

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
