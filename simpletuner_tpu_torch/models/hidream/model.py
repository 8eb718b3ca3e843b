"""HiDream-I1 family.

Counterpart of ``simpletuner_tpu/models/hidream/model.py``: the flow-matching
MoE MMDiT of ``transformer.py`` (``HiDreamConfig()``, the published 17B
size, or ``tiny`` under the tiny preset), conditioned on four encoders:
CLIP-L and CLIP-G pooled states (the unprojected ``pooler_output``,
concatenated to 2048) from ``text_encoder`` / ``text_encoder_2``, T5-XXL at
128 tokens from ``text_encoder_3`` and Llama-3.1-8B at 128 tokens from
``text_encoder_4`` (the decoder-LLM encoder on the ``llama3_8b`` preset),
over 16 latent channels with the Flux VAE.  The DiT's output is negated
(the reference trains the inverted velocity).  ``loss_fn`` collects every
MoE's load-balance term: their mean is ``moe_gate_loss`` in the aux dict at
every step, and joins the loss times its weight only under
``hidream_use_load_balancing_loss`` (``hidream_load_balancing_loss_weight``,
else ``moe_gate_loss_weight``, else 0.01).

Mirrored as the JAX family keeps them (ROADMAP Queue 3): the Llama encoder
returns no per-layer states, so ``encode_text`` stacks the final state
alone (one selected layer) and every block's caption projection reads it;
``LLAMA_SELECTED_LAYERS`` (8) reaches only ``example_batch``.  The Llama
spec names no tokenizer subfolder, so it reads ``tokenizer/``, and T5 reads
``tokenizer_2`` (CLIP-L's and CLIP-G's in a published dir).  The routed
experts carry no adapter; without ``lora_target_modules`` every
adapter-carrying linear is adapted (the caption projections, the shared
experts and ``ff_t`` included).  The JAX per-block hidden-state taps (CREPA)
are refused by name (ROADMAP Queue 1 item 4h).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from .transformer import HiDreamConfig, HiDreamTransformer


class HiDream(ModelFoundation):
    NAME = "hidream"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    LATENT_CHANNEL_COUNT = 16
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "i1-full"
    HUGGINGFACE_PATHS = {"i1-full": "HiDream-ai/HiDream-I1-Full", "i1-dev": "HiDream-ai/HiDream-I1-Dev"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="clip-l", family="clip-l", subfolder="text_encoder", max_length=77, output="pooled"),
        TextEncoderSpec(name="clip-g", family="clip-g", subfolder="text_encoder_2", max_length=77, output="pooled"),
        TextEncoderSpec(name="t5-xxl", family="t5-xxl", subfolder="text_encoder_3", max_length=128),
        TextEncoderSpec(name="llama", family="llama-3", subfolder="text_encoder_4", max_length=128,
                        output="hidden_states"),
    )
    DEFAULT_LORA_TARGET = ("attn_q", "attn_k", "attn_v", "attn_proj")
    VAE_SCALING_FACTOR = 0.3611
    VAE_SHIFT_FACTOR = 0.1159
    # the Llama layers a batch may carry (block i reads layer i % n)
    LLAMA_SELECTED_LAYERS = 8

    def __init__(self, config: Any, arch: Optional[HiDreamConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = HiDreamConfig.tiny()
        else:
            self.arch = HiDreamConfig()
        if getattr(config, "hidream_use_load_balancing_loss", False):
            weight = getattr(config, "hidream_load_balancing_loss_weight", None)
            if weight is None:
                weight = getattr(config, "moe_gate_loss_weight", 0.01) or 0.01
            self.moe_aux_weight = float(weight)
        else:
            self.moe_aux_weight = 0.0

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("hidream is a flow-matching family")

    def create_module(self) -> HiDreamTransformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(HiDreamTransformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // 8
        n_sel = 2 if getattr(self.config, "model_arch_preset", None) == "tiny" else self.LLAMA_SELECTED_LAYERS
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.arch.in_channels), device=device),
            "t5_embeds": torch.zeros((batch_size, 16, self.arch.t5_dim), device=device),
            "llama_embeds": torch.zeros((batch_size, n_sel, 16, self.arch.llama_dim), device=device),
            "pooled_embeds": torch.zeros((batch_size, self.arch.pooled_dim), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {
            "latents": prepared["noisy_latents"],
            "timesteps": prepared["timesteps"],
            "t5_embeds": prepared["t5_embeds"],
            "llama_embeds": prepared["llama_embeds"],
            "pooled": prepared["pooled_embeds"],
        }

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        # the reference trains the inverted velocity
        return -module(**self.get_model_inputs(prepared))

    def model_predict_with_intermediates(self, module: nn.Module, prepared: Dict[str, torch.Tensor]):
        raise NotImplementedError("the hidream per-block hidden-state taps (CREPA) are not ported "
                                  "(ROADMAP Queue 1 item 4h)")

    def loss_fn(self, module: nn.Module, generator: torch.Generator, batch: Dict[str, torch.Tensor]):
        """The base loss plus, under ``hidream_use_load_balancing_loss``, the
        weighted mean of the MoE load-balance terms; ``moe_gate_loss`` (that
        mean) is in the aux dict either way."""
        prepared = self.prepare_batch(generator, batch)
        if self.lora_rank > 0 and "is_regularisation_data" in prepared:
            raise NotImplementedError("prior preservation (regularisation data) is not ported")
        pred, aux_terms = module(**self.get_model_inputs(prepared), with_aux=True)
        loss = self.compute_loss(-pred, prepared)
        aux: Dict[str, torch.Tensor] = {"timesteps": prepared["timesteps"]}
        if aux_terms:
            gate_loss = torch.stack(aux_terms).mean()
            if self.moe_aux_weight > 0.0:
                loss = loss + self.moe_aux_weight * gate_loss
            aux["moe_gate_loss"] = gate_loss
        return loss, aux

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"t5_embeds": batch["t5_embeds"], "llama_embeds": batch["llama_embeds"],
                "pooled_embeds": batch["pooled_embeds"]}

    # ---- host-side text encoding ------------------------------------------------------------
    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: T5's states and mask, the selected Llama
        states (L_sel, S, D) and the concatenated CLIP-L / CLIP-G pooled states."""
        clip_l, clip_g, t5, llama = self.text_encoders
        out_l, out_g, out_t5, out_ll = (enc.encode(prompts) for enc in (clip_l, clip_g, t5, llama))
        pooled = np.concatenate([np.asarray(out.get("pooled", out["last_hidden_state"][:, 0]), np.float32)
                                 for out in (out_l, out_g)], axis=-1)
        hidden = out_ll.get("hidden_states")
        if hidden is None:  # the encoder's final state alone
            hidden = np.asarray(out_ll["last_hidden_state"])[None]
        hidden = np.asarray(hidden, np.float32)
        n_layers = hidden.shape[0]
        sel = np.linspace(0, n_layers - 1, min(self.LLAMA_SELECTED_LAYERS, n_layers)).round().astype(int)
        llama_stack = hidden[sel]  # (n_sel, B, S, D)
        return [
            {
                "t5_embeds": np.asarray(out_t5["last_hidden_state"][i], np.float32),
                "llama_embeds": np.ascontiguousarray(llama_stack[:, i]),
                "pooled_embeds": pooled[i],
                "attention_mask": np.asarray(out_t5["attention_mask"][i]),
            }
            for i in range(len(prompts))
        ]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """T5 and Llama states and the pooled vectors; the mask is dropped."""
        return {key: np.stack([np.asarray(e[key]) for e in embeds])
                for key in ("t5_embeds", "llama_embeds", "pooled_embeds")}
