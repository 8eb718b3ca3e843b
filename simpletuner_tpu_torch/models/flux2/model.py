"""FLUX.2 family.

Counterpart of ``simpletuner_tpu/models/flux2/model.py``: the flow-matching
DiT of ``transformer.py`` in its ``dev`` (``Flux2Config()``, 32B: 8 double
and 48 single blocks, 6144 wide, guidance embedding), ``klein`` (24 heads,
5 + 20 blocks, no guidance) and ``tiny`` sizes, conditioned on Mistral-3 at
512 tokens from ``text_encoder`` (the decoder-LLM encoder of
``models/llm_encoder.py`` on the ``mistral3_24b`` preset).  The timestep is
sigma (scaled x1000 inside the DiT), the target the plain flow velocity,
and the guidance input ``flux_guidance_value`` when the arch embeds
guidance.  ``custom_text_encoder_intermediary_layers`` (a JSON list of
hidden-state indices, embeddings first, negative from the end) makes the
prompt embeds the named Mistral states side by side on the features.

Mirrored as the JAX family keeps them (ROADMAP Queue 3): without taps the
prompt embeds are Mistral's final-norm state (5,120 wide), which the
published ``txt_in`` (15,360, three taps) cannot take; ``LATENT_CHANNEL_COUNT``
is 32 while the trainer builds the 16-channel ``VAEConfig.flux()`` for every
family with 16 channels or more, so the published ``patch_in`` (128 packed
features) cannot take the latents its VAE makes; both fail in both
packages, and the tiny preset trains.  ``collate_text_embeds`` drops the
mask, so the padded Mistral tokens attend.  ``DEFAULT_LORA_TARGET`` names the
image attention, but no code reads it: without ``lora_target_modules``
every adapter-carrying linear is adapted.  The JAX
``model_predict_with_intermediates`` (the CREPA tap) is refused by name
(ROADMAP Queue 1 item 4h).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from .transformer import Flux2Config, Flux2Transformer


class Flux2(ModelFoundation):
    NAME = "flux2"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    LATENT_CHANNEL_COUNT = 32
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "dev"
    HUGGINGFACE_PATHS = {"dev": "black-forest-labs/FLUX.2-dev", "klein": "black-forest-labs/FLUX.2-klein"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="mistral-3", family="mistral-3", subfolder="text_encoder", max_length=512),
    )
    DEFAULT_LORA_TARGET = ("attn_q", "attn_k", "attn_v", "attn_proj")
    VAE_SCALING_FACTOR = 1.0  # the FLUX.2 VAE normalises its own latents
    VAE_SHIFT_FACTOR = 0.0

    def __init__(self, config: Any, arch: Optional[Flux2Config] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = Flux2Config.tiny()
        elif getattr(config, "model_flavour", None) == "klein":
            self.arch = Flux2Config.klein()
        else:
            self.arch = Flux2Config()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("flux2 is a flow-matching family")

    def create_module(self) -> Flux2Transformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(Flux2Transformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // 8
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.arch.in_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 16, self.arch.txt_in_features), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        inputs = {"latents": prepared["noisy_latents"], "timesteps": prepared["timesteps"],
                  "context": prepared["text_embeds"]}
        if self.arch.guidance_embed:
            value = float(getattr(self.config, "flux_guidance_value", 1.0) or 1.0)
            inputs["guidance"] = torch.full(prepared["timesteps"].shape, value, dtype=torch.float32,
                                            device=prepared["timesteps"].device)
        return inputs

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        return module(**self.get_model_inputs(prepared))

    def model_predict_with_intermediates(self, module: nn.Module, prepared: Dict[str, torch.Tensor]):
        raise NotImplementedError("the flux2 per-block intermediates tap (CREPA) is not ported "
                                  "(ROADMAP Queue 1 item 4h)")

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"text_embeds": batch["text_embeds"]}

    # ---- host-side text encoding ------------------------------------------------------------
    def _te_tap_layers(self) -> Optional[Tuple[int, ...]]:
        """``custom_text_encoder_intermediary_layers`` as a tuple of hidden-state
        indices (a JSON string or a list), or None when unset or empty."""
        raw = getattr(self.config, "custom_text_encoder_intermediary_layers", None)
        if raw is None:
            return None
        if isinstance(raw, str):
            try:
                raw = json.loads(raw)
            except json.JSONDecodeError:
                raise ValueError(f"custom_text_encoder_intermediary_layers is not valid JSON: {raw!r}")
        layers = tuple(int(i) for i in raw)
        return layers or None

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: the tapped Mistral states side by side (or
        the final-norm state without taps) and the mask."""
        (mistral,) = self.text_encoders
        layers = self._te_tap_layers()
        if layers is None:
            out = mistral.encode(prompts)
            embeds = np.asarray(out["last_hidden_state"], np.float32)
        else:
            out = mistral.encode_with_hidden_states(prompts)
            taps = out["hidden_states"]  # embeddings first, the transformers order
            index = [i if i >= 0 else len(taps) + i for i in layers]
            if any(i < 0 or i >= len(taps) for i in index):
                raise ValueError(f"custom_text_encoder_intermediary_layers {layers} out of range for a "
                                 f"{len(taps)}-state encoder")
            embeds = np.concatenate([np.asarray(taps[i], np.float32) for i in index], axis=-1)
        return [{"text_embeds": embeds[i], "attention_mask": np.asarray(out["attention_mask"][i])}
                for i in range(len(prompts))]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """The states; the mask is dropped, as the JAX family drops it."""
        return {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}
