"""Anima family.

Counterpart of ``simpletuner_tpu/models/anima/model.py``: the adapter and
Cosmos core of ``transformer.py`` (``AnimaConfig()``, or ``tiny`` under the
tiny preset) on 16-channel latents as one-frame clips, a flow-matching
family whose timestep is the sigma itself.  ``encode_text`` stores
Qwen3-0.6B's final hidden state (the ``qwen2.5`` spec, read in the qwen2
layout, at 256 tokens from ``text_encoder``) and the caption's T5 ids, capped
at min(``adapter_pad_length``, 64) tokens and zero-padded.  The T5 ids come
from the tokenizer in the model dir's ``tokenizer/`` (the folder the Qwen
encoder reads too, so with a Qwen tokenizer there the ids are Qwen ids), or,
without one, from the salted ``hash`` of each word, so they differ between
processes.  The collate drops the Qwen mask.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from .transformer import AnimaConfig, AnimaTransformer


class Anima(ModelFoundation):
    NAME = "anima"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    LATENT_CHANNEL_COUNT = 16
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "release"
    HUGGINGFACE_PATHS = {"release": "circulus/anima"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="qwen3", family="qwen2.5", subfolder="text_encoder", max_length=256),
    )
    DEFAULT_LORA_TARGET = ("attn1_q", "attn1_k", "attn1_v", "attn1_out",
                           "attn2_q", "attn2_k", "attn2_v", "attn2_out")

    def __init__(self, config: Any, arch: Optional[AnimaConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = AnimaConfig.tiny()
        else:
            self.arch = AnimaConfig()
        self._t5_tokenizer = None

    @property
    def latent_channels(self) -> int:
        return self.arch.core.in_channels

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("anima is a flow-matching family")

    def create_module(self) -> AnimaTransformer:
        """The adapter and core (``build_module``): remat of every core block."""
        return self.build_module(AnimaTransformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = max(resolution // 8, 8)
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.latent_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 6, self.arch.adapter_dim), device=device),
            "t5_ids": torch.ones((batch_size, 8), dtype=torch.int32, device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        inputs = {
            "latents": prepared["noisy_latents"][:, None],  # a one-frame clip for the video core
            "timesteps": prepared["timesteps"].to(torch.float32),
            "text_embeds": prepared["text_embeds"],
            "t5_ids": prepared["t5_ids"].to(torch.int32),
        }
        if "t5_weights" in prepared:
            inputs["t5_weights"] = prepared["t5_weights"]
        return inputs

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        return module(**self.get_model_inputs(prepared))[:, 0]

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"text_embeds": batch["text_embeds"], "t5_ids": batch["t5_ids"]}

    def _resolve_t5_tokenizer(self):
        """The tokenizer in ``tokenizer/`` of a local model dir, else None (the hash ids)."""
        if self._t5_tokenizer is not None:
            return self._t5_tokenizer
        path = getattr(self.config, "pretrained_model_name_or_path", None)
        if path and str(path).startswith("/"):
            try:
                from transformers import AutoTokenizer  # only with a local model dir

                self._t5_tokenizer = AutoTokenizer.from_pretrained(str(path), subfolder="tokenizer")
            except Exception:  # any failure falls back to the hash ids, as in the JAX family
                self._t5_tokenizer = None
        return self._t5_tokenizer

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        (qwen,) = self.text_encoders
        out = qwen.encode(prompts)
        tokenizer = self._resolve_t5_tokenizer()
        max_len = min(self.arch.adapter_pad_length, 64)
        rows = []
        for i, prompt in enumerate(prompts):
            if tokenizer is not None:
                ids = tokenizer(prompt, truncation=True, max_length=max_len)["input_ids"]
            else:
                ids = [1 + (hash(word) % (self.arch.adapter_vocab_size - 2)) for word in str(prompt).split()][:max_len]
            ids = list(ids) + [0] * (max_len - len(ids))
            rows.append({
                "text_embeds": np.asarray(out["last_hidden_state"][i], np.float32),
                "t5_ids": np.asarray(ids, np.int32),
                "attention_mask": np.asarray(out["attention_mask"][i]),
            })
        return rows

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {
            "text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds]),
            "t5_ids": np.stack([np.asarray(e["t5_ids"]) for e in embeds]),
        }
