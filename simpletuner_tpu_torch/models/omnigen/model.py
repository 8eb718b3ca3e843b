"""OmniGen family.

Counterpart of ``simpletuner_tpu/models/omnigen/model.py``: the Phi-3 DiT of
``transformer.py`` (``OmniGenConfig()``, 3072 wide, 32 layers, or ``tiny``
under the tiny preset) on 4-channel latents.  There is no text encoder
(``TEXT_ENCODER_CONFIGURATION`` is empty): the prompt is tokenised by the
Phi-3 tokenizer at 120 tokens (``tokenizer/`` of the model dir through
``transformers.AutoTokenizer``; the tiny preset hashes words into its tiny
vocabulary with the salted ``hash``, as the JAX family does) and the
text-embed cache holds the int32 ids and a float mask.  Flow matching with
the plain sigmoid(normal) sigmas (no shift); the model takes the
cleanliness t = 1 - sigma and predicts latents - noise, so its output is
negated.  The trainer builds the SD ``VAEConfig()`` (scaling 0.18215 in the
cache) while validation divides by the family's ``VAE_SCALING_FACTOR``
0.13025, as the JAX package does (the PixArt and AuraFlow quirk, ROADMAP
Queue 3).  ``DEFAULT_LORA_TARGET`` is read by no code, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation
from .transformer import OmniGenConfig, OmniGenTransformer

OMNIGEN_TEXT_LENGTH = 120


class OmniGen(ModelFoundation):
    NAME = "omnigen"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    MODALITY = "image"
    LATENT_CHANNEL_COUNT = 4  # SDXL-style AutoencoderKL
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "v1"
    HUGGINGFACE_PATHS = {"v1": "Shitao/OmniGen-v1-diffusers"}
    TEXT_ENCODER_CONFIGURATION = ()  # tokens feed the model's own embedding table
    DEFAULT_LORA_TARGET = ("to_q", "to_k", "to_v", "to_out", "gate_up_proj", "down_proj")
    VAE_SCALING_FACTOR = 0.13025

    def __init__(self, config: Any, arch: Optional[OmniGenConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = OmniGenConfig.tiny()
        else:
            self.arch = OmniGenConfig()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def create_module(self) -> OmniGenTransformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(OmniGenTransformer)

    def flow_schedule_config(self):
        # plain sigmoid(normal) sigmas, no schedule shift
        return dataclasses.replace(super().flow_schedule_config(), schedule_shift=None, auto_shift=False,
                                   use_uniform_schedule=False, use_beta_schedule=False)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // 8
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.arch.in_channels), device=device),
            "input_ids": torch.zeros((batch_size, 16), dtype=torch.int32, device=device),
            "text_attention_mask": torch.ones((batch_size, 16), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {
            "latents": prepared["noisy_latents"],
            "timesteps": 1.0 - prepared["timesteps"],  # the cleanliness t = 1 - sigma
            "input_ids": prepared["input_ids"],
            "text_mask": prepared.get("text_attention_mask"),
        }

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        # the model predicts latents - noise; the flow target is noise - latents
        return -module(**self.get_model_inputs(prepared))

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Everything but the latents (the JAX default): the ids and the mask."""
        return {k: v for k, v in batch.items() if k != "latents"}

    # ---- host-side text handling ---------------------------------------------------------
    def _tiny_tokenizer(self):
        vocab = int(self.arch.vocab_size)

        def tok(prompts, padding=None, truncation=True, max_length=OMNIGEN_TEXT_LENGTH):
            ids = np.zeros((len(prompts), max_length), np.int32)
            mask = np.zeros((len(prompts), max_length), np.int32)
            for row, prompt in enumerate(prompts):
                words = str(prompt).split()[: max_length - 1]
                for col, word in enumerate(words):
                    ids[row, col] = (hash(word) % max(vocab - 4, 1)) + 3
                    mask[row, col] = 1
                ids[row, len(words)] = 2  # eos
                mask[row, len(words)] = 1
            return {"input_ids": ids, "attention_mask": mask}

        return tok

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """The Phi-3 token ids (int32) and the mask (f32) of each prompt at 120 tokens."""
        tok = getattr(self, "_tokenizer", None)
        if tok is None:
            if getattr(self.config, "model_arch_preset", None) == "tiny":
                tok = self._tiny_tokenizer()
            else:
                from transformers import AutoTokenizer  # only with a pretrained tokenizer

                tok = AutoTokenizer.from_pretrained(
                    getattr(self.config, "pretrained_model_name_or_path", None)
                    or self.HUGGINGFACE_PATHS[self.flavour or "v1"],
                    subfolder="tokenizer",
                )
            self._tokenizer = tok
        out = tok(list(prompts), padding="max_length", truncation=True, max_length=OMNIGEN_TEXT_LENGTH)
        return [
            {
                "input_ids": np.asarray(out["input_ids"][i], np.int32),
                "text_attention_mask": np.asarray(out["attention_mask"][i], np.float32),
            }
            for i in range(len(prompts))
        ]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {
            "input_ids": np.stack([np.asarray(e["input_ids"]) for e in embeds]),
            "text_attention_mask": np.stack([np.asarray(e["text_attention_mask"]) for e in embeds]),
        }

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("omnigen is a flow-matching family")
