"""Krea-2 family.

Counterpart of ``simpletuner_tpu/models/krea2/model.py``: the 12.8B GQA DiT
of ``transformer.py`` (``Krea2Config()``, 6144 wide, 28 blocks, or ``tiny``
under the tiny preset) on Flux-packed 16-channel latents, conditioned on
twelve tapped hidden states of Qwen3-VL-4B's text trunk (the ``qwen2.5-vl``
spec, read in the qwen2 layout, at 512 tokens from ``text_encoder``): layers
(2, 5, ..., 35) of the embeddings-first taps, or, on a trunk with fewer
states, twelve taps spread evenly over what it has.  Text position ids are
zero and image ids the Flux latent grid; with ``krea2_reference_latents``
the clean ``control_latents`` of the batch ride after the target tokens on
a second copy of the grid, and the prediction is sliced back to the target.
The caption mask rides as ``text_attention_mask``; a render payload keeps
it as ``attention_mask``, which ``inference_conditioning`` does not read, so
renders are unmasked in both packages.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from ..flux.transformer import make_img_ids, pack_latents, unpack_latents
from .transformer import Krea2Config, Krea2Transformer

# indices into Qwen3-VL-4B's embeddings-first hidden states
KREA2_SELECT_LAYERS = (2, 5, 8, 11, 14, 17, 20, 23, 26, 29, 32, 35)


class Krea2(ModelFoundation):
    NAME = "krea2"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    LATENT_CHANNEL_COUNT = 16
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "base"
    HUGGINGFACE_PATHS = {"base": "krea/krea-2", "turbo": "krea/krea-2-turbo"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="qwen3-vl", family="qwen2.5-vl", subfolder="text_encoder", max_length=512),
    )
    DEFAULT_LORA_TARGET = ("to_q", "to_k", "to_v", "to_gate", "to_out")

    def __init__(self, config: Any, arch: Optional[Krea2Config] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = Krea2Config.tiny()
        else:
            self.arch = Krea2Config()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels // 4  # 2x2 packing

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("krea2 is a flow-matching family")

    def create_module(self) -> Krea2Transformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(Krea2Transformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = max(resolution // 8, 8)
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.arch.in_channels // 4), device=device),
            "text_embeds": torch.zeros((batch_size, 8, self.arch.num_text_layers, self.arch.text_hidden_dim),
                                       device=device),
        }

    def _uses_reference_latents(self) -> bool:
        return bool(getattr(self.config, "krea2_reference_latents", False))

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        noisy = prepared["noisy_latents"]  # (B, H, W, C)
        batch, height, width, _ = noisy.shape
        device = noisy.device
        txt_len = prepared["text_embeds"].shape[1]
        img_ids = make_img_ids(1, height, width, device=device)[0]  # (S_img, 3)
        hidden = pack_latents(noisy)
        position_ids = torch.cat([torch.zeros((txt_len, 3), dtype=torch.int32, device=device), img_ids], dim=0)
        if self._uses_reference_latents():
            ref = prepared.get("control_latents")
            if ref is None:
                raise ValueError(
                    "Krea 2 reference-latent training requires conditioning_latents "
                    "in the batch — link a conditioning dataset via conditioning_data."
                )
            if ref.dim() == 5:
                if ref.shape[1] != 1:
                    raise ValueError(f"Krea 2 reference latents must have a single frame, got {tuple(ref.shape)}.")
                ref = ref[:, 0]
            if ref.shape != noisy.shape:
                raise ValueError(
                    "Krea 2 reference latents must match target latent shape. "
                    f"Got reference {tuple(ref.shape)} vs target {tuple(noisy.shape)}."
                )
            hidden = torch.cat([hidden, pack_latents(ref.to(noisy.dtype))], dim=1)
            position_ids = torch.cat([position_ids, img_ids], dim=0)
        inputs = {
            "hidden_states": hidden,
            "encoder_hidden_states": prepared["text_embeds"],
            "timesteps": prepared["timesteps"],
            "position_ids": position_ids,
        }
        if "text_attention_mask" in prepared:
            inputs["encoder_attention_mask"] = prepared["text_attention_mask"]
        return inputs

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        out = module(**self.get_model_inputs(prepared))
        _, height, width, _ = prepared["noisy_latents"].shape
        return unpack_latents(out[:, :(height // 2) * (width // 2)], height, width)

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cond = {"text_embeds": batch["text_embeds"]}
        if "text_attention_mask" in batch:
            cond["text_attention_mask"] = batch["text_attention_mask"]
        if self._uses_reference_latents() and "control_latents" in batch:
            cond["control_latents"] = batch["control_latents"]
        return cond

    def _select_layers(self, available: int):
        if available > max(KREA2_SELECT_LAYERS):
            return KREA2_SELECT_LAYERS
        # a shorter trunk: num_text_layers taps spread evenly over what exists
        n = self.arch.num_text_layers
        return tuple(int(round(i * (available - 1) / max(n - 1, 1))) for i in range(n))

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: the selected taps stacked (S, L, D) and the mask."""
        (qwen,) = self.text_encoders
        out = qwen.encode_with_hidden_states(prompts)
        taps = out["hidden_states"]
        stack = np.stack([np.asarray(taps[i], np.float32) for i in self._select_layers(len(taps))], axis=2)
        return [{"text_embeds": stack[i], "attention_mask": np.asarray(out["attention_mask"][i])}
                for i in range(len(prompts))]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        out = {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}
        if all("attention_mask" in e for e in embeds):
            out["text_attention_mask"] = np.stack([np.asarray(e["attention_mask"]) for e in embeds])
        return out
