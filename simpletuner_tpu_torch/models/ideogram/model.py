"""Ideogram family.

Counterpart of ``simpletuner_tpu/models/ideogram/model.py``: the packed
DiT of ``transformer.py`` (``IdeogramConfig()``, 4608 wide, 18 heads of
256, 34 layers, or ``tiny`` under the tiny preset) over 32-channel latents
packed 2 x 2 (Flux's ``pack_latents``, (ph, pw, c) order) after the text in
one sequence: text positions (i, i, i), image positions 65,536 + (0, h, w),
segment ids the text mask (0 / 1) then 1, the indicator, and t = 1 - sigma;
the output's image rows are unpacked and negated back to the velocity.  The
conditioning is 13 taps of the ``qwen2.5-vl`` spec's trunk (Qwen3-VL-8B,
read in the qwen2 layout, at 512 tokens from ``text_encoder``) concatenated
on the features: the layers (0, 3, ..., 33, 35) of the embeddings-first
states, or on a shorter trunk ``llm_taps`` taps spread evenly over what it
has.  Every prompt passes through the auto-json caption path
(``prompting.py``) unless ``ideogram_auto_json`` is off, after the optional
enhancer (``ideogram_prompt_upsample``, ``prompt_enhancer.py``).

Mirrored as the JAX family keeps them (ROADMAP Queue 3): the model's
docstring says the importer permutes ``input_proj`` / ``final_linear`` from
the reference's (c, ph, pw) packing, but the importer maps them 1:1, so a
published file is read in another feature order; ``LATENT_CHANNEL_COUNT``
32 meets the trainer's 16-channel ``VAEConfig.flux()``, so only the tiny
preset trains through ``Trainer.run()``; the render payload's mask rides as
``attention_mask``, which ``inference_conditioning`` does not read, so
renders run with every text segment id 1; ``DEFAULT_LORA_TARGET`` is read by
no code.  The CREPA tap is refused by name (ROADMAP Queue 1 item 4h).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from ..flux.transformer import pack_latents, unpack_latents
from .transformer import (
    IMAGE_POSITION_OFFSET,
    LLM_TOKEN_INDICATOR,
    OUTPUT_IMAGE_INDICATOR,
    QWEN3_VL_ACTIVATION_LAYERS,
    IdeogramConfig,
    IdeogramTransformer,
)


class Ideogram(ModelFoundation):
    NAME = "ideogram"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    LATENT_CHANNEL_COUNT = 32
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "fp8"
    HUGGINGFACE_PATHS = {"fp8": "ideogram-ai/ideogram-v3-fp8"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="qwen3-vl", family="qwen2.5-vl", subfolder="text_encoder", max_length=512),
    )
    DEFAULT_LORA_TARGET = ("qkv", "o", "w1", "w2", "w3")
    DEFAULT_PROMPT_ENHANCER_HEAD = "diffusers/qwen3-vl-8b-instruct-lm-head"

    def __init__(self, config: Any, arch: Optional[IdeogramConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = IdeogramConfig.tiny()
        else:
            self.arch = IdeogramConfig()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels // 4  # 2x2 packing

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("ideogram is a flow-matching family")

    def create_module(self) -> IdeogramTransformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(IdeogramTransformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = max(resolution // 8, 8)
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.latent_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 6, self.arch.llm_features_dim), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        noisy = prepared["noisy_latents"]  # (B, H, W, C)
        batch, height, width, _ = noisy.shape
        device = noisy.device
        grid_h, grid_w = height // 2, width // 2
        packed = pack_latents(noisy)  # (B, S_img, 4C)
        img_len = packed.shape[1]
        text = prepared["text_embeds"]
        txt_len = text.shape[1]

        text_ids = torch.arange(txt_len, dtype=torch.int32, device=device)[:, None].expand(txt_len, 3)
        rows = torch.arange(grid_h, dtype=torch.int32, device=device).repeat_interleave(grid_w)
        cols = torch.arange(grid_w, dtype=torch.int32, device=device).repeat(grid_h)
        img_ids = torch.stack([torch.zeros_like(rows), rows, cols], dim=1) + IMAGE_POSITION_OFFSET
        position_ids = torch.cat([text_ids, img_ids], dim=0)[None].expand(batch, txt_len + img_len, 3)

        mask = prepared.get("text_attention_mask")
        if mask is None:
            mask = torch.ones((batch, txt_len), dtype=torch.int32, device=device)
        segment_ids = torch.cat([mask.to(torch.int32), torch.ones((batch, img_len), dtype=torch.int32,
                                                                  device=device)], dim=1)
        indicator = torch.cat([torch.full((batch, txt_len), LLM_TOKEN_INDICATOR, dtype=torch.int32, device=device),
                               torch.full((batch, img_len), OUTPUT_IMAGE_INDICATOR, dtype=torch.int32,
                                          device=device)], dim=1)
        llm_features = torch.cat([text, text.new_zeros((batch, img_len, text.shape[-1]))], dim=1)
        x = torch.cat([packed.new_zeros((batch, txt_len, packed.shape[-1])), packed], dim=1)
        return {
            "llm_features": llm_features,
            "x": x,
            "t": 1.0 - prepared["timesteps"].to(torch.float32),  # the model runs on inverted flow time
            "position_ids": position_ids,
            "segment_ids": segment_ids,
            "indicator": indicator,
        }

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        out = module(**self.get_model_inputs(prepared))
        txt_len = prepared["text_embeds"].shape[1]
        _, height, width, _ = prepared["noisy_latents"].shape
        # the raw output is negated back to the velocity
        return -unpack_latents(out[:, txt_len:], height, width)

    def model_predict_with_intermediates(self, module: nn.Module, prepared: Dict[str, torch.Tensor]):
        raise NotImplementedError("the ideogram per-block intermediates tap (CREPA) is not ported "
                                  "(ROADMAP Queue 1 item 4h)")

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cond = {"text_embeds": batch["text_embeds"]}
        if "text_attention_mask" in batch:
            cond["text_attention_mask"] = batch["text_attention_mask"]
        return cond

    def _select_taps(self, available: int):
        if available > max(QWEN3_VL_ACTIVATION_LAYERS):
            return QWEN3_VL_ACTIVATION_LAYERS
        n = self.arch.llm_taps
        return tuple(int(round(i * (available - 1) / max(n - 1, 1))) for i in range(n))

    def _preprocess_prompts(self, prompts: Sequence[str]) -> List[str]:
        """The enhancer (``ideogram_prompt_upsample``) and then the auto-json
        caption path (on unless ``ideogram_auto_json`` is false)."""
        from .prompting import maybe_convert_prompt_to_ideogram_json

        if getattr(self.config, "ideogram_prompt_upsample", False):
            from .prompt_enhancer import load_enhancer_head, upsample_prompt

            if getattr(self, "_enhancer_head", None) is None:
                head_id = (getattr(self.config, "ideogram_prompt_enhancer_head_id", None)
                           or self.DEFAULT_PROMPT_ENHANCER_HEAD)
                self._enhancer_head = load_enhancer_head(head_id)
            (qwen,) = self.text_encoders
            resolution = int(getattr(self.config, "resolution", None) or 1024)
            prompts = [upsample_prompt(qwen, self._enhancer_head, str(p), height=resolution, width=resolution,
                                       seed=int(getattr(self.config, "seed", 0) or 0)) for p in prompts]
        auto_json = getattr(self.config, "ideogram_auto_json", None)
        auto_json = True if auto_json is None else bool(auto_json)
        return [maybe_convert_prompt_to_ideogram_json(str(p), enabled=auto_json) for p in prompts]

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: the selected taps concatenated on the features, and the mask."""
        (qwen,) = self.text_encoders
        out = qwen.encode_with_hidden_states(self._preprocess_prompts(prompts))
        taps = out["hidden_states"]
        stacked = np.concatenate([np.asarray(taps[i], np.float32) for i in self._select_taps(len(taps))], axis=-1)
        return [{"text_embeds": stacked[i], "attention_mask": np.asarray(out["attention_mask"][i])}
                for i in range(len(prompts))]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        out = {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}
        if all("attention_mask" in e for e in embeds):
            out["text_attention_mask"] = np.stack([np.asarray(e["attention_mask"]) for e in embeds])
        return out
