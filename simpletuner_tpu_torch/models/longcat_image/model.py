"""LongCat-Image family.

Counterpart of ``simpletuner_tpu/models/longcat_image/model.py``: the Flux
MMDiT (19 double + 38 single blocks, 3072 wide, 24 heads of 128) with three
differences from Flux:

* the modulation takes the timestep alone (``FluxConfig(vector_embed=False,
  guidance_embed=False)``): no pooled text, no guidance;
* the text is Qwen2.5-VL's last hidden state (3584 wide, the ``qwen2.5-vl``
  spec at 512 tokens from ``text_encoder``) of the prompt inside a captioning
  template, whose prefix and suffix token spans ``encode_text`` slices off;
* sliding position ids: text (0, i, i), image (1, L + y, L + x) after the L
  text tokens, and in the ``edit`` flavour the reference image's tokens
  (``control_latents``) at (2, L + y, L + x), modulated at t = 0 token by
  token (the transformer's tokenwise timesteps); their predictions are
  sliced off.

``inference_conditioning`` gives the sampler the training ids.  The JAX
family inherits Flux's, which reads ``pooled_embeds`` (a key LongCat's text
payload lacks) and so raises ``KeyError`` in a render; the port renders.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from ..flux.model import Flux
from ..flux.transformer import FluxConfig, make_img_ids, pack_latents, unpack_latents

PROMPT_PREFIX = (
    "<|im_start|>system\nAs an image captioning expert, generate a descriptive "
    "text prompt based on an image content, suitable for input to a text-to-image "
    "model.<|im_end|>\n<|im_start|>user\n"
)
PROMPT_SUFFIX = "<|im_end|>\n<|im_start|>assistant\n"


def sliding_ids(batch: int, txt_len: int, height: int, width: int, device=None):
    """Text ids (B, L, 3) at (0, i, i) and image ids (B, H/2 * W/2, 3) at
    (1, L + y, L + x), f32."""
    pos = torch.arange(txt_len, dtype=torch.float32, device=device)
    txt_ids = torch.stack([torch.zeros_like(pos), pos, pos], dim=-1)[None].expand(batch, txt_len, 3)
    return txt_ids, _offset_ids(make_img_ids(batch, height, width, device=device), 1.0, txt_len)


def _offset_ids(ids: torch.Tensor, modality: float, txt_len: int) -> torch.Tensor:
    ids = ids.to(torch.float32) + float(txt_len)
    return torch.cat([torch.full_like(ids[..., :1], modality), ids[..., 1:]], dim=-1)


class LongcatImage(Flux):
    NAME = "longcat_image"
    PREDICTION_TYPE = "flow_matching"
    DEFAULT_FLAVOUR = "final"
    HUGGINGFACE_PATHS = {
        "final": "meituan-longcat/LongCat-Image",
        "dev": "meituan-longcat/LongCat-Image-Dev",
        "edit": "meituan-longcat/LongCat-Image-Edit",
    }
    LATENT_CHANNEL_COUNT = 16
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="qwen2.5-vl", family="qwen2.5-vl", subfolder="text_encoder", max_length=512),
    )

    def __init__(self, config: Any, arch: Optional[FluxConfig] = None):
        if arch is None:
            if getattr(config, "model_arch_preset", None) == "tiny":
                arch = dataclasses.replace(FluxConfig.tiny(), vector_embed=False, guidance_embed=False)
            else:
                arch = FluxConfig(in_channels=64, hidden_size=3072, num_heads=24, head_dim=128, depth_double=19,
                                  depth_single=38, txt_in_features=3584, vec_in_features=3584,
                                  vector_embed=False, guidance_embed=False)
        super().__init__(config, arch=arch)

    @property
    def is_kontext(self) -> bool:
        """The edit flavour appends the packed reference latents."""
        return self.flavour == "edit"

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // 8
        txt_len = 16 if self.arch.txt_in_features < 512 else 512
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.latent_channels), device=device),
            "t5_embeds": torch.zeros((batch_size, txt_len, self.arch.txt_in_features), device=device),
        }

    def prepare_batch(self, generator: torch.Generator, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # Flux's ids and guidance are replaced: no guidance embedder, sliding ids
        prepared = ModelFoundation.prepare_batch(self, generator, batch)
        latents = batch["latents"]
        prepared["txt_ids"], prepared["img_ids"] = sliding_ids(
            latents.shape[0], batch["t5_embeds"].shape[1], latents.shape[1], latents.shape[2], latents.device)
        return prepared

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        noisy = prepared["noisy_latents"]
        img = pack_latents(noisy)
        img_ids = prepared["img_ids"]
        timesteps = prepared["timesteps"]
        if self.is_kontext and "control_latents" in prepared:
            # the reference tokens: modality 2 at the image's offset, t = 0 on each
            ref = pack_latents(prepared["control_latents"].to(noisy.dtype))
            batch, height, width = noisy.shape[:3]
            ref_ids = _offset_ids(make_img_ids(batch, height, width, device=noisy.device), 2.0,
                                  prepared["t5_embeds"].shape[1])
            timesteps = torch.cat([timesteps[:, None].expand(batch, img.shape[1]),
                                   torch.zeros((batch, ref.shape[1]), dtype=timesteps.dtype, device=noisy.device)],
                                  dim=1)
            img = torch.cat([img, ref], dim=1)
            img_ids = torch.cat([img_ids, ref_ids], dim=1)
        return {
            "img": img,
            "img_ids": img_ids,
            "txt": prepared["t5_embeds"],
            "txt_ids": prepared["txt_ids"],
            "timesteps": timesteps,
            "vec": None,
        }

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        latents = batch["latents"]
        txt_ids, img_ids = sliding_ids(latents.shape[0], batch["t5_embeds"].shape[1], latents.shape[1],
                                       latents.shape[2], latents.device)
        cond = {"t5_embeds": batch["t5_embeds"], "txt_ids": txt_ids, "img_ids": img_ids}
        if "control_latents" in batch:
            cond["control_latents"] = batch["control_latents"]
        return cond

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        tokens = module(**self.get_model_inputs(prepared))
        height, width = prepared["noisy_latents"].shape[1:3]
        # drop the reference tokens' predictions (edit)
        return unpack_latents(tokens[:, : (height // 2) * (width // 2)], height, width)

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """Qwen2.5-VL's last hidden state of each prompt inside the captioning
        template, with the template's prefix and suffix token spans sliced off
        (their lengths from the tokenized template), and the mask likewise."""
        (qwen,) = self.text_encoders
        n_prefix = int(np.asarray(qwen.tokenizer([PROMPT_PREFIX])["attention_mask"]).sum())
        n_suffix = max(int(np.asarray(qwen.tokenizer([PROMPT_SUFFIX])["attention_mask"]).sum()), 1)
        out = qwen.encode([PROMPT_PREFIX + str(p) + PROMPT_SUFFIX for p in prompts])
        hidden = np.asarray(out["last_hidden_state"], np.float32)[:, n_prefix:-n_suffix]
        mask = np.asarray(out["attention_mask"])[:, n_prefix:-n_suffix]
        return [{"t5_embeds": hidden[i], "attention_mask": mask[i]} for i in range(len(prompts))]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {"t5_embeds": np.stack([np.asarray(e["t5_embeds"]) for e in embeds])}
