"""SD3 / SD3.5 family.

Counterpart of ``simpletuner_tpu/models/sd3/model.py``: flavour -> config
(``large-3.5`` -> ``SD3Config.large()``, the others the medium width), the
triple text encoder (CLIP-L + CLIP-G + T5-XXL at 256 tokens), the 16-channel
VAE factors, the module with its adapters, remat and int8 product mode, the
transformer inputs, ``model_predict``, the conditioning for sampling and
``encode_text`` with both uncond behaviours.  SD3 has no guidance embedding,
so a validation render with ``validation_guidance`` > 1 runs true CFG.
Refused, naming their ROADMAP Queue 1 items: skip-layer guidance (4d),
ControlNet (7), and the in-step text-encoder training path (4i).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation, TextEncoderSpec
from .transformer import SD3Config, SD3Transformer


class SD3(ModelFoundation):
    NAME = "sd3"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    LATENT_CHANNEL_COUNT = 16
    DEFAULT_RESOLUTION = 1024
    DEFAULT_FLAVOUR = "medium-3.5"
    HUGGINGFACE_PATHS = {
        "medium-3.5": "stabilityai/stable-diffusion-3.5-medium",
        "large-3.5": "stabilityai/stable-diffusion-3.5-large",
        "medium-3.0": "stabilityai/stable-diffusion-3-medium-diffusers",
    }
    # no tokenizer_subfolder, as in the JAX specs: CLIP-G reads ``tokenizer``
    # and T5 ``tokenizer_2`` (ROADMAP Queue 3)
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="clip-l", family="clip-l", subfolder="text_encoder", max_length=77),
        TextEncoderSpec(name="clip-g", family="clip-g", subfolder="text_encoder_2", max_length=77),
        TextEncoderSpec(name="t5-xxl", family="t5-xxl", subfolder="text_encoder_3", max_length=256),
    )
    DEFAULT_LORA_TARGET = ("attn_q", "attn_k", "attn_v", "attn_proj")
    VAE_SCALING_FACTOR = 1.5305
    VAE_SHIFT_FACTOR = 0.0609

    def __init__(self, config: Any, arch: Optional[SD3Config] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = SD3Config.tiny()
        elif self.flavour and "large" in self.flavour:
            self.arch = SD3Config.large()
        else:
            # medium-3.5 is built as SD3-medium 3.0, without MMDiT-X (ROADMAP Queue 3)
            self.arch = SD3Config.medium()

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def create_module(self) -> SD3Transformer:
        """The transformer, with LoRA adapters on every ``LoRADense`` the
        targets allow (f32 masters, B = 0 at init), whole-block remat and the
        int8 product mode of a quantized base (stored quantized by
        ``create_train_state``)."""
        return self.build_module(SD3Transformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        latent = resolution // 8
        return {
            "latents": torch.zeros((batch_size, latent, latent, self.arch.in_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 77 + 32, self.arch.context_dim), device=device),
            "pooled_embeds": torch.zeros((batch_size, self.arch.pooled_dim), device=device),
        }

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {
            "latents": prepared["noisy_latents"],
            "timesteps": prepared["timesteps"],
            "context": prepared["text_embeds"],
            "pooled": prepared["pooled_embeds"],
        }

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "control_latents" in prepared:
            raise NotImplementedError("SD3 ControlNet is not ported (ROADMAP Queue 1 item 7)")
        return module(**self.get_model_inputs(prepared))

    def denoise_fn_skip_layers(self, module: nn.Module, conditioning, skip_layers):
        raise NotImplementedError("SD3.5 skip-layer guidance is not ported (ROADMAP Queue 1 item 4d)")

    def init_controlnet_params(self, generator, batch):
        raise NotImplementedError("SD3 ControlNet is not ported (ROADMAP Queue 1 item 7)")

    def _controlnet_residuals(self, module, prepared):
        raise NotImplementedError("SD3 ControlNet is not ported (ROADMAP Queue 1 item 7)")

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"text_embeds": batch["text_embeds"], "pooled_embeds": batch["pooled_embeds"]}

    # ---- host-side text encoding ------------------------------------------------------------
    def _uncond_zeroing(self):
        """(zero CLIP, zero T5) for empty prompts: ``sd3_clip_uncond_behaviour``
        and ``sd3_t5_uncond_behaviour`` (which falls back to the CLIP one), each
        "empty_prompt" (encode "" as it is) or "zero"."""
        cfg = self.config
        clip = getattr(cfg, "sd3_clip_uncond_behaviour", "empty_prompt") or "empty_prompt"
        t5 = getattr(cfg, "sd3_t5_uncond_behaviour", None) or clip
        return clip == "zero", t5 == "zero"

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: ``text_embeds`` (77 CLIP tokens with CLIP-L
        and CLIP-G channels side by side, zero-padded to ``context_dim``,
        followed by the T5 sequence) and ``pooled_embeds`` (CLIP-L ++ CLIP-G
        pooled), f32.  Empty prompts (the CFG negative) get their segments
        zeroed under the "zero" uncond behaviours."""
        clip_l, clip_g, t5 = self.text_encoders
        out_l, out_g, out_t5 = clip_l.encode(prompts), clip_g.encode(prompts), t5.encode(prompts)
        clip_zero, t5_zero = self._uncond_zeroing()
        empty = np.asarray([not str(p).strip() for p in prompts])
        if clip_zero:
            for out in (out_l, out_g):
                for key in ("last_hidden_state", "pooled"):
                    if key in out:
                        out[key] = np.where(empty.reshape((-1,) + (1,) * (out[key].ndim - 1)), 0.0, out[key])
        if t5_zero:
            out_t5["last_hidden_state"] = np.where(empty[:, None, None], 0.0, out_t5["last_hidden_state"])
        context_dim, pooled_dim = self.arch.context_dim, self.arch.pooled_dim
        results = []
        for i in range(len(prompts)):
            clip_seq = np.concatenate([np.asarray(out_l["last_hidden_state"][i], np.float32),
                                       np.asarray(out_g["last_hidden_state"][i], np.float32)], axis=-1)
            clip_seq = np.pad(clip_seq, ((0, 0), (0, context_dim - clip_seq.shape[-1])))
            t5_seq = np.asarray(out_t5["last_hidden_state"][i], np.float32)
            if t5_seq.shape[-1] < context_dim:
                t5_seq = np.pad(t5_seq, ((0, 0), (0, context_dim - t5_seq.shape[-1])))
            pooled = np.concatenate([
                np.asarray(out_l.get("pooled", out_l["last_hidden_state"][:, 0])[i], np.float32),
                np.asarray(out_g.get("pooled", out_g["last_hidden_state"][:, 0])[i], np.float32),
            ])
            if pooled.shape[0] < pooled_dim:
                pooled = np.pad(pooled, (0, pooled_dim - pooled.shape[0]))
            results.append({"text_embeds": np.concatenate([clip_seq, t5_seq], axis=0), "pooled_embeds": pooled})
        return results

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {
            "text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds]),
            "pooled_embeds": np.stack([np.asarray(e["pooled_embeds"]) for e in embeds]),
        }

    # ---- in-step text-encoder training (the two CLIPs) ------------------------------------------
    def tokenize_captions(self, captions):
        raise NotImplementedError("SD3 text-encoder training is not ported (ROADMAP Queue 1 item 4i)")

    def apply_text_encoder(self, te_params, batch):
        raise NotImplementedError("SD3 text-encoder training is not ported (ROADMAP Queue 1 item 4i)")

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("sd3 is a flow-matching family")
