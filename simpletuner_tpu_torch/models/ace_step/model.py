"""ACE-Step audio family.

Counterpart of ``simpletuner_tpu/models/ace_step/model.py``: the 3.5B
text-to-music flow DiT of ``transformer.py`` (``ACEStepConfig()``; ``tiny``
under the tiny preset) over the 1-D audio VAE's 8-channel latents
(``audio_vae_config``: ``AudioVAEConfig.ace()``, stereo at 512x, ``tiny``
under the tiny preset), umT5 at 256 tokens from ``text_encoder`` as the
genre / caption features, and the lyrics as ids (``lyrics_tokens`` /
``lyrics_mask``, tokenized on the host by ``lyrics.py``: from a parquet
row's ``lyrics`` or the ``.lyrics.txt`` sidecar in the collate, from
``validation_lyrics`` in a render).  The flow interpolation is the shared
one.  ``_to_mel_layout`` reshapes (B, S, C) latents to (B, 16, S / 16, C)
(a plain reshape, as the JAX family does), so S must divide by the arch's
``latent_height``: at 44.1 kHz whole seconds give S = 86 latents a second
(21, 34, 47, 81 ... s divide by 16; the 5 s render default gives 430, which
does not); the port refuses such an S with the reason where the JAX reshape
raises.  ``family_lora_targets`` resolves ``acestep_lora_target`` (default
``attn_qkv+linear_qkv``) to its diffusers names; the Lite-LA ``linear_q/k/v``
names are kept for config compatibility and match the same fused modules.
Refused by name: the per-block intermediates / SSL projector tap (ROADMAP
Queue 1 item 4h) and ``lyrics_embedder_train`` (``training/optimizers.py``,
item 7).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..audio_vae import AudioVAEConfig
from ..common import ModelFoundation, TextEncoderSpec
from .transformer import ACEStepConfig, ACEStepTransformer


class ACEStep(ModelFoundation):
    NAME = "ace_step"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    MODALITY = "audio"
    LATENT_CHANNEL_COUNT = 8
    DEFAULT_FLAVOUR = "base"
    HUGGINGFACE_PATHS = {"base": "ACE-Step/ACE-Step-v1-3.5B"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="umt5", family="t5-xxl", subfolder="text_encoder", max_length=256),
    )
    DEFAULT_LORA_TARGET = ("attn_q", "attn_k", "attn_v", "attn_proj")
    LORA_TARGET_PRESETS = {
        "attn_qkv": ["to_q", "to_k", "to_v", "to_out.0"],
        "attn_qkv+linear_qkv": ["linear_q", "linear_k", "linear_v", "to_q", "to_k", "to_v", "to_out.0"],
        "attn_qkv+linear_qkv+speech_embedder": [
            "speaker_embedder", "linear_q", "linear_k", "linear_v", "to_q", "to_k", "to_v", "to_out.0",
        ],
    }

    def __init__(self, config: Any, arch: Optional[ACEStepConfig] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = ACEStepConfig.tiny()
        else:
            self.arch = ACEStepConfig()
        self._lyrics_tokenizer = None

    def family_lora_targets(self):
        preset = getattr(self.config, "acestep_lora_target", None) or "attn_qkv+linear_qkv"
        if preset not in self.LORA_TARGET_PRESETS:
            raise ValueError(f"unknown acestep_lora_target {preset!r}; available: {sorted(self.LORA_TARGET_PRESETS)}")
        return self.LORA_TARGET_PRESETS[preset]

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def audio_vae_config(self) -> AudioVAEConfig:
        if getattr(self.config, "model_arch_preset", None) == "tiny":
            return AudioVAEConfig.tiny()
        return AudioVAEConfig.ace()

    def create_module(self) -> ACEStepTransformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(ACEStepTransformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        return {
            "latents": torch.zeros((batch_size, 16, self.arch.in_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 8, self.arch.text_dim), device=device),
        }

    def _to_mel_layout(self, latents: torch.Tensor) -> torch.Tensor:
        """Audio-VAE latents (B, S, C) -> the mel layout (B, H, S / H, C)."""
        if latents.dim() == 4:
            return latents
        batch, seq, channels = latents.shape
        h = self.arch.latent_height
        if h == 1:
            return latents[:, None]
        if seq % h:
            raise ValueError(
                f"ace_step reshapes the audio VAE's (B, S, {channels}) latents to the mel layout (B, {h}, S / {h}, "
                f"{channels}), so S must divide by {h} (latent_height); S = {seq} does not.  At 44.1 kHz a second "
                "gives 86 latents: pick a bucket or validation_audio_duration whose latent length divides by "
                f"{h} (21, 34, 47 or 81 s)")
        return latents.reshape(batch, h, seq // h, channels)

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        inputs = {"latents": self._to_mel_layout(prepared["noisy_latents"]), "timesteps": prepared["timesteps"],
                  "text_embeds": prepared["text_embeds"]}
        if "speaker_embeds" in prepared:
            inputs["speaker_embeds"] = prepared["speaker_embeds"]
        if "lyrics_tokens" in prepared:
            tokens = prepared["lyrics_tokens"]
            inputs["lyric_tokens"] = tokens.to(torch.int32)
            inputs["lyric_mask"] = prepared.get(
                "lyrics_mask", torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device))
        if "text_attention_mask" in prepared:
            inputs["text_mask"] = prepared["text_attention_mask"]
        return inputs

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        return module(**self.get_model_inputs(prepared)).reshape(prepared["noisy_latents"].shape)

    def model_predict_with_intermediates(self, module: nn.Module, prepared: Dict[str, torch.Tensor]):
        raise NotImplementedError("the ace_step per-block intermediates tap (the SSL projector heads, REPA / CREPA) "
                                  "is not ported (ROADMAP Queue 1 item 4h)")

    @property
    def lyrics_tokenizer(self):
        if self._lyrics_tokenizer is None:
            from .lyrics import LyricsTokenizer

            self._lyrics_tokenizer = LyricsTokenizer(
                model_path=getattr(self.config, "pretrained_model_name_or_path", None))
        return self._lyrics_tokenizer

    def collate_batch_extras(self, samples, bundle, batch) -> None:
        """Lyric ids from each sample's parquet row or ``.lyrics.txt`` sidecar;
        none when no sample has lyrics (tags-only training), an empty one as a
        single masked 0 when some do."""
        lyrics = []
        found = False
        for sample in samples:
            path = sample["image_path"]
            row = (sample.get("metadata") or {}).get("row") or (
                bundle.metadata_backend.image_metadata.get(path, {}) or {}).get("row") or {}
            text = row.get("lyrics")
            if text is None:
                lyrics_path = path.rsplit(".", 1)[0] + ".lyrics.txt"
                if bundle.data_backend.exists(lyrics_path):
                    text = bundle.data_backend.read(lyrics_path).decode("utf-8")
            lyrics.append(text)
            found = found or bool(text)
        if not found:
            return
        ids, mask = self.lyrics_tokenizer.tokenize_batch(lyrics)
        batch["lyrics_tokens"] = ids
        batch["lyrics_mask"] = mask

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cond = {"text_embeds": batch["text_embeds"]}
        for key in ("speaker_embeds", "lyrics_tokens", "lyrics_mask"):
            if key in batch:
                cond[key] = batch[key]
        if "lyrics_tokens" not in cond and getattr(self.config, "validation_lyrics", None):
            device = batch["text_embeds"].device
            ids, mask = self.lyrics_tokenizer.tokenize_batch(
                [self.config.validation_lyrics] * batch["text_embeds"].shape[0])
            cond["lyrics_tokens"] = torch.as_tensor(ids, device=device)
            cond["lyrics_mask"] = torch.as_tensor(mask, device=device)
        return cond

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: umT5's last hidden state (pads kept) and its mask."""
        (t5,) = self.text_encoders
        out = t5.encode(prompts)
        return [{"text_embeds": np.asarray(out["last_hidden_state"][i], np.float32),
                 "attention_mask": np.asarray(out["attention_mask"][i])} for i in range(len(prompts))]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("ace_step is a flow-matching family")
