"""LTX-2 family.

Counterpart of ``simpletuner_tpu/models/ltxvideo2/model.py``: the
audiovisual DiT of ``transformer.py`` (``LTX2Config()``, 18.88B: 48 blocks,
a 4096-wide video and a 2048-wide audio stream; ``tiny`` under the tiny
preset) over the causal video VAE at 128 latent channels
(``video_vae_config``: 32x spatial, 8x temporal), conditioned on the
``gemma-2`` spec at 256 tokens, whose last hidden state ``encode_text``
tiles (or truncates) to the 3840-wide caption features, the JAX shim in the
place of the connectors; the collate keeps ``text_embeds`` alone, so the DiT
trains unmasked, as in the JAX package.

Training (``prepare_batch``): the flow preparation of the video latents;
a batch's ``audio_latents`` (B, Sa, C) noised with the same sigmas (the
audio noise drawn after the base draws, or ``override_audio_noise``); then
the intrinsic conditioning specs (``ltx2_intrinsic_conditioning`` and the
first-frame / prefix / suffix / mask probability aliases, plus
``spatial_crop``): each gated per sample, its tokens held clean at per-token
t = 0 and out of the loss (``token_timesteps`` (B, Sv), ``loss_mask``).  A
spec at probability 1 takes every sample without a draw; one in (0, 1)
draws its (B, 1) uniform gates from the step's generator.  The mask spec's
resizes are ``jax.image.resize``'s (``resize_linear``: the triangle kernel,
antialiased when it shrinks; ``resize_nearest``).  ``loss_fn`` is the mean
of the video and audio flow losses, with ``audio_loss`` in its aux dict.

IC-LoRA: a 5-D ``control_latents`` rides ahead of the target as clean
reference tokens (the spatial scale inferred from the grids unless
``ltx2_reference_spatial_scale_factor`` sets it), at ``conditioning_strength``;
``set_validation_video_conditioning`` installs a reference for renders.  The
spatial-upscale render's hooks: ``supports_multistage_validation``,
``latent_upsampler`` (a local file, or a seeded upsampler under the tiny
preset) and ``spatial_upscale_latents`` (identity statistics unless
``_video_vae_stats`` is set, which no code sets: ROADMAP Queue 3).
``load_video_vae`` (the checkpoint-faithful LTX-2 video VAE) and the
per-block intermediates tap are refused by name.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...training.losses import flow_interpolate, flow_target
from ..common import ModelFoundation, TextEncoderSpec
from ..video_vae import VideoVAEConfig
from .transformer import LTX2Config, LTX2Transformer

__all__ = ["LTX2Config", "LTX2Transformer", "LTXVideo2", "resize_linear", "resize_nearest"]


def _triangle_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """``jax.image``'s (in, out) weights of the triangle kernel, scaled by
    1 / scale when shrinking (antialiasing), normalised per output and zero
    where the sample falls outside the input; in float64."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float64, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float64, device=device)[:, None]).abs() / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    return torch.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None, :], weights, 0.0)


def resize_linear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, shape, "linear")``: every axis whose size
    changes contracted with its triangle weights (antialiased when
    shrinking), in float64 and rounded once to f32, so a value the exact
    function puts at the 0.5 threshold stays there (the f32 sums of XLA and
    of torch round such a value to either side, each in its own order)."""
    x = x.to(torch.float64)
    for axis, size in enumerate(shape):
        if x.shape[axis] != size:
            weights = _triangle_weights(x.shape[axis], int(size), x.device)
            x = torch.tensordot(x, weights, dims=([axis], [0])).movedim(-1, axis)
    return x.to(torch.float32)


def resize_nearest(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, shape, "nearest")``: per changed axis, the
    index floor((i + 0.5) in / out) computed in f32."""
    for axis, size in enumerate(shape):
        m = x.shape[axis]
        if m != size:
            offsets = torch.floor((torch.arange(int(size), dtype=torch.float32) + 0.5) * m / int(size)).to(torch.int64)
            x = x.index_select(axis, offsets.to(x.device))
    return x


class LTXVideo2(ModelFoundation):
    NAME = "ltxvideo2"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    MODALITY = "video"
    LATENT_CHANNEL_COUNT = 128
    DEFAULT_RESOLUTION = 768
    DEFAULT_FLAVOUR = "ltx2"
    HUGGINGFACE_PATHS = {"ltx2": "Lightricks/LTX-2"}
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="gemma-3", family="gemma-2", subfolder="text_encoder", max_length=256),
    )
    DEFAULT_LORA_TARGET = ("to_q", "to_k", "to_v", "to_out")
    # the stage-2 ladder of the spatial-upscale render (re-noised at its first sigma)
    LTX2_STAGE2_SIGMAS = (0.909375, 0.725, 0.421875)

    def __init__(self, config: Any, arch: Optional[LTX2Config] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = LTX2Config.tiny()
        else:
            self.arch = LTX2Config()
        self._latent_upsampler = None
        self._validation_ref = None

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("ltxvideo2 is a flow-matching family")

    def video_vae_config(self) -> VideoVAEConfig:
        """The causal video VAE of the latent cache at 128 channels (32x
        spatial, 8x temporal); the tiny VAE at the tiny arch's channels."""
        if getattr(self.config, "model_arch_preset", None) == "tiny":
            return dataclasses.replace(VideoVAEConfig.tiny(), latent_channels=self.arch.in_channels)
        return VideoVAEConfig(latent_channels=128, base_channels=64, channel_multipliers=(1, 2, 4, 8, 8, 8),
                              temporal_downsample=(False, True, True, True, False, False), num_res_blocks=2)

    def create_module(self) -> LTX2Transformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(LTX2Transformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        del resolution
        return {
            "latents": torch.zeros((batch_size, 2, 4, 4, self.arch.in_channels), device=device),
            "audio_latents": torch.zeros((batch_size, 6, self.arch.audio_in_channels), device=device),
            "text_embeds": torch.zeros((batch_size, 8, self.arch.caption_channels), device=device),
        }

    # ---- the spatial-upscale render's hooks ----------------------------------------------
    def supports_multistage_validation(self) -> bool:
        mode = str(getattr(self.config, "ltx2_validation_pipeline_mode", "trained-stage")
                   or "trained-stage").strip().lower()
        if mode not in ("trained-stage", "spatial-upscale"):
            raise ValueError("ltx2_validation_pipeline_mode must be trained-stage or spatial-upscale")
        return mode == "spatial-upscale"

    def latent_upsampler(self, device="cpu") -> nn.Module:
        """The stage-2 upsampler, built once: from the local safetensors file
        ``ltx2_validation_spatial_upsampler_model`` names, or under the tiny
        preset a seeded x2 upsampler at the arch's channels; anything else
        raises, as in the JAX package."""
        if self._latent_upsampler is None:
            from .latent_upsampler import LTX2LatentUpsampler, LTX2UpsamplerConfig, load_ltx2_latent_upsampler

            path = getattr(self.config, "ltx2_validation_spatial_upsampler_model", None)
            if path and os.path.isfile(str(path)):
                self._latent_upsampler = load_ltx2_latent_upsampler(str(path), device=device)
            elif getattr(self.config, "model_arch_preset", None) == "tiny":
                from ..layers import init_parameters

                cfg = dataclasses.replace(LTX2UpsamplerConfig.tiny(), in_channels=self.arch.in_channels)
                with torch.device(device):
                    module = LTX2LatentUpsampler(cfg)
                self._latent_upsampler = init_parameters(module, torch.Generator(device=device).manual_seed(0))
            else:
                raise ValueError("spatial-upscale validation requires ltx2_validation_spatial_upsampler_model to "
                                 "point at a local safetensors file (no silent random-weight fallback)")
        return self._latent_upsampler

    @torch.no_grad()
    def spatial_upscale_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """2x spatial upscale of (B, T, H, W, C) diffusion latents, under the
        video VAE's per-channel statistics when ``_video_vae_stats`` holds
        them, identity statistics otherwise."""
        from .latent_upsampler import upsample_ltx2_video_latents

        upsampler = self.latent_upsampler(latents.device)
        stats = getattr(self, "_video_vae_stats", None)
        if stats is not None:
            mean, std = (torch.as_tensor(s, dtype=torch.float32, device=latents.device) for s in stats)
        else:
            mean = torch.zeros(latents.shape[-1], dtype=torch.float32, device=latents.device)
            std = torch.ones(latents.shape[-1], dtype=torch.float32, device=latents.device)
        return upsample_ltx2_video_latents(latents, upsampler, mean, std)

    @staticmethod
    def load_video_vae(path: str, tiny: bool = False):
        raise NotImplementedError("the checkpoint-faithful LTX-2 video VAE (ltxvideo2/video_vae.py) is not ported "
                                  "(ROADMAP Queue 1 item 2, the LTX-2 codecs)")

    # ---- intrinsic conditioning ------------------------------------------------------------
    def _intrinsic_condition_specs(self) -> List[Dict[str, Any]]:
        """``ltx2_intrinsic_conditioning`` (a JSON string, dict or list) plus
        the alias probabilities, as a spec list."""
        raw = getattr(self.config, "ltx2_intrinsic_conditioning", None)
        if raw is None:
            specs = []
        elif isinstance(raw, str):
            specs = json.loads(raw)
        elif isinstance(raw, dict):
            specs = [raw]
        else:
            specs = list(raw)
        aliases = (
            ("first_frame", "ltx2_first_frame_conditioning_probability", {}),
            ("prefix", "ltx2_prefix_conditioning_probability", {"temporal_boundary": "ltx2_prefix_conditioning_frames"}),
            ("suffix", "ltx2_suffix_conditioning_probability", {"temporal_boundary": "ltx2_suffix_conditioning_frames"}),
            ("mask", "ltx2_mask_conditioning_probability", {}),
        )
        for cond_type, prob_attr, extra in aliases:
            probability = float(getattr(self.config, prob_attr, 0.0) or 0.0)
            if probability <= 0:
                continue
            spec = {"type": cond_type, "probability": probability}
            for key, attr in extra.items():
                value = getattr(self.config, attr, None)
                if value is not None:
                    spec[key] = value
            specs.append(spec)
        for spec in specs:
            if spec.get("type") not in ("first_frame", "prefix", "suffix", "spatial_crop", "mask"):
                raise ValueError(f"Unsupported LTX-2 intrinsic conditioning type: {spec.get('type')!r}.")
        return specs

    def _intrinsic_token_mask(self, spec: Dict[str, Any], prepared: Dict[str, torch.Tensor], batch: int,
                              frames: int, height: int, width: int, device) -> torch.Tensor:
        """(B, S) f32 mask of the tokens one spec holds clean (frame-major F H W tokens)."""
        seq, per_frame = frames * height * width, height * width
        kind = spec["type"]
        if kind in ("first_frame", "prefix", "suffix"):
            n_frames = 1 if kind == "first_frame" else int(spec.get("temporal_boundary", spec.get("num_frames", 1)))
            if n_frames * per_frame > seq:
                raise ValueError(f"LTX-2 temporal conditioning requested {n_frames * per_frame} tokens, but target "
                                 f"has {seq} tokens.")
            n_tokens = min(n_frames, frames) * per_frame
            idx = torch.arange(seq, device=device)
            mask1d = (idx >= seq - n_tokens) if kind == "suffix" else (idx < n_tokens)
            return mask1d.to(torch.float32)[None].expand(batch, seq)
        if kind == "spatial_crop":
            region = spec.get("spatial_region", spec.get("region", (0, 0, 0, 0)))
            if len(region) != 4:
                raise ValueError(f"LTX-2 spatial_crop conditioning requires [y1, x1, y2, x2], got {region}.")
            y1, x1, y2, x2 = (int(v) for v in region)
            y1, y2 = max(0, min(y1, height)), max(0, min(y2, height))
            x1, x2 = max(0, min(x1, width)), max(0, min(x2, width))
            if y2 < y1 or x2 < x1:
                raise ValueError(f"LTX-2 spatial_crop region must be ordered [y1, x1, y2, x2], got {region}.")
            spatial = torch.zeros((height, width), dtype=torch.float32, device=device)
            spatial[y1:y2, x1:x2] = 1.0
            return spatial.reshape(-1).repeat(frames)[None].expand(batch, seq)
        # "mask": the data plane delivers mask datasets as latent-resolution loss_mask
        mask_key = spec.get("mask_key", "conditioning_pixel_values")
        raw = prepared.get(mask_key)
        if raw is None and mask_key == "conditioning_pixel_values":
            raw = prepared.get("loss_mask")
        if raw is None:
            raise ValueError(f"LTX-2 mask conditioning requested but prepared_batch[{mask_key!r}] is missing.")
        raw = raw.to(torch.float32)
        if raw.dim() == 2:
            raw = raw[None].expand(batch, *raw.shape)
        raw = torch.where(raw.min() < 0, raw / 2.0 + 0.5, raw)
        if raw.dim() == 3:
            resized = resize_linear(raw, (batch, height, width))[:, None].expand(batch, frames, height, width)
        elif raw.dim() == 4:
            resized = resize_nearest(raw, (batch, frames, height, width))
        else:
            raise ValueError(f"LTX-2 mask conditioning expects [B,H,W] or [B,F,H,W], got {tuple(raw.shape)}.")
        return (resized > 0.5).to(torch.float32).reshape(batch, seq)

    def _apply_intrinsic_conditioning(self, generator: torch.Generator,
                                      prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """noisy := m clean + (1 - m) noisy, t := (1 - m) t per token, and the
        loss mask without the conditioned tokens, per spec gated per sample."""
        specs = self._intrinsic_condition_specs()
        if not specs:
            return prepared
        noisy = prepared["noisy_latents"]
        batch, frames, height, width, channels = noisy.shape
        seq, device = frames * height * width, noisy.device
        clean_tok = prepared["latents"].to(noisy.dtype).reshape(batch, seq, channels)
        noisy_tok = noisy.reshape(batch, seq, channels)
        t_tok = prepared["timesteps"].to(torch.float32).reshape(batch, 1).expand(batch, seq)
        keep = torch.ones((batch, seq), dtype=torch.float32, device=device)
        consumed_loss_mask = False
        for spec in specs:
            probability = float(spec.get("probability", 1.0))
            if probability <= 0:
                continue
            if probability >= 1.0:
                gate = torch.ones((batch, 1), dtype=torch.float32, device=device)
            else:
                draws = torch.rand((batch, 1), generator=generator, device=device, dtype=torch.float32)
                gate = (draws < probability).to(torch.float32)
            if spec["type"] == "mask" and spec.get("mask_key", "conditioning_pixel_values") == \
                    "conditioning_pixel_values" and "conditioning_pixel_values" not in prepared and \
                    "loss_mask" in prepared:
                # the mask dataset arrived as loss_mask: it is the source, not a loss mask on top
                consumed_loss_mask = True
            mask = self._intrinsic_token_mask(spec, prepared, batch, frames, height, width, device) * gate
            noisy_tok = mask[..., None] * clean_tok + (1.0 - mask[..., None]) * noisy_tok
            t_tok = (1.0 - mask) * t_tok
            keep = keep * (1.0 - mask)
        out = dict(prepared)
        out["noisy_latents"] = noisy_tok.reshape(noisy.shape)
        out["token_timesteps"] = t_tok
        video_mask = keep.reshape(batch, frames, height, width, 1)
        existing = None if consumed_loss_mask else prepared.get("loss_mask")
        if existing is not None:
            em = existing.to(torch.float32)
            if em.dim() == 3:  # (B, H', W') -> every frame
                em = resize_linear(em, (batch, height, width))[:, None, :, :, None].expand(video_mask.shape)
            else:
                em = em.reshape(video_mask.shape)
            video_mask = video_mask * em
        out["loss_mask"] = video_mask
        return out

    # ---- joint AV training -----------------------------------------------------------------
    def prepare_batch(self, generator: torch.Generator, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The flow preparation, the audio stream noised with the same sigmas
        (its noise drawn after the base draws, or ``override_audio_noise``),
        then the intrinsic conditioning."""
        batch = dict(batch)
        override = batch.pop("override_audio_noise", None)
        prepared = super().prepare_batch(generator, batch)
        audio = prepared.get("audio_latents")
        if audio is not None:
            noise = torch.randn(audio.shape, generator=generator, device=audio.device, dtype=torch.float32)
            if override is not None:
                noise = override.float()
            prepared["audio_noisy_latents"] = flow_interpolate(audio.float(), noise, prepared["sigmas"])
            prepared["audio_target"] = flow_target(audio.float(), noise)
        return self._apply_intrinsic_conditioning(generator, prepared)

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        noisy = prepared["noisy_latents"]
        batch, frames, height, width, channels = noisy.shape
        audio = prepared.get("audio_noisy_latents")
        if audio is None:
            audio = torch.zeros((batch, 1, self.arch.audio_in_channels), dtype=torch.float32, device=noisy.device)
        inputs: Dict[str, Any] = {
            "video_tokens": noisy.reshape(batch, frames * height * width, channels),
            "audio_tokens": audio,
            "text_embeds": prepared["text_embeds"],
            "timesteps": prepared.get("token_timesteps", prepared["timesteps"]),
            "num_frames": frames, "height": height, "width": width,
        }
        if "token_timesteps" in prepared:
            inputs["audio_timesteps"] = prepared["timesteps"]  # the audio stream keeps the scalar sigma
        if "text_attention_mask" in prepared:
            inputs["text_mask"] = prepared["text_attention_mask"]
        ref = prepared.get("control_latents")
        if ref is not None and ref.dim() == 5:
            rb, rf, rh, rw, rc = ref.shape
            if rc != channels:
                raise ValueError(f"LTX-2 IC-LoRA conditioning latents must match target latent channels "
                                 f"({rc} vs {channels})")
            inputs["ref_tokens"] = ref.reshape(rb, rf * rh * rw, rc)
            inputs["ref_shape"] = (rf, rh, rw)
            spatial = getattr(self.config, "ltx2_reference_spatial_scale_factor", None)
            if spatial is None:
                if rh == height and rw == width:
                    spatial = 1
                elif rh <= 0 or rw <= 0 or height % rh or width % rw:
                    raise ValueError(f"LTX-2 reference dims {rh}x{rw} must evenly divide target {height}x{width}")
                else:
                    spatial = height // rh
                    if spatial != width // rw:
                        raise ValueError(f"LTX-2 reference scale must be uniform, got {height // rh} vs {width // rw}")
            inputs["ref_spatial_scale"] = int(spatial)
            inputs["ref_temporal_scale"] = int(getattr(self.config, "ltx2_reference_temporal_scale_factor", 1) or 1)
            strength = prepared.get("conditioning_strength")
            if strength is not None:
                inputs["ref_strength"] = torch.as_tensor(strength, dtype=torch.float32, device=noisy.device) \
                    .reshape(-1, 1).expand(rb, rf * rh * rw)
        return inputs

    def predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]):
        """The video prediction at the latents' shape and the audio one (B, Sa, C)."""
        video_out, audio_out = module(**self.get_model_inputs(prepared))
        return video_out.reshape(prepared["noisy_latents"].shape), audio_out

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.predict(module, prepared)[0]

    def model_predict_with_intermediates(self, module: nn.Module, prepared: Dict[str, torch.Tensor]):
        raise NotImplementedError("the ltxvideo2 per-block intermediates tap (CREPA) is not ported "
                                  "(ROADMAP Queue 1 item 4h)")

    def loss_fn(self, module: nn.Module, generator: torch.Generator, batch: Dict[str, torch.Tensor]):
        """The mean of the video and audio flow losses (the video loss alone
        without ``audio_latents``); ``audio_loss`` in the aux dict.  The audio
        prediction stays local (the JAX family keeps it on the object): a
        reference held past the step would keep its autograd graph alive into
        the next, which breaks a CUDA graph's capture."""
        prepared = self.prepare_batch(generator, batch)
        if self.lora_rank > 0 and "is_regularisation_data" in prepared:
            raise NotImplementedError("prior preservation (regularisation data) is not ported")
        pred, audio_pred = self.predict(module, prepared)
        loss = self.compute_loss(pred, prepared)
        aux = {"timesteps": prepared["timesteps"]}
        if "audio_target" in prepared:
            audio_loss = (audio_pred.to(torch.float32) - prepared["audio_target"]).square().mean()
            loss = 0.5 * (loss + audio_loss)
            aux["audio_loss"] = audio_loss
        return loss, aux

    # ---- IC-LoRA reference video at render time ---------------------------------------------
    def validation_video_conditioning_entries(self):
        """``validation_ltx2_video_conditioning``: a JSON list of paths,
        [path, strength] pairs or {path / video_path, strength} objects ->
        [(path, strength)], None when unset."""
        raw = getattr(self.config, "validation_ltx2_video_conditioning", None)
        if raw in (None, "", [], ()):
            return None
        if isinstance(raw, str):
            raw = json.loads(raw)
        if isinstance(raw, dict):
            raw = [raw]
        if not isinstance(raw, (list, tuple)):
            raise ValueError("validation_ltx2_video_conditioning must be a JSON list of paths, [path, strength] "
                             "pairs, or objects with path/video_path")
        resolved = []
        for entry in raw:
            strength = 1.0
            if isinstance(entry, str):
                path = entry
            elif isinstance(entry, dict):
                path = entry.get("path", entry.get("video_path"))
                strength = float(entry.get("strength", 1.0))
            elif isinstance(entry, (list, tuple)) and len(entry) == 2:
                path, strength = entry
                strength = float(strength)
            else:
                raise ValueError("each validation_ltx2_video_conditioning entry must be a path, [path, strength] "
                                 "pair, or object with path/video_path")
            if not path:
                raise ValueError("validation_ltx2_video_conditioning entry is missing path/video_path")
            resolved.append((os.path.expanduser(str(path)), strength))
        return resolved

    def set_validation_video_conditioning(self, latents, strength: float) -> None:
        """Install encoded reference latents (1, F, H, W, C) for renders."""
        self._validation_ref = (np.asarray(latents, np.float32), float(strength))

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cond = {"text_embeds": batch["text_embeds"]}
        if "audio_latents" in batch:
            cond["audio_latents"] = batch["audio_latents"]
        if self._validation_ref is not None:
            latents, strength = self._validation_ref
            device = batch["text_embeds"].device
            cond["control_latents"] = torch.as_tensor(latents, device=device)
            cond["conditioning_strength"] = torch.full((latents.shape[0],), strength, dtype=torch.float32,
                                                       device=device)
        return cond

    # ---- text ------------------------------------------------------------------------------
    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """One payload per prompt: Gemma's last hidden state tiled (or
        truncated) to ``caption_channels`` (the JAX shim where the connectors
        would run) and its mask."""
        (gemma,) = self.text_encoders
        out = gemma.encode(prompts)
        hidden = np.asarray(out["last_hidden_state"], np.float32)
        width = self.arch.caption_channels
        if hidden.shape[-1] < width:
            hidden = np.tile(hidden, (1, 1, -(-width // hidden.shape[-1])))[..., :width]
        elif hidden.shape[-1] > width:
            hidden = hidden[..., :width]
        return [{"text_embeds": hidden[i], "attention_mask": np.asarray(out["attention_mask"][i])}
                for i in range(len(prompts))]

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {"text_embeds": np.stack([np.asarray(e["text_embeds"]) for e in embeds])}
