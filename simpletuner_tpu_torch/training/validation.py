"""Validation renders: prompt embeds -> sampling loop -> VAE decode -> PNG or mp4.

Counterpart of ``simpletuner_tpu/training/validation.py``: ``build_scheduler``
(flow Euler for the flow families, the EDM Euler ladder for cosmos' x0
prediction; for the DDPM families the family's beta
ladder with ``rescale_betas_zero_snr``, DDIM by default and UniPC when
``validation_noise_scheduler`` asks for it),
resolution and seed handling, the prompt list (``validation_prompt``, a user
prompt library or the built-in one), ``precompute_embeds``, the trainer's
schedule (``would_validate``), ``run_validations`` -> ``_run_one_pass``
(step-named PNGs with a slug, ``num_validation_images`` variants, the
``_vs_base`` stitch against ``run_benchmark``'s base renders, the
validation webhook event and the trackers' images), ``_latent_shape`` and
``_render_single``; a video family renders a square clip at the resolution
of ``validation_num_video_frames`` frames (default 9: 3 latent frames),
and a family that asks for it (LTX-2's ``spatial-upscale`` mode) the
two-stage ``_render_multistage`` (half resolution, the latent upsampler, a
short re-noised ladder, as the JAX dispatch reaches it),
decoded 5-D and written as an mp4 (mp4v, 8 fps, through OpenCV, imported
when a clip is written), its middle frame going to the trackers; it has no
benchmark render, as in the JAX package.  An audio family renders
``validation_audio_duration`` seconds at ``validation_audio_sample_rate``
(the latent length over the audio VAE's compression, at least 8), decodes
to f32 samples (no uint8 clip) and writes a 16-bit WAV (``_save_wav``,
through scipy, the JAX writer's bytes); no image reaches the trackers or the
webhook for it, as in the JAX pass.  ``precompute_embeds`` encodes the prompts (and, for
true CFG, the negative prompt) through the model's attached text encoders.
The render batch takes the payload's keys as they are, as the JAX
``_render_single`` does (validation.py:714-718): the T5 padding mask stays
``attention_mask``, which ``inference_conditioning`` does not read, so
renders are unmasked, as in the JAX package, even with
``flux_attention_masked_training``.  Where the JAX ``precompute_embeds``
logs a failed encode and disables validation, the port raises.  Noise comes
from a ``torch.Generator`` seeded from ``validation_seed`` and the prompt
index.  ``run_validations`` takes the module to render; the trainer hands it
``train_state.render_view`` (the counterpart of ``TrainState.variables``).
Refused, naming ROADMAP Queue 1 item 4d: img2img (``validation_using_datasets``),
validation adapters, external-script validation, previews, batched
(``validation_parallel``), staged renders (SDXL's and PixArt's
``full-pipeline`` mode, Wan 2.2's other expert; deepfloyd is not ported) and
skip-layer guidance.  PNGs are written with
``zlib``/``struct`` alone.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import struct
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..schedulers import (
    DDIMScheduler,
    EDMEulerScheduler,
    FlowMatchEulerScheduler,
    UniPCScheduler,
    classifier_free_guidance,
    sample_loop,
)
from ..webhooks.events import validation_event

logger = logging.getLogger(__name__)

# default validation prompts for --validation_prompt_library without a user
# library file (the JAX package's BUILTIN_PROMPT_LIBRARY)
BUILTIN_PROMPT_LIBRARY: Dict[str, str] = {
    "woman": "a woman, hanging out on the beach",
    "man": "a man playing guitar in a park",
    "child": "a child flying a kite on a sunny day",
    "animal": "a golden retriever running through a field",
    "landscape": "an alpine lake at sunrise, mist over the water",
    "architecture": "a futuristic city skyline at night, neon reflections",
    "still_life": "a bowl of fruit on a wooden table, soft window light",
    "abstract": "colorful abstract shapes, flowing gradients",
}

# validation options the port does not render (ROADMAP Queue 1 item 4d)
_UNPORTED = ("validation_using_datasets", "validation_adapters", "validation_adapter_path", "validation_preview",
             "validation_parallel", "validation_guidance_skip_layers")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    return device


def build_scheduler(model, num_steps: int, image_seq_len: Optional[int] = None):
    """Per-family inference scheduler."""
    if model.is_flow:
        shift = getattr(model.config, "validation_noise_scheduler_shift", None)
        use_dyn = bool(getattr(model.config, "flow_schedule_auto_shift", False))
        return FlowMatchEulerScheduler.create(
            num_steps,
            shift=shift if shift is not None else 3.0,
            use_dynamic_shifting=use_dyn,
            image_seq_len=image_seq_len,
        )
    if model.prediction_type == "sample" and hasattr(model, "sigma_max"):
        # an EDM x0-prediction family (cosmos): the Karras rho ladder
        return EDMEulerScheduler.create(num_steps, sigma_min=model.sigma_min, sigma_max=model.sigma_max,
                                        rho=model.sigma_schedule_order)
    name = (getattr(model.config, "validation_noise_scheduler", None) or "ddim").lower()
    # the family's beta ladder, not the SD default
    schedule = dataclasses.replace(
        model.ddpm_schedule_config(),
        rescale_betas_zero_snr=bool(getattr(model.config, "rescale_betas_zero_snr", False)),
    )
    if name == "unipc":
        return UniPCScheduler.create_ddpm(num_steps, schedule, model.prediction_type)
    return DDIMScheduler.create(num_steps, schedule, model.prediction_type)


def noise_generator(seed: int, index: int) -> torch.Generator:
    """CPU generator for prompt ``index``'s noise (the JAX path folds the
    index into PRNGKey(seed)); drawing on the CPU keeps the noise identical
    across devices."""
    return torch.Generator(device="cpu").manual_seed(seed * 1_000_003 + index)


class Validation:
    def __init__(
        self,
        model,
        config,
        decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        output_dir: str = "output",
        trackers: Optional[List] = None,
        webhook_handler=None,
        device="cuda",
    ):
        for key in _UNPORTED:
            if getattr(config, key, None):
                raise NotImplementedError(f"{key} is not ported (ROADMAP Queue 1 item 4d)")
        if model.supports_multistage_validation() and not callable(getattr(model, "spatial_upscale_latents", None)):
            raise NotImplementedError("staged (full-pipeline) validation renders are not ported "
                                      "(ROADMAP Queue 1 item 4d)")
        method = str(getattr(config, "validation_method", None) or "simpletuner-local").strip().lower()
        if method.replace("_", "-") != "simpletuner-local":
            raise NotImplementedError(f"validation_method={method!r} is not ported (ROADMAP Queue 1 item 4d)")
        self.model = model
        self.config = config
        self.decode_fn = decode_fn
        self.output_dir = output_dir
        self.trackers = trackers or []
        self.webhook_handler = webhook_handler
        self.device = resolve_device(device)
        raw = getattr(config, "validation_prompt", None)
        self.prompts: List[str] = ([raw] if isinstance(raw, str) else list(raw)) if raw else []
        library = getattr(config, "user_prompt_library", None)
        if library and os.path.exists(str(library)):
            with open(library) as handle:
                self.prompts.extend(json.load(handle).values())
        elif getattr(config, "validation_prompt_library", False):
            self.prompts.extend(BUILTIN_PROMPT_LIBRARY.values())
        self._embeds: List[Dict[str, np.ndarray]] = []
        self._negative_embeds: Optional[Dict[str, np.ndarray]] = None
        self._benchmark_images: List[np.ndarray] = []

        self.num_steps = int(getattr(config, "validation_num_inference_steps", 20) or 20)
        raw_res = getattr(config, "validation_resolution", None) or getattr(config, "resolution", 512) or 512
        if isinstance(raw_res, str) and "x" in raw_res:  # reference "WxH" format
            raw_res = raw_res.split("x")[0]
        self.resolution = int(float(raw_res))
        self.interval = getattr(config, "validation_steps", None)
        self.seed = int(getattr(config, "validation_seed", None) or getattr(config, "seed", 42) or 42)
        self.disabled = bool(getattr(config, "validation_disable", False)) or not self.prompts

    # ---- embeds --------------------------------------------------------------------------
    def precompute_embeds(self) -> None:
        """Encode every prompt (and the negative prompt, for true CFG) with
        the model's text encoders, while they are attached."""
        if self.disabled:
            return
        self._embeds = self.model.encode_text(self.prompts)
        if self._wants_cfg():
            negative = str(getattr(self.config, "validation_negative_prompt", "") or "")
            self._negative_embeds = self.model.encode_text([negative])[0]

    def _cfg_params(self, scheduler):
        """(rescale, no-CFG threshold t) of the guided render
        (``validation_guidance_rescale``, ``validation_no_cfg_until_timestep``)."""
        rescale = float(getattr(self.config, "validation_guidance_rescale", 0.0) or 0.0)
        until = int(getattr(self.config, "validation_no_cfg_until_timestep", 0) or 0)
        no_cfg_t = scheduler.timestep(min(until, scheduler.num_steps - 1)) if until > 0 else None
        return rescale, no_cfg_t

    def _wants_cfg(self) -> bool:
        """True CFG (two forward passes) for families without guidance embeds."""
        guidance = float(getattr(self.config, "validation_guidance", 0.0) or 0.0)
        has_guidance_embed = bool(getattr(getattr(self.model, "arch", None), "guidance_embed", False))
        return guidance > 1.0 and not has_guidance_embed

    # ---- scheduling ------------------------------------------------------------------------
    def would_validate(self, step: int, force: bool = False) -> bool:
        if self.disabled:
            return False
        if force:
            return True
        return bool(self.interval) and step > 0 and step % int(self.interval) == 0

    # ---- benchmark (base-model renders for stitching) ---------------------------------------
    def run_benchmark(self, module: nn.Module) -> None:
        """Render every prompt with ``module`` (the trainer's base, adapters
        zeroed) into ``benchmark/base_<i>.png``; later passes stitch their
        render beside it."""
        if self.disabled or getattr(self.model, "MODALITY", "image") != "image":
            return
        self._benchmark_images = []
        for index, embeds in enumerate(self._embeds):
            image = self._render_single(module, embeds, index)
            path = os.path.join(self.output_dir, "benchmark", f"base_{index}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._save_png(image, path)
            self._benchmark_images.append(image)

    def _stitch(self, base: np.ndarray, current: np.ndarray) -> np.ndarray:
        height = min(base.shape[0], current.shape[0])
        return np.concatenate([base[:height], current[:height]], axis=1)

    # ---- run -------------------------------------------------------------------------------
    def _latent_shape(self, batch_size: int):
        channels = self.model.latent_channels
        if self._is_audio:
            vae_cfg = self.model.audio_vae_config()
            seconds = float(getattr(self.config, "validation_audio_duration", 5.0) or 5.0)
            length = max(int(seconds * self._audio_rate) // vae_cfg.compression, 8)
            return (batch_size, length, channels)
        if getattr(self.model, "MODALITY", "image") == "video":
            vae_cfg = self.model.video_vae_config()
            size = self.resolution // vae_cfg.spatial_factor
            frames = int(getattr(self.config, "validation_num_video_frames", 9) or 9)
            return (batch_size, (frames - 1) // vae_cfg.temporal_factor + 1, size, size, channels)
        factor = 8 if getattr(self.model, "REQUIRES_VAE", True) else 1
        size = self.resolution // factor
        return (batch_size, size, size, channels)

    def run_validations(self, module: nn.Module, step: int = 0, force: bool = False, slug: str = "") -> List[str]:
        """Render every prompt with ``module`` when ``would_validate(step,
        force)``; returns the saved PNG (or mp4) paths.  ``slug`` suffixes the file
        names (``_ema`` for the EMA comparison pass)."""
        if not self.would_validate(step, force):
            return []
        return self._run_one_pass(module, step, slug)

    def _run_one_pass(self, module: nn.Module, step: int, slug: str = "") -> List[str]:
        paths, images = [], []
        num_images = max(1, int(getattr(self.config, "num_validation_images", 1) or 1))
        for index, (prompt, embeds) in enumerate(zip(self.prompts, self._embeds)):
            # extra per-prompt variants, noise from a disjoint index space
            for variant in range(1, num_images):
                extra = self._render(module, embeds, index + 7919 * variant)
                self._save(extra, self._path(f"step_{step}_{index}_v{variant}{slug}.{self._ext(extra)}"))
            image = self._render(module, embeds, index)
            filename = self._path(f"step_{step}_{index}{slug}.{self._ext(image)}")
            self._save(image, filename)
            if self._is_audio:  # a waveform: no image for the trackers or the webhook
                continue
            if image.ndim == 4:  # a clip: its middle frame for the trackers
                image = image[image.shape[0] // 2]
            elif index < len(self._benchmark_images):
                stitched = self._stitch(self._benchmark_images[index], image)
                self._save_png(stitched, self._path(f"step_{step}_{index}_vs_base.png"))
            paths.append(filename)
            images.append(image)
            if self.webhook_handler is not None:
                self.webhook_handler.send_raw(validation_event(step, prompt, filename))
        for tracker in self.trackers:
            try:
                tracker.log_images(images, self.prompts, step)
            except Exception as exc:
                logger.debug("tracker image log failed: %s", exc)
        return paths

    @property
    def _is_audio(self) -> bool:
        return getattr(self.model, "MODALITY", "image") == "audio"

    @property
    def _audio_rate(self) -> int:
        return int(getattr(self.config, "validation_audio_sample_rate", 44100) or 44100)

    def _ext(self, image: np.ndarray) -> str:
        return "wav" if self._is_audio else ("mp4" if image.ndim == 4 else "png")

    def _save(self, image: np.ndarray, path: str) -> None:
        if self._is_audio:
            self._save_wav(image, path, self._audio_rate)
        elif image.ndim == 4:
            self._save_video(image, path)
        else:
            self._save_png(image, path)

    def _path(self, name: str) -> str:
        path = os.path.join(self.output_dir, "validation", name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    def _batch(self, embeds: Dict[str, np.ndarray], latent_shape) -> Dict[str, torch.Tensor]:
        """Zero latents and the payload's arrays under their own keys, batch 1."""
        batch = {"latents": torch.zeros(latent_shape, dtype=torch.float32, device=self.device)}
        for key, value in embeds.items():
            if hasattr(value, "shape"):
                batch[key] = torch.as_tensor(np.asarray(value), device=self.device)[None]
        return batch

    def _render(self, module: nn.Module, embeds: Dict[str, np.ndarray], index: int) -> np.ndarray:
        """The JAX dispatch of what the port renders: the spatial-upscale
        render for a clip of a family that asks for it, else the single one."""
        if self.model.supports_multistage_validation() and len(self._latent_shape(1)) == 5:
            return self._render_multistage(module, embeds, index)
        return self._render_single(module, embeds, index)

    @torch.no_grad()
    def _render_multistage(self, module: nn.Module, embeds: Dict[str, np.ndarray], index: int) -> np.ndarray:
        """The two-stage spatial-upscale render (LTX-2), no CFG: stage 1 at
        half the spatial resolution on a ladder built for its sequence, the
        family's latent upsampler doubling it, stage 2 re-noised at the first
        of ``LTX2_STAGE2_SIGMAS`` and run down that ladder to 0, then the
        decode.  Both noises come from the prompt's generator, stage 2's after
        stage 1's."""
        b, t, h, w, c = self._latent_shape(1)
        stage1_shape = (b, t, max(h // 2, 1), max(w // 2, 1), c)
        cond = self.model.inference_conditioning(self._batch(embeds, stage1_shape))
        seq = stage1_shape[1] * (stage1_shape[2] // 2) * (stage1_shape[3] // 2)
        scheduler1 = build_scheduler(self.model, self.num_steps, image_seq_len=max(seq, 1))
        generator = noise_generator(self.seed, index)
        noise1 = torch.randn(stage1_shape, generator=generator, dtype=torch.float32)
        latents = sample_loop(scheduler1, self.model.denoise_fn(module, cond), noise1.to(self.device))
        upscaled = self.model.spatial_upscale_latents(latents)
        sigma_list = [float(sigma) for sigma in self.model.LTX2_STAGE2_SIGMAS]
        sigmas2 = torch.tensor(sigma_list + [0.0], dtype=torch.float32)
        scheduler2 = FlowMatchEulerScheduler(sigmas=sigmas2, timesteps=sigmas2[:-1])
        noise2 = torch.randn(tuple(upscaled.shape), generator=generator, dtype=torch.float32).to(self.device)
        start = (1.0 - sigma_list[0]) * upscaled + sigma_list[0] * noise2
        return self._decoded(sample_loop(scheduler2, self.model.denoise_fn(module, cond), start))

    def _decoded(self, latents: torch.Tensor) -> np.ndarray:
        """The first sample's latents without a ``decode_fn``, else its uint8 pixels."""
        if self.decode_fn is None:
            return latents[0].cpu().numpy()
        scaling = self.model.VAE_SCALING_FACTOR or 1.0
        shift = self.model.VAE_SHIFT_FACTOR or 0.0
        out = self.decode_fn(latents / scaling + shift)[0].to(torch.float32)
        if self._is_audio:  # f32 samples, clipped only when written
            return out.cpu().numpy()
        return ((out + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()

    @torch.no_grad()
    def _render_single(self, module: nn.Module, embeds: Dict[str, np.ndarray], index: int) -> np.ndarray:
        latent_shape = self._latent_shape(1)
        if len(latent_shape) == 5:  # video: (B, T, H, W, C)
            seq_len = latent_shape[1] * (latent_shape[2] // 2) * (latent_shape[3] // 2)
        else:
            seq_len = (latent_shape[1] // 2) * (latent_shape[2] // 2)
        scheduler = build_scheduler(self.model, self.num_steps, image_seq_len=seq_len)
        cond = self.model.inference_conditioning(self._batch(embeds, latent_shape))
        denoise = self.model.denoise_fn(module, cond)
        if self._wants_cfg() and self._negative_embeds is not None:
            uncond_fn = self.model.denoise_fn(
                module, self.model.inference_conditioning(self._batch(self._negative_embeds, latent_shape))
            )
            cond_fn = denoise
            scale = float(getattr(self.config, "validation_guidance", 0.0) or 0.0)
            rescale, no_cfg_t = self._cfg_params(scheduler)

            def denoise(latents, t):
                # CFG off while t is above the threshold (t descends)
                step_scale = 1.0 if no_cfg_t is not None and bool(t > no_cfg_t) else scale
                return classifier_free_guidance(cond_fn(latents, t), uncond_fn(latents, t), step_scale, rescale)

        noise = torch.randn(latent_shape, generator=noise_generator(self.seed, index), dtype=torch.float32)
        return self._decoded(sample_loop(scheduler, denoise, noise.to(self.device)))

    @staticmethod
    def _save_wav(waveform: np.ndarray, path: str, sample_rate: int = 44100) -> None:
        """(S, C) f32 samples in [-1, 1] -> 16-bit PCM WAV (clipped, x 32767, truncated)."""
        from scipy.io import wavfile

        clipped = np.clip(waveform, -1.0, 1.0)
        wavfile.write(path, sample_rate, (clipped * 32767).astype(np.int16))

    @staticmethod
    def _save_video(frames: np.ndarray, path: str, fps: int = 8) -> None:
        """(T, H, W, C) frames -> mp4 (mp4v); non-uint8 input is min-max normalized."""
        import cv2

        if frames.dtype != np.uint8:
            lo, hi = float(frames.min()), float(frames.max())
            frames = ((frames - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)
        height, width = frames.shape[1:3]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
        try:
            for frame in frames:
                writer.write(cv2.cvtColor(np.ascontiguousarray(frame[..., :3]), cv2.COLOR_RGB2BGR))
        finally:
            writer.release()

    @staticmethod
    def _save_png(image: np.ndarray, path: str) -> None:
        """(H, W[, C]) image -> 8-bit PNG; non-uint8 input is min-max normalized."""
        if image.dtype != np.uint8:
            lo, hi = float(image.min()), float(image.max())
            image = ((image - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)
        if image.ndim == 3 and image.shape[-1] not in (1, 3, 4):
            image = image[..., :3]
        if image.ndim == 3 and image.shape[-1] == 1:
            image = image[..., 0]
        write_png(path, image)


def write_png(path: str, image: np.ndarray) -> None:
    """uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA -> PNG file (stdlib only)."""
    height, width = image.shape[:2]
    color_type = {2: 0, 3: {3: 2, 4: 6}.get(image.shape[-1])}[image.ndim]
    if color_type is None:
        raise ValueError(f"unsupported image shape {image.shape}")
    rows = np.ascontiguousarray(image, dtype=np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()  # filter 0

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    header = struct.pack(">IIBBBBB", width, height, 8, color_type, 0, 0, 0)
    with open(path, "wb") as handle:
        handle.write(b"\x89PNG\r\n\x1a\n")
        handle.write(chunk(b"IHDR", header))
        handle.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        handle.write(chunk(b"IEND", b""))
