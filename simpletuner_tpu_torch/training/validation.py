"""Validation renders: prompt embeds -> flow Euler sampling -> VAE decode -> PNG.

Counterpart of the render path of ``simpletuner_tpu/training/validation.py``
(``build_scheduler``, resolution and seed handling, ``_latent_shape``,
``_render_single``, ``_save_png``).  Prompt embeds come from the text-embed
cache (the text encoders are not ported) and are collated the way the
trainer collates them, so a cached T5 ``attention_mask`` becomes ``t5_masks``.
Noise comes from a ``torch.Generator`` seeded from ``validation_seed`` and the
prompt index.  Previews, img2img, adapter sweeps, benchmarks, video/audio and
trackers are not ported.  PNGs are written with ``zlib``/``struct`` alone.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..schedulers import FlowMatchEulerScheduler, classifier_free_guidance, sample_loop


def build_scheduler(model, num_steps: int, image_seq_len: Optional[int] = None):
    """Per-family inference scheduler; only the flow-matching branch is ported."""
    if not model.is_flow:
        raise NotImplementedError(f"{model.prediction_type} schedulers are not ported")
    shift = getattr(model.config, "validation_noise_scheduler_shift", None)
    use_dyn = bool(getattr(model.config, "flow_schedule_auto_shift", False))
    return FlowMatchEulerScheduler.create(
        num_steps,
        shift=shift if shift is not None else 3.0,
        use_dynamic_shifting=use_dyn,
        image_seq_len=image_seq_len,
    )


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
        device: torch.device = torch.device("cpu"),
    ):
        self.model = model
        self.config = config
        self.decode_fn = decode_fn
        self.output_dir = output_dir
        self.device = torch.device(device)
        raw = getattr(config, "validation_prompt", None)
        self.prompts: List[str] = ([raw] if isinstance(raw, str) else list(raw)) if raw else []
        self._embeds: List[Dict[str, np.ndarray]] = []
        self._negative_embeds: Optional[Dict[str, np.ndarray]] = None

        self.num_steps = int(getattr(config, "validation_num_inference_steps", 20) or 20)
        raw_res = getattr(config, "validation_resolution", None) or getattr(config, "resolution", 512) or 512
        if isinstance(raw_res, str) and "x" in raw_res:  # reference "WxH" format
            raw_res = raw_res.split("x")[0]
        self.resolution = int(float(raw_res))
        self.seed = int(getattr(config, "validation_seed", None) or getattr(config, "seed", 42) or 42)

    # ---- embeds --------------------------------------------------------------------------
    def load_embeds(self, text_cache) -> None:
        """Fetch every prompt's embeds (and the negative prompt's, for true CFG)
        from a ``TextEmbeddingCache``; a prompt that is not cached raises."""

        def fetch(prompt: str) -> Dict[str, np.ndarray]:
            if not text_cache.exists(prompt):
                raise FileNotFoundError(
                    f"no cached text embeds for prompt {prompt!r} at {text_cache.cache_path(prompt)}"
                )
            return text_cache.load(prompt)

        self._embeds = [fetch(prompt) for prompt in self.prompts]
        if self._wants_cfg():
            self._negative_embeds = fetch(str(getattr(self.config, "validation_negative_prompt", "") or ""))

    def _wants_cfg(self) -> bool:
        """True CFG (two forward passes) for families without guidance embeds."""
        guidance = float(getattr(self.config, "validation_guidance", 0.0) or 0.0)
        has_guidance_embed = bool(getattr(getattr(self.model, "arch", None), "guidance_embed", False))
        return guidance > 1.0 and not has_guidance_embed

    # ---- run -------------------------------------------------------------------------------
    def _latent_shape(self, batch_size: int):
        factor = 8 if getattr(self.model, "REQUIRES_VAE", True) else 1
        size = self.resolution // factor
        return (batch_size, size, size, self.model.latent_channels)

    def run_validations(self, module: nn.Module, step: int = 0) -> List[str]:
        """Render every prompt; returns the saved PNG paths."""
        paths = []
        for index, embeds in enumerate(self._embeds):
            image = self._render_single(module, embeds, index)
            filename = os.path.join(self.output_dir, "validation", f"step_{step}_{index}.png")
            os.makedirs(os.path.dirname(filename), exist_ok=True)
            self._save_png(image, filename)
            paths.append(filename)
        return paths

    def _batch(self, embeds: Dict[str, np.ndarray], latent_shape) -> Dict[str, torch.Tensor]:
        batch = {"latents": torch.zeros(latent_shape, dtype=torch.float32, device=self.device)}
        for key, value in self.model.collate_text_embeds([embeds]).items():
            batch[key] = torch.as_tensor(value, device=self.device)
        return batch

    @torch.no_grad()
    def _render_single(self, module: nn.Module, embeds: Dict[str, np.ndarray], index: int) -> np.ndarray:
        latent_shape = self._latent_shape(1)
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
            rescale = float(getattr(self.config, "validation_guidance_rescale", 0.0) or 0.0)

            def denoise(latents, t):
                return classifier_free_guidance(cond_fn(latents, t), uncond_fn(latents, t), scale, rescale)

        noise = torch.randn(latent_shape, generator=noise_generator(self.seed, index), dtype=torch.float32)
        latents = sample_loop(scheduler, denoise, noise.to(self.device))
        if self.decode_fn is None:
            return latents[0].cpu().numpy()
        scaling = self.model.VAE_SCALING_FACTOR or 1.0
        shift = self.model.VAE_SHIFT_FACTOR or 0.0
        out = self.decode_fn(latents / scaling + shift)[0].to(torch.float32)
        return ((out + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()

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
