"""The trainer's preprocessing stages: text encoders, the VAE and the base weights.

Counterpart of the first stages of ``simpletuner_tpu/training/trainer.py``:
``init_preprocessing_models`` (:178-223: the text encoders,
``text_encoder_precision``, ``tokenizer_max_length``), ``_vae_dtype``
(:225-237), ``_init_vae`` (:239-296, the image VAE), ``_vae_encode_fn``
(:298-335: uint8 pixels normalized on the device, f32 latents),
``vae_decode_fn``, and the weight load of ``init_load_base_model``
(:540-565) with its refusals.  Everything lives on one device, ``cuda``
unless the caller asks for the CPU.  The rest of the trainer (data plane,
adapters, optimizer, checkpoints, the loop) is ROADMAP Queue 1 item 4.

Where the JAX stage draws random weights from ``jax.random`` keys, the port
draws from ``torch.Generator``s: the base from ``seed``, the VAE and the tiny
text encoders from 0.  Half-precision text encoders are bf16 in the port
(``fp16`` included), since the port's encoders compute in their weights'
dtype and T5 overflows fp16.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..models.layers import init_adapters, init_parameters
from ..models.text_encoders import load_text_encoders
from ..models.vae import AutoencoderKL, VAEConfig
from ..models.vae_import import load_vae_params
from ..models.weight_bridge import load_flax_params
from ..models.weight_import import load_transformer_params
from .validation import resolve_device

_VAE_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "default": torch.bfloat16,
               "fp16": torch.bfloat16, "float16": torch.bfloat16, "half": torch.bfloat16,
               "fp32": torch.float32, "float32": torch.float32}


def vae_encode_fn(vae: AutoencoderKL, device: torch.device) -> Callable[[np.ndarray, int], torch.Tensor]:
    """The caching pass's encoder: images (B, H, W, 3) -> f32 latents on the
    device, unfetched (the cache's writer threads fetch them).  uint8 pixels
    cross to the device as they are and are normalized there (exact in f32);
    float images cross in f32."""

    @torch.no_grad()
    def encode(images: np.ndarray, count: int) -> torch.Tensor:
        pixels = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        if images.dtype == np.uint8:
            pixels = pixels.to(torch.float32) / 127.5 - 1.0
        return vae.encode(pixels.to(torch.float32)).to(torch.float32)

    encode.handles_uint8 = True
    return encode


class Trainer:
    """The preprocessing stages of the JAX ``Trainer`` over one model family."""

    def __init__(self, model, config, device="cuda") -> None:
        self.model = model
        self.config = config
        self.device = resolve_device(device)
        self.seed = int(getattr(config, "seed", 42) or 42)
        self.vae: Optional[AutoencoderKL] = None
        self.module: Optional[torch.nn.Module] = None

    def _get(self, key: str, default=None):
        return getattr(self.config, key, default)

    def _allow_untrained(self) -> bool:
        return self._get("model_arch_preset") == "tiny" or bool(self._get("allow_untrained_init"))

    # ---- text encoders and the VAE ----------------------------------------------------------
    def init_preprocessing_models(self) -> None:
        """Load the text encoders and the VAE for the caching passes."""
        tiny = self._get("model_arch_preset") == "tiny"
        te_path = self._get("pretrained_text_encoder_model_name_or_path") or self._get("pretrained_model_name_or_path")
        if not tiny and te_path is None and not self._allow_untrained():
            raise ValueError(
                "no text-encoder path configured (pretrained_model_name_or_path); random-weight text "
                "encoders produce garbage conditioning — set allow_untrained_init=true only for "
                "from-scratch runs"
            )
        specs = self.model.TEXT_ENCODER_CONFIGURATION
        max_len = self._get("tokenizer_max_length")
        if max_len:
            specs = tuple(dataclasses.replace(s, max_length=int(max_len)) for s in specs)
        encoders = load_text_encoders(specs, pretrained_path=te_path, tiny=tiny, device=self.device)
        te_precision = (self._get("text_encoder_precision") or "").lower()
        if te_precision in ("bf16", "bfloat16", "fp16", "float16"):
            for encoder in encoders:
                encoder.model.to(torch.bfloat16)
        elif te_precision and te_precision not in ("no_change", "fp32", "float32"):
            raise ValueError(f"text_encoder_precision {te_precision!r} unsupported; use bf16, fp16, or no_change")
        self.model.attach_text_encoders(encoders)
        self._init_vae(tiny)

    def _vae_dtype(self) -> torch.dtype:
        """Compute dtype of the VAE (``vae_dtype``, default bf16; fp16 maps to bf16)."""
        raw = str(self._get("vae_dtype", "bf16") or "bf16").lower()
        if raw not in _VAE_DTYPES:
            raise ValueError(f"unknown vae_dtype {raw!r}; use bf16|fp16|fp32|default")
        return _VAE_DTYPES[raw]

    def _init_vae(self, tiny: bool) -> None:
        if not getattr(self.model, "REQUIRES_VAE", True) or getattr(self.model, "MODALITY", "image") != "image":
            raise NotImplementedError(f"{self.model.NAME}: only the image VAE is ported")
        if tiny:
            vae_config = VAEConfig.tiny()
        elif self.model.LATENT_CHANNEL_COUNT >= 16:
            vae_config = VAEConfig.flux()
        elif self.model.NAME in ("sdxl", "kolors"):
            vae_config = VAEConfig.sdxl()
        else:
            vae_config = VAEConfig()
        with torch.device(self.device):
            vae = AutoencoderKL(vae_config, self._vae_dtype())
        vae_path = self._get("pretrained_vae_model_name_or_path")
        base_path = self._get("pretrained_model_name_or_path")
        if not vae_path and base_path and os.path.isdir(os.path.join(str(base_path), "vae")):
            vae_path = os.path.join(str(base_path), "vae")
        if vae_path and os.path.exists(str(vae_path)):
            load_flax_params(vae, load_vae_params(vae, str(vae_path))["params"])
        elif not self._allow_untrained():
            raise ValueError(
                f"VAE weights not found (pretrained_vae_model_name_or_path={vae_path!r}); a random VAE "
                "caches garbage latents — set allow_untrained_init=true only for from-scratch runs"
            )
        else:
            init_parameters(vae, torch.Generator(device=self.device).manual_seed(0))
        self.vae = vae.eval()

    def _vae_encode_fn(self) -> Callable[[np.ndarray, int], torch.Tensor]:
        return vae_encode_fn(self.vae, self.device)

    def vae_decode_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        vae = self.vae
        return lambda latents: vae.decode(latents)

    # ---- base weights ------------------------------------------------------------------------
    def _resolve_pretrained_transformer(self) -> Optional[str]:
        for key in (
            "pretrained_transformer_model_name_or_path",
            "pretrained_transformer_path",
            "pretrained_unet_model_name_or_path",
            "pretrained_model_name_or_path",
        ):
            value = self._get(key)
            if value:
                return str(value)
        return None

    def init_load_base_model(self) -> None:
        """The family's module on the device, from the pretrained checkpoint
        or, where untrained weights are allowed, from seeded initialisation."""
        pretrained = self._resolve_pretrained_transformer()
        found = bool(pretrained) and os.path.exists(pretrained)
        if not found and pretrained and not self._allow_untrained():
            raise FileNotFoundError(
                f"pretrained model path {pretrained!r} does not exist; refusing to train from random init "
                "(set allow_untrained_init=true to pretrain from scratch)"
            )
        if pretrained is None and not self._allow_untrained():
            raise ValueError(
                "no pretrained model path configured (pretrained_model_name_or_path / "
                "pretrained_transformer_model_name_or_path); a fine-tuning run needs base weights — set "
                "allow_untrained_init=true only for from-scratch pretraining"
            )
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        with torch.device(self.device):
            module = self.model.create_module()
        if found:
            load_transformer_params(self.model, init_adapters(module, generator), pretrained)
        else:
            init_parameters(module, generator)
        self.module = module
