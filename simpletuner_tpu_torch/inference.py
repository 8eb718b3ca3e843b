"""Inference runtime: render prompts with Flux on one CUDA device.

Counterpart of ``simpletuner_tpu/inference.py`` (``CheckpointInferenceRuntime``
and ``run_inference``) without the trainer.  It reads the same config keys as
the JAX ``inference`` subcommand and renders through the port's validation
path: cached prompt embeds -> flow Euler loop over the Flux DiT (the Hopper
flash kernel on the card) -> VAE decode -> PNG.

Not ported yet, and refused: Orbax checkpoints (``--checkpoint``), pretrained
BFL/diffusers weights (``pretrained_model_name_or_path``), the text encoders
(prompt embeds must already be in the text-embed cache), families other than
flux.  Without pretrained weights the model starts from seeded random
initialisation, which ``allow_untrained_init`` must permit, as in the JAX
trainer.  A ``base_model_precision`` (``model_type=lora`` only) quantizes the
base after it is initialised, as the JAX trainer's ``create_train_state``
does, and the render then uses that base dequantized to bf16 with dense
products, as the JAX runtime renders ``TrainState.variables()``.

    python -m simpletuner_tpu_torch.inference --config config.json --prompt "a cat"
"""

from __future__ import annotations

import argparse
import os
import sys
from types import SimpleNamespace
from typing import List, Optional

import torch

from .caching.text_embeds import TextEmbeddingCache
from .configuration.dataloader import load_dataloader_config
from .configuration.fields import REGISTRY
from .configuration.loader import load_config, normalize_key
from .data.backends.local import LocalDataBackend
from .models.flux import Flux
from .models.layers import dequantize_module, init_parameters, quantize_module
from .models.vae import AutoencoderKL, VAEConfig
from .training.validation import Validation, resolve_device

_VAE_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "default": torch.bfloat16,
               "fp16": torch.bfloat16, "float16": torch.bfloat16, "half": torch.bfloat16,
               "fp32": torch.float32, "float32": torch.float32}


def config_namespace(values: dict) -> SimpleNamespace:
    """Registry defaults + ``values``, as attributes: the port's config object.

    The JAX package's ``TrainingConfig`` is not used because its
    cross-validation imports the optimizer registry."""
    merged = dict(REGISTRY.defaults())
    merged.update({normalize_key(k): v for k, v in values.items()})
    if merged.get("mixed_precision") == "no":
        merged["mixed_precision"] = "fp32"
    return SimpleNamespace(**merged)


def load_inference_config(config_path: Optional[str], overrides: Optional[dict] = None) -> SimpleNamespace:
    """Registry defaults + the config file (+ overrides), through the port's
    copy of the JAX package's loader."""
    return config_namespace({**load_config(config_path=config_path), **(overrides or {})})


def text_embed_cache(config, model_type: str) -> TextEmbeddingCache:
    """The default ``text_embeds`` dataset's cache (local storage), else ``cache_dir_text``."""
    datasets = [
        d for d in load_dataloader_config(getattr(config, "data_backend_config", None) or [])
        if d.dataset_type == "text_embeds"
    ]
    if datasets:
        chosen = next((d for d in datasets if d.default), datasets[0])
        if chosen.type != "local":
            raise NotImplementedError(f"text_embeds storage type {chosen.type!r} is not supported by the port")
        cache_dir = chosen.cache_dir or os.path.join(getattr(config, "cache_dir", "cache"), "text", chosen.id)
        ident = chosen.id
    else:
        cache_dir, ident = getattr(config, "cache_dir_text", None) or "cache", "text_embeds"
    backend = LocalDataBackend(ident, compress_cache=bool(getattr(config, "compress_disk_cache", False)))
    return TextEmbeddingCache(id=ident, data_backend=backend, cache_dir=cache_dir, model_type=model_type)


def _check_weights_source(config) -> None:
    pretrained = getattr(config, "pretrained_transformer_model_name_or_path", None) or getattr(
        config, "pretrained_model_name_or_path", None
    )
    if pretrained:
        raise NotImplementedError(
            f"pretrained weights ({pretrained!r}) cannot be loaded yet: BFL/diffusers weight import "
            "is not ported"
        )
    if not (getattr(config, "model_arch_preset", None) == "tiny" or getattr(config, "allow_untrained_init", False)):
        raise ValueError(
            "no pretrained model path configured (pretrained_model_name_or_path / "
            "pretrained_transformer_model_name_or_path); rendering needs base weights — set "
            "allow_untrained_init=true to render from seeded random initialisation"
        )


class CheckpointInferenceRuntime:
    """Own one model on one device and render many prompts against it."""

    def __init__(
        self,
        config_path: Optional[str] = None,
        output: str = "inference_output",
        config_overrides: Optional[dict] = None,
        device: str = "cuda",
    ) -> None:
        config = load_inference_config(config_path, config_overrides)
        family = getattr(config, "model_family", None)
        if family != "flux":
            raise NotImplementedError(f"model_family={family!r} is not ported (only flux)")
        _check_weights_source(config)
        self.config = config
        self.output_dir = output
        self.device = resolve_device(device)
        self.model = Flux(config)
        generator = torch.Generator(device=self.device).manual_seed(int(getattr(config, "seed", 42) or 42))
        with torch.device(self.device):
            self.module = init_parameters(self.model.create_module(), generator).eval()
            if self.model.base_precision:
                if self.model.lora_rank <= 0:
                    raise ValueError("base_model_precision quantization requires model_type=lora (frozen base)")
                # the JAX runtime renders TrainState.variables(): the quantized
                # base dequantized to bf16, with dense products
                dequantize_module(quantize_module(self.module, self.model.base_precision))
            tiny = getattr(config, "model_arch_preset", None) == "tiny"
            vae_dtype = str(getattr(config, "vae_dtype", "bf16") or "bf16").lower()
            if vae_dtype not in _VAE_DTYPES:
                raise ValueError(f"unknown vae_dtype {vae_dtype!r}; use bf16|fp16|fp32|default")
            self.vae = init_parameters(
                AutoencoderKL(VAEConfig.tiny() if tiny else VAEConfig.flux(), _VAE_DTYPES[vae_dtype]),
                generator,
            ).eval()
        self.text_cache = text_embed_cache(config, self.model.NAME)

    def render(
        self,
        prompt: str,
        steps: int = 20,
        resolution: Optional[int] = None,
        seed: Optional[int] = None,
        negative_prompt: Optional[str] = None,
        guidance: Optional[float] = None,
    ) -> List[str]:
        """Render one prompt; returns the output file paths."""
        config = self.config
        config.validation_prompt = prompt
        config.validation_num_inference_steps = steps
        if resolution:
            config.validation_resolution = resolution
        if seed is not None:
            config.validation_seed = seed
        if negative_prompt is not None:
            config.validation_negative_prompt = negative_prompt
        if guidance is not None:
            config.validation_guidance = guidance
        validation = Validation(
            self.model, config, decode_fn=self.vae.decode, output_dir=self.output_dir, device=self.device
        )
        validation.load_embeds(self.text_cache)
        return validation.run_validations(self.module)


def run_inference(
    prompt: str,
    config_path: Optional[str] = None,
    output: str = "inference_output",
    steps: int = 20,
    resolution: Optional[int] = None,
    seed: int = 42,
    device: str = "cuda",
) -> int:
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=output, device=device)
    paths = runtime.render(prompt, steps=steps, resolution=resolution, seed=seed)
    for path in paths:
        print(path)
    return 0 if paths else 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "python -m simpletuner_tpu_torch.inference", description="render images with the torch port"
    )
    parser.add_argument("--config", default=None, help="training config used for the run")
    parser.add_argument("--prompt", required=True)
    parser.add_argument("--output", default="inference_output")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--resolution", type=int, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default="cuda", help="torch device; 'cpu' only for tests")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return run_inference(
        prompt=args.prompt,
        config_path=args.config,
        output=args.output,
        steps=args.steps,
        resolution=args.resolution,
        seed=args.seed,
        device=args.device,
    )


if __name__ == "__main__":
    sys.exit(main())
