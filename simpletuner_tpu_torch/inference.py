"""Inference runtime: render prompts with Flux on one CUDA device.

Counterpart of ``simpletuner_tpu/inference.py`` (``CheckpointInferenceRuntime``
and ``run_inference``).  It reads the same config keys as the JAX
``inference`` subcommand and runs the JAX runtime's stages as far as the port
has them: the trainer's ``init_preprocessing_models`` (text encoders and the
VAE) and ``init_load_base_model`` (``training/trainer.py``: pretrained BFL or
diffusers safetensors, or seeded weights where ``allow_untrained_init`` or
the tiny preset allows them, with the JAX trainer's refusals), then renders
through the port's validation path: prompts encoded by the attached text
encoders -> flow Euler loop over the Flux DiT (the Hopper flash kernel on the
card) -> VAE decode -> PNG.

Not ported yet, and refused: checkpoints (``--checkpoint``) and families
other than flux (``models/registry.py``).  A ``base_model_precision`` (``model_type=lora``
only) quantizes the base after it is loaded, as the JAX trainer's
``create_train_state`` does, and the render then uses that base dequantized
to bf16 with dense products, as the JAX runtime renders
``TrainState.variables()``.

    python -m simpletuner_tpu_torch.inference --config config.json --prompt "a cat"
"""

from __future__ import annotations

import argparse
import sys
from types import SimpleNamespace
from typing import List, Optional

from .configuration.fields import REGISTRY
from .configuration.loader import load_config, normalize_key
from .models.layers import dequantize_module, quantize_module
from .models.registry import get_model_family
from .training.trainer import Trainer
from .training.validation import Validation


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


class CheckpointInferenceRuntime:
    """Own one model on one device and render many prompts against it."""

    def __init__(
        self,
        config_path: Optional[str] = None,
        output: str = "inference_output",
        config_overrides: Optional[dict] = None,
        device: str = "cuda",
    ) -> None:
        config = load_inference_config(config_path, {**(config_overrides or {}), "output_dir": output})
        self.config = config
        self.output_dir = output
        trainer = Trainer(get_model_family(config), config, device=device)
        trainer.init_preprocessing_models()
        trainer.init_load_base_model()
        self.trainer, self.model, self.device = trainer, trainer.model, trainer.device
        self.module, self.vae = trainer.module.eval(), trainer.vae
        if self.model.base_precision:
            if self.model.lora_rank <= 0:
                raise ValueError("base_model_precision quantization requires model_type=lora (frozen base)")
            # the JAX runtime renders TrainState.variables(): the quantized
            # base dequantized to bf16, with dense products
            dequantize_module(quantize_module(self.module, self.model.base_precision))
        # text encoders stay attached: each render() encodes a fresh prompt
        self._decode_fn = trainer.vae_decode_fn()

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
            self.model, config, decode_fn=self._decode_fn, output_dir=self.output_dir, device=self.device
        )
        validation.precompute_embeds()
        return validation.run_validations(self.module, force=True)


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
