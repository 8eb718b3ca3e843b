"""Checkpoint inference: render prompts from a trained checkpoint on one device.

Counterpart of ``simpletuner_tpu/inference.py`` (``CheckpointInferenceRuntime``
and ``run_inference``).  The config is read with ``TrainingConfig.from_file``
and the checkpoint taken as the JAX runtime takes it: ``resume_from_checkpoint``
(a checkpoint directory, ``latest``, or None for the base as loaded),
``max_train_steps: 0``, ``output_dir`` and ``report_to: none``.  Then the port
``Trainer``'s stages run in the JAX order on ``device`` (``cuda`` unless the
caller asks for the CPU):

* ``run_inference``: ``configure_webhook``, ``init_seed``,
  ``init_preprocessing_models``, ``init_data_backend`` (when the config sets a
  ``data_backend_config``, or the default one exists), ``init_validations``,
  ``init_unload_text_encoder``,
  ``init_load_base_model``, ``init_trainable_peft_adapter``,
  ``init_ema_model``, ``resume_and_prepare``, then one forced validation pass
  (``run_validations(..., force=True)``) over ``train_state.render_view``, as
  the trainer's own validation renders: the prompt encoded by the text
  encoders -> the family's sampling loop (flow Euler over Flux's, SD3's or
  AuraFlow's DiT, DDIM or UniPC over the SDXL, SD 1.x / 2.x UNets and PixArt-Sigma's
  DiT, flow Euler over Wan's video DiT; the Hopper flash kernel on the card;
  every family but Flux with true CFG when ``validation_guidance`` > 1) -> VAE
  decode -> PNG (a video family: the video VAE's decode -> mp4);
* ``CheckpointInferenceRuntime``: the same stages without the data plane and
  the validation stages, so the text encoders stay attached and each
  ``render()`` encodes a fresh prompt.

A checkpoint written with ``checkpoint_frozen_base: reference`` restores
against the base the config loads (its source and checksum are checked).  A
quantized base (``base_model_precision``, ``model_type=lora`` only) is stored
quantized by ``create_train_state`` and rendered dequantized to bf16 with
dense products, as the JAX runtime renders ``TrainState.variables()``.  A
full model (``model_type`` other than ``lora``) without a checkpoint renders
the loaded base as it is: its train state would only add an optimizer state
that a render never reads, and the port trains no full model (ROADMAP Queue 1
item 7), so no full checkpoint exists to restore.  Families other than flux,
sd3, sdxl, sd1x, sd2x, pixart_sigma, auraflow, wan, ltxvideo, chroma, lumina2,
kandinsky5_image, kandinsky5_video, hunyuanvideo, qwen_image, mageflow, z_image,
hidream, flux2, kolors, longcat_image, z_image_omni, zlab_i1 and boogu_image are refused
(``models/registry.py``).

    python -m simpletuner_tpu_torch.inference --config config.json --prompt "a cat" \
        [--checkpoint output/checkpoint-8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
from types import SimpleNamespace
from typing import List, Optional

import torch

from .configuration.args import TrainingConfig
from .configuration.fields import REGISTRY
from .configuration.loader import load_config, normalize_key
from .training.train_state import render_view
from .training.trainer import Trainer
from .training.validation import Validation

logger = logging.getLogger(__name__)


def config_namespace(values: dict) -> SimpleNamespace:
    """Registry defaults + ``values``, as attributes: a plain config object
    for building a model family directly (the bench, tests)."""
    merged = dict(REGISTRY.defaults())
    merged.update({normalize_key(k): v for k, v in values.items()})
    if merged.get("mixed_precision") == "no":
        merged["mixed_precision"] = "fp32"
    return SimpleNamespace(**merged)


def load_inference_config(config_path: Optional[str], overrides: Optional[dict] = None) -> SimpleNamespace:
    """Registry defaults + the config file (+ overrides), through the port's
    copy of the JAX package's loader."""
    return config_namespace({**load_config(config_path=config_path), **(overrides or {})})


def _checkpoint_config(config_path: Optional[str], checkpoint: Optional[str], output: str,
                       overrides: dict) -> TrainingConfig:
    config = TrainingConfig.from_file(config_path)
    if checkpoint and checkpoint not in ("latest", "none", "false"):
        if not os.path.isdir(checkpoint):
            raise FileNotFoundError(f"checkpoint directory {checkpoint!r} does not exist")
        checkpoint = os.path.abspath(checkpoint)
    values = {
        "resume_from_checkpoint": checkpoint,
        "max_train_steps": 0,  # no training; the lifecycle stops before the loop
        "output_dir": output,
        "report_to": "none",
        **overrides,
    }
    for key, value in values.items():
        setattr(config, key, value)
    return config


def _prepare(trainer: Trainer, checkpoint: Optional[str]) -> None:
    """The stages from the base load to the resume."""
    trainer.init_load_base_model()
    if trainer.model.lora_rank <= 0 and checkpoint is None:
        if trainer.model.base_precision:
            raise ValueError("base_model_precision quantization requires model_type=lora (frozen base)")
        return  # the loaded base renders as it is
    trainer.init_trainable_peft_adapter()
    trainer.init_ema_model()
    trainer.resume_and_prepare()


def _render_module(trainer: Trainer):
    """The module a render uses, for the duration of a ``with``: the train
    state's ``render_view``, or the loaded base when there is no state."""
    if trainer._state is None:
        return contextlib.nullcontext(trainer.module)
    return render_view(trainer._state)


class CheckpointInferenceRuntime:
    """Own one loaded checkpoint and render many prompts against it."""

    def __init__(
        self,
        checkpoint: Optional[str] = None,
        config_path: Optional[str] = None,
        output: str = "inference_output",
        config_overrides: Optional[dict] = None,
        device: str = "cuda",
    ) -> None:
        overrides = {"push_to_hub": False, "gradient_checkpointing": False, **(config_overrides or {})}
        config = _checkpoint_config(config_path, checkpoint, output, overrides)
        self.config = config
        self.output_dir = output
        trainer = Trainer(config=config, device=device)
        trainer.configure_webhook()
        trainer.init_seed()
        trainer.init_preprocessing_models()
        # no data plane at inference time: the runtime only renders
        _prepare(trainer, checkpoint)
        self.trainer, self.model, self.device = trainer, trainer.model, trainer.device
        self.vae = trainer.vae
        self.module = trainer.module.eval()
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
            self.model, config, decode_fn=self._decode_fn, output_dir=self.output_dir,
            webhook_handler=self.trainer.webhook_handler, device=self.device,
        )
        validation.precompute_embeds()
        with _render_module(self.trainer) as module:
            return validation.run_validations(module, self.trainer.global_step, force=True)


def run_inference(
    prompt: str,
    checkpoint: Optional[str] = None,
    config_path: Optional[str] = None,
    output: str = "inference_output",
    steps: int = 20,
    resolution: Optional[int] = None,
    seed: int = 42,
    device: str = "cuda",
) -> int:
    overrides = {
        "validation_prompt": prompt,
        "validation_num_inference_steps": steps,
        "validation_seed": seed,
    }
    if resolution:
        overrides["validation_resolution"] = resolution
    config = _checkpoint_config(config_path, checkpoint, output, overrides)

    trainer = Trainer(config=config, device=device)
    trainer.configure_webhook()
    trainer.init_seed()
    trainer.init_preprocessing_models()
    # the registry's default dataloader path counts only where the file exists
    # (the JAX runtime fails on a config without a dataloader instead)
    dataloader = config.get("data_backend_config")
    if dataloader and (config.was_provided("data_backend_config") or os.path.exists(str(dataloader))):
        trainer.init_data_backend()
    trainer.init_validations()
    trainer.init_unload_text_encoder()
    _prepare(trainer, checkpoint)
    with _render_module(trainer) as module:
        paths = trainer.validation.run_validations(module, trainer.global_step, force=True)
    if trainer.device.type == "cuda":
        logger.info("peak device memory: %.3f GiB", torch.cuda.max_memory_allocated(trainer.device) / 2**30)
    for path in paths:
        print(path)
    return 0 if paths else 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "python -m simpletuner_tpu_torch.inference", description="render images with the torch port"
    )
    parser.add_argument("--checkpoint", default=None, help="checkpoint dir (output of training); none: the base")
    parser.add_argument("--config", default=None, help="training config used for the run")
    parser.add_argument("--prompt", required=True)
    parser.add_argument("--output", default="inference_output")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--resolution", type=int, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default="cuda", help="torch device; 'cpu' only for tests")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    from .train import configure_logging

    args = build_parser().parse_args(argv)
    configure_logging()
    return run_inference(
        prompt=args.prompt,
        checkpoint=args.checkpoint,
        config_path=args.config,
        output=args.output,
        steps=args.steps,
        resolution=args.resolution,
        seed=args.seed,
        device=args.device,
    )


if __name__ == "__main__":
    sys.exit(main())
