"""Trainer: the imperative shell around the train step.

Counterpart of ``simpletuner_tpu/training/trainer.py``: the same lifecycle
stages in the same order (each emits a lifecycle webhook event), on one
device, ``cuda`` unless the caller asks for the CPU:

* ``configure_webhook``, ``init_seed``;
* ``init_preprocessing_models``: the text encoders (``text_encoder_precision``,
  ``tokenizer_max_length``) and the VAE (``vae_dtype``; uint8 pixels
  normalized on the device, f32 latents; a video family's causal video VAE
  and an audio family's 1-D audio VAE, seeded, bf16, as the JAX trainer
  builds them);
* ``init_data_backend``: the data plane (``data/factory.py``) with both
  caching passes;
* ``init_validations`` (prompt embeds while the encoders live, and the eval
  loss over the eval split, ``training/evaluation.py``),
  ``init_unload_text_encoder`` (drops them and returns their device memory);
* ``init_load_base_model``: the module from the pretrained checkpoint (BFL or
  diffusers safetensors) or, where allowed, seeded weights;
* ``init_trainable_peft_adapter`` (``init_lora`` warm start),
  ``init_ema_model``;
* ``resume_and_prepare``: steps from ``num_train_epochs``, the schedule and
  optimizer, ``create_train_state`` (a quantized base is stored quantized),
  the step, and the resume (state restored in place, data plane cursor);
* ``init_benchmark_base_model``, ``init_trackers``, ``init_huggingface_hub``;
* ``train``: the loop with epoch-rollover and interval / rolling
  checkpoints, logging, status webhooks, the eval loss every
  ``eval_steps_interval`` steps (logged as ``eval_loss`` to every tracker),
  validation (with the EMA comparison pass), the final checkpoint, validation
  and model card, and the SIGTERM preemption checkpoint.

On the card each batch shape's step is captured once as a CUDA graph
(``jit_train_step``), all over the one train state and one memory pool; on
the CPU the step runs eagerly.  The random numbers of step ``n`` come from a
generator seeded from (``seed``, ``n``) just before the step
(:func:`step_seed`), as the JAX loop folds ``global_step`` into its key, so a
resumed run draws what the straight run drew.

Where the JAX stage draws random weights from ``jax.random`` keys, the port
draws from ``torch.Generator``s: the base from ``seed``, the VAE and the tiny
text encoders from 0.  Half-precision text encoders are bf16 in the port
(``fp16`` included), since the port's encoders compute in their weights'
dtype and T5 overflows fp16.  The families are ``flux``, ``sd3``, ``sdxl``
(the 4-channel ``VAEConfig.sdxl()`` VAE, its two CLIP encoders and the DDPM
epsilon / v path), ``sd1x`` and ``sd2x`` (one CLIP encoder, the SD VAE, epsilon
and v-prediction), ``pixart_sigma`` (T5-XXL at 300 tokens, epsilon) and
``auraflow`` (Pile-T5 at 256 tokens, flow matching; both with the SD
``VAEConfig()``, as the JAX trainer builds it for every 4-channel family but
sdxl and kolors), ``wan`` (umT5 at 512 tokens, the video VAE, 5-D
latents; each video bucket, whose key carries the frame count, is one batch
shape and so one captured graph), ``ltxvideo`` (T5-XXL at 128 tokens, the
video VAE at LTX's config, per-frame timesteps (B, T) from its
``prepare_batch``, static per bucket), ``chroma`` (Flux's path with T5-XXL
only and zero pooled embeds), ``lumina2`` (Gemma-2 at 256 tokens through
the decoder-LLM encoder, the caption mask as ``text_attention_mask``; both
with the 16-channel ``VAEConfig.flux()``), ``kandinsky5_image`` and
``kandinsky5_video`` (Qwen2.5-VL at 512 tokens and CLIP-L pooled, 4 latent
channels: the SD ``VAEConfig()`` for the image flavour, the video VAE at 4
latents for the video flavour) and ``hunyuanvideo`` (Qwen2.5-VL at 256 and
ByT5 at 77 tokens, both masks, the video VAE at 32 latents), ``qwen_image`` (Qwen2.5-VL
at 1024 tokens, the mask dropped), ``z_image`` and ``mageflow`` (Qwen at 4096
tokens on the Qwen-Image DiT without text rope; MageFlow's 32 latent channels
meet the 16-channel Flux VAE, as in the JAX trainer) and ``hidream`` (CLIP-L and
CLIP-G pooled, T5-XXL and Llama-3 at 128 tokens; ``moe_gate_loss`` logged at
every step), all four with ``VAEConfig.flux()``, ``flux2`` (Mistral-3 at 512
tokens, its taps side by side; ``VAEConfig.flux()`` as in the JAX trainer, whose
16 channels the published 32-channel arch cannot take: only the tiny preset
trains), ``kolors`` (ChatGLM at 256 tokens with its pooled vector, SDXL's
VAE and DDPM path), ``longcat_image`` (Qwen2.5-VL at 512 tokens inside its
captioning template, the template's spans sliced off; the sliding ids),
``z_image_omni`` (Qwen at 512 tokens with its mask), ``boogu_image``
(Lumina2's) and ``zlab_i1`` (Gemma-2 at 256 tokens with its mask; 32 latent
channels against ``VAEConfig.flux()``, as the JAX trainer, so only its tiny
preset trains), the four with ``VAEConfig.flux()`` at their published widths,
``krea2`` (12 taps of the qwen2.5-vl trunk at 512 tokens with the mask),
``cosmos`` (T5 at 512 tokens, the states past the mask zeroed and the mask
dropped; EDM x0 prediction with its own ``prepare_batch`` and loss) and
``anima`` (Qwen at 256 tokens and 64 T5 ids), the three with
``VAEConfig.flux()`` (every family of 16 channels or more, as the JAX
trainer builds it, though Cosmos's docstring names the Wan VAE),
``omnigen`` (no text encoder: the cache holds its own Phi-3 ids and mask;
the SD ``VAEConfig()``), ``ernie`` (the qwen2.5 final-norm states at 512
tokens with the mask) and ``ideogram`` (13 taps of the qwen2.5-vl trunk side
by side, with the mask), the last two at 32 latent channels against
``VAEConfig.flux()``, as the JAX trainer, so only their tiny presets train,
``longcat_video`` (T5-XXL at 512 tokens with the mask) and ``sanavideo``
(Gemma-2 at 300 tokens with the mask), both on clips through the video VAE at
16 latent channels, and ``sana`` (Gemma-2 at 300 tokens, the mask dropped; 32
latent channels against ``VAEConfig.flux()``, so only its tiny preset trains),
and ``ltxvideo2`` (Gemma-2 at 256 tokens tiled to 3840, the mask dropped, on
clips through the video VAE at 128 latent channels; one zero audio token, as
no data path gives audio latents; ``init_validations`` also encodes and
installs the IC-LoRA reference video of ``validation_ltx2_video_conditioning``),
``ace_step`` (umT5 at 256 tokens, stereo waveforms through the audio VAE into
(B, S, 8) latents, the lyric ids of each clip's ``.lyrics.txt`` sidecar) and
``wan_s2v`` (Wan's path with each clip's same-stem WAV as ``audio_embeds``);
the batch reaches the step with every numeric array
the family's collate gives (Flux's ``t5_embeds``/``t5_masks``, the others'
``text_embeds``, SDXL's size conditioning ``original_sizes``,
``crop_coordinates`` and ``target_sizes``), and ``pooled_embeds`` for flux,
sd3 and sdxl.  Refused, each naming its ROADMAP item:
families other than these thirty-six, full fine-tunes and ControlNet, distillation and
ODE pairs, CREPA / U-REPA, text-encoder training, slider and assistant
adapters, a mesh of more than one device and multi-process runs.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import logging
import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..configuration.args import TrainingConfig
from ..data.bucket_report import data_plane_report, format_report
from ..data.factory import configure_multi_databackend
from ..models.audio_vae import AudioAutoencoderKL
from ..models.layers import init_adapters, init_parameters
from ..models.registry import get_model_family
from ..models.text_encoders import load_text_encoders
from ..models.vae import AutoencoderKL, VAEConfig
from ..models.video_vae import VideoAutoencoderKL
from ..models.vae_import import load_vae_params
from ..models.weight_bridge import load_flax_params
from ..models.weight_import import load_transformer_params
from ..publishing import PublishingManager, safetensors_modelspec
from ..webhooks import WebhookHandler, lifecycle_stage_event, training_status_event
from ..webhooks.events import checkpoint_event, device_fault_event, error_event
from ..webhooks.handler import WebhookConfig
from .checkpoints import CheckpointManager
from .ema import EMAConfig
from .evaluation import EvalLoss
from .iteration_tracker import IterationTracker
from .lora import load_lora_safetensors, save_lora_safetensors
from .optimizers import get_optimizer
from .profiling import DiskGuard, ProfilerSession
from .schedules import get_lr_schedule
from .trackers import build_trackers
from .train_state import build_train_step, create_train_state, jit_train_step, render_view
from .validation import Validation, resolve_device

logger = logging.getLogger(__name__)

# the methods run() calls, in the JAX order (trainer.py:1567-1584)
RUN_ORDER = (
    "configure_webhook", "init_seed", "init_preprocessing_models", "init_data_backend", "init_validations",
    "init_unload_text_encoder", "init_load_base_model", "init_trainable_peft_adapter", "init_ema_model",
    "init_distillation", "init_crepa", "resume_and_prepare", "init_benchmark_base_model", "init_trackers",
    "init_huggingface_hub", "train",
)

_VAE_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "default": torch.bfloat16,
               "fp16": torch.bfloat16, "float16": torch.bfloat16, "half": torch.bfloat16,
               "fp32": torch.float32, "float32": torch.float32}

# training options the port refuses, with the ROADMAP item that queues each
_UNPORTED_OPTIONS = (
    ("distillation_method", "distillation", "Queue 1 item 4g"),
    ("distillation_config", "distillation", "Queue 1 item 4g"),
    ("crepa_enabled", "CREPA", "Queue 1 item 4h"),
    ("urepa_enabled", "U-REPA", "Queue 1 item 4h"),
    ("train_text_encoder", "text-encoder training", "Queue 1 item 4i"),
    ("slider_positive_prompt", "slider training", "Queue 1 item 7"),
    ("slider_negative_prompt", "slider training", "Queue 1 item 7"),
    ("assistant_lora_path", "the assistant adapter", "Queue 1 item 7"),
    ("controlnet", "ControlNet", "Queue 1 item 7"),
    ("push_to_hub", "hub upload", "Queue 1 item 4j"),
    ("push_checkpoints_to_hub", "hub upload", "Queue 1 item 4j"),
    ("fsdp", "a device mesh", "Queue 1 item 5"),
    ("dp_replicate_size", "a device mesh", "Queue 1 item 5"),
)


def check_resume_family(resume_path: str, family: str) -> None:
    """Refuse cross-family resume before touching tensors."""
    state_json = os.path.join(resume_path, "trainer_state.json")
    if not os.path.exists(state_json):
        return
    with open(state_json) as handle:
        saved_family = json.load(handle).get("model_family")
    if saved_family and saved_family != family:
        raise ValueError(
            f"checkpoint {resume_path} was written by model_family="
            f"{saved_family!r} but this run trains {family!r}; "
            "use a fresh output_dir or pass resume_from_checkpoint=none"
        )


def step_seed(seed: int, step: int) -> int:
    """The generator seed of train step ``step``: a function of (seed, step)
    alone, as the JAX loop's ``fold_in(fold_in(rng, 0xBEEF), global_step)``."""
    return ((int(seed) * 1_000_003 + 0xBEEF) * 1_000_033 + int(step)) % 2**63


def vae_encode_fn(vae: nn.Module, device: torch.device,
                  transfer_dtype: torch.dtype = torch.float32) -> Callable[[np.ndarray, int], torch.Tensor]:
    """The caching pass's encoder: images (B, H, W, 3), clips (B, T, H, W, 3)
    through the video VAE, or waveforms (B, S, C) through the audio VAE, ->
    f32 latents on the device, unfetched (the cache's writer threads fetch
    them).  uint8 pixels cross to the device as they are and are normalized
    there (exact in f32); float images cross in f32, waveforms in
    ``transfer_dtype`` (the JAX trainer stages them in f16 under a bf16
    ``vae_dtype``)."""

    @torch.no_grad()
    def encode(images: np.ndarray, count: int) -> torch.Tensor:
        if isinstance(vae, AudioAutoencoderKL):
            channels = vae.config.in_channels
            if images.shape[-1] != channels:
                raise ValueError(f"the audio VAE takes {channels}-channel waveforms; a batch of {images.shape[-1]}-"
                                 f"channel files (a {'mono' if images.shape[-1] == 1 else 'multi-channel'} file) "
                                 "cannot be encoded: convert the dataset's files to the VAE's channels")
            staged = torch.from_numpy(np.ascontiguousarray(images)).to(transfer_dtype).to(device)
            return vae.encode(staged.to(torch.float32)).to(torch.float32)
        pixels = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        if images.dtype == np.uint8:
            pixels = pixels.to(torch.float32) / 127.5 - 1.0
        return vae.encode(pixels.to(torch.float32)).to(torch.float32)

    encode.handles_uint8 = True
    return encode


def _file_fingerprint(path: str) -> Dict[str, Any]:
    """A pretrained checkpoint's identity: its absolute path, total size and
    latest modification time (a directory's files together)."""
    files = [path] if os.path.isfile(path) else [os.path.join(root, name) for root, _, names in os.walk(path)
                                                 for name in names]
    stats = [os.stat(f) for f in files]
    return {"path": os.path.abspath(path), "bytes": sum(s.st_size for s in stats),
            "mtime_ns": max(s.st_mtime_ns for s in stats)}


def _as_config(config) -> TrainingConfig:
    if config is None or isinstance(config, TrainingConfig):
        return config
    return TrainingConfig(dict(config) if isinstance(config, dict) else dict(vars(config)))


class Trainer:
    """The JAX ``Trainer`` over one device.  ``model`` is built from the
    config (``models/registry.py``) unless the caller passes one; ``config``
    is a ``TrainingConfig``, a dict or an attribute namespace, or it is read
    from ``config_path``."""

    def __init__(
        self,
        model=None,
        config=None,
        device="cuda",
        config_path: Optional[str] = None,
        job_id: Optional[str] = None,
        exit_on_error: bool = False,
    ) -> None:
        if config is None:
            config = model.config if model is not None else TrainingConfig.from_file(config_path)
        self.config = _as_config(config)
        self.model = model if model is not None else get_model_family(self.config)
        self.device = resolve_device(device)
        self.job_id = job_id
        self.exit_on_error = exit_on_error
        self.seed = int(self.config.get("seed", 42) or 42)
        self.webhook_handler = WebhookHandler()
        if int(self.config.get("tensor_parallel_size", 1) or 1) != 1 or \
                int(self.config.get("context_parallel_size", 1) or 1) != 1:
            raise NotImplementedError("tensor / context parallelism is not ported (ROADMAP Queue 1 item 5)")
        mechanism = self.config.get("attention_mechanism")
        if mechanism and mechanism != "auto":
            from ..ops.attention import set_attention_backend

            set_attention_backend(str(mechanism))
        self.global_step = 0
        self.epoch = 0
        self.grad_accum_steps = int(self.config.get("gradient_accumulation_steps", 1) or 1)
        self.data_plane = None
        self.vae: Optional[nn.Module] = None  # AutoencoderKL or VideoAutoencoderKL
        self.module: Optional[torch.nn.Module] = None
        self.validation: Optional[Validation] = None
        self.eval_loss: Optional[EvalLoss] = None
        self.trackers: List = []
        self.iteration_tracker = IterationTracker()
        self.should_abort = False
        self.publishing: Optional[PublishingManager] = None
        self._state = None
        self._step_fn = None
        self._graphs: Dict[Any, Any] = {}
        self._graph_pool = None
        self._graph_stream = None
        self._consumed_iter_state = None
        self._frozen_source: Optional[Dict[str, Any]] = None
        self.output_dir = self.config.get("output_dir", "output") or "output"
        self._checkpoint_manager: Optional[CheckpointManager] = None
        # what the stages, captures and validation passes took (the card's
        # numbers for the chip smoke and the logs)
        self.stage_report: Dict[str, Dict[str, float]] = {}
        self.capture_report: List[Dict[str, Any]] = []
        self.validation_report: List[Dict[str, Any]] = []
        self.eval_report: List[Dict[str, Any]] = []

    @property
    def checkpoint_manager(self) -> CheckpointManager:
        if self._checkpoint_manager is None:
            self._checkpoint_manager = CheckpointManager(
                self.output_dir,
                total_limit=self.config.get("checkpoints_total_limit"),
                rolling_total_limit=int(self.config.get("checkpoints_rolling_total_limit", 1) or 1),
                async_save=bool(self.config.get("checkpointing_use_async", False)),
            )
        return self._checkpoint_manager

    def _get(self, key: str, default=None):
        return self.config.get(key, default)

    # ---- lifecycle plumbing ---------------------------------------------------------------
    def _stage(self, name: str, status: str = "running", detail: Optional[str] = None):
        self.webhook_handler.send_raw(lifecycle_stage_event(name, status, self.job_id, detail))
        logger.info("lifecycle: %s (%s)", name, status)

    def abort(self) -> None:
        self.should_abort = True

    def _check_unported(self) -> None:
        """Refuse the training options and families the port does not train."""
        for key, what, item in _UNPORTED_OPTIONS:
            if self._get(key):
                raise NotImplementedError(f"{key}: {what} is not ported (ROADMAP {item})")
        model_type = self._get("model_type", "lora")
        if model_type != "lora":
            raise NotImplementedError(
                f"model_type={model_type!r}: only LoRA training is ported (ROADMAP Queue 1 item 7)")
        self.model.check_training_config()

    # ---- lifecycle stages (reference train.py:42-86 ordering) ------------------------------
    def configure_webhook(self) -> None:
        raw = self._get("webhook_config")
        if raw:
            self.webhook_handler = WebhookHandler(WebhookConfig.load(raw), self.job_id)
        self._stage("configure_webhook", "completed")

    def init_seed(self) -> None:
        self.seed = int(self._get("seed", 42) or 42)

    def init_preprocessing_models(self) -> None:
        """Load the text encoders and the VAE for the caching passes."""
        self._stage("init_preprocessing_models")
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
        self._stage("init_preprocessing_models", "completed")

    def _vae_dtype(self) -> torch.dtype:
        """Compute dtype of the VAE (``vae_dtype``, default bf16; fp16 maps to bf16)."""
        raw = str(self._get("vae_dtype", "bf16") or "bf16").lower()
        if raw not in _VAE_DTYPES:
            raise ValueError(f"unknown vae_dtype {raw!r}; use bf16|fp16|fp32|default")
        return _VAE_DTYPES[raw]

    def _init_vae(self, tiny: bool) -> None:
        modality = getattr(self.model, "MODALITY", "image")
        if not getattr(self.model, "REQUIRES_VAE", True) or modality not in ("image", "video", "audio"):
            raise NotImplementedError(f"{self.model.NAME}: only the image, video and audio VAEs are ported")
        if modality == "audio":
            # the JAX trainer builds the audio VAE from PRNGKey(0) whatever the
            # model dir holds; the port draws it from a generator seeded 0
            with torch.device(self.device):
                vae = AudioAutoencoderKL(self.model.audio_vae_config())
            self.vae = init_parameters(vae, torch.Generator(device=self.device).manual_seed(0)).eval()
            return
        if modality == "video":
            # the JAX trainer builds the causal video VAE from PRNGKey(0) for
            # every video family, whatever pretrained_vae_model_name_or_path
            # says (ROADMAP Queue 3); the port draws it from a generator seeded
            # 0, in bf16 as the JAX module computes
            with torch.device(self.device):
                vae = VideoAutoencoderKL(self.model.video_vae_config())
            self.vae = init_parameters(vae, torch.Generator(device=self.device).manual_seed(0)).eval()
            return
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
        transfer = torch.float32 if self._vae_dtype() == torch.float32 else torch.float16
        return vae_encode_fn(self.vae, self.device, transfer)

    def vae_decode_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        vae = self.vae
        return lambda latents: vae.decode(latents)

    def init_data_backend(self) -> None:
        self._stage("init_data_backend")
        per_device = int(self._get("train_batch_size", 1) or 1)
        # gradient accumulation multiplies the batch the sampler assembles
        self.global_batch_size = per_device * self.grad_accum_steps
        self.data_plane = configure_multi_databackend(
            self.config, self.model, vae_encode_fn=self._vae_encode_fn(), global_batch_size=self.global_batch_size,
        )
        for report in data_plane_report(self.data_plane):
            logger.info("\n%s", format_report(report))
        self._stage("init_data_backend", "completed")

    def init_validations(self) -> None:
        """Built before the encoders are unloaded, so the prompt embeds are ready."""
        self._stage("init_validations")
        self.validation = Validation(
            self.model,
            self.config,
            decode_fn=self.vae_decode_fn(),
            output_dir=self.output_dir,
            webhook_handler=self.webhook_handler,
            device=self.device,
        )
        self.validation.precompute_embeds()
        self._init_validation_video_conditioning()
        self.eval_loss = EvalLoss(
            self.model,
            list(self.data_plane.bundles.values()) if self.data_plane else [],
            seed=self.seed,
            max_batches=int(self._get("num_eval_images", 8) or 8),
            eval_dataset_ids=self._get("eval_dataset_id"),
            draws_per_batch=int(self._get("eval_timesteps", 1) or 1),
            device=self.device,
        )
        self._stage("init_validations", "completed")

    def _init_validation_video_conditioning(self) -> None:
        """The IC-LoRA reference video of the renders
        (``validation_ltx2_video_conditioning``, one entry): decoded, resized
        (Lanczos) to the validation resolution when it differs, VAE-encoded
        as the latent cache encodes, and installed on the model."""
        parse = getattr(self.model, "validation_video_conditioning_entries", None)
        entries = parse() if callable(parse) else None
        if not entries:
            return
        if len(entries) > 1:
            raise ValueError(f"this build supports one validation reference video; got {len(entries)} "
                             "validation_ltx2_video_conditioning entries")
        if self.vae is None:
            raise ValueError("validation_ltx2_video_conditioning needs the video VAE loaded")
        from ..data.video import load_video_frames, video_to_array

        class _LocalFS:
            def abspath(self, path):
                return path

            def read(self, path):
                with open(path, "rb") as handle:
                    return handle.read()

        path, strength = entries[0]
        raw = load_video_frames(_LocalFS(), path, num_frames=int(self._get("validation_num_video_frames", 9) or 9))
        if raw is None:
            raise ValueError(f"could not decode conditioning video {path!r}")
        res = int(self.validation.resolution)
        if raw.shape[1] != res or raw.shape[2] != res:
            from PIL import Image

            raw = np.stack([np.asarray(Image.fromarray(f).resize((res, res), Image.LANCZOS)) for f in raw])
        pixels = torch.from_numpy(video_to_array(raw)[None]).to(self.device)
        with torch.no_grad():
            latents = self.vae.encode(pixels).to(torch.float32).cpu().numpy()
        self.model.set_validation_video_conditioning(latents, strength)
        logger.info("validation reference video %s -> latents %s (strength %.2f)", path, latents.shape, strength)

    def init_unload_text_encoder(self) -> None:
        """Drop the text encoders after all caching and return their device
        memory (reference trainer.py:2710)."""
        self.model.text_encoders = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

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

    def _allow_untrained(self) -> bool:
        return self._get("model_arch_preset") == "tiny" or bool(self._get("allow_untrained_init"))

    def init_load_base_model(self) -> None:
        """The family's module on the device, from the pretrained checkpoint
        or, where untrained weights are allowed, from seeded initialisation."""
        self._stage("init_load_base_model")
        if self.data_plane is not None:
            shapes = {k: tuple(v.shape) for k, v in self._example_batch().items()}
            logger.info("example batch: %s", shapes)
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
            source = _file_fingerprint(pretrained)
        else:
            init_parameters(module, generator)
            source = {"seed": self.seed}
        self.module = module
        # where the frozen base comes from, for checkpoints that refer to it
        self._frozen_source = {**source, "family": self.model.NAME, "quantize": self.model.base_precision}
        self._stage("init_load_base_model", "completed")

    def _example_batch(self) -> Dict[str, np.ndarray]:
        """One batch of the data plane, peeked: the iterator's state is
        snapshot, one batch drawn and the state restored, so the training
        sequence does not move."""
        snapshot = self.data_plane.iterator.save_state()
        raw = self.data_plane.iterator.next_batch()
        self.data_plane.iterator.load_state(snapshot)
        return {k: v if v.ndim == 0 else v[:1] for k, v in raw.items() if isinstance(v, np.ndarray)}

    def init_trainable_peft_adapter(self) -> None:
        if self.model.lora_rank > 0 and not any(n.endswith("lora_A") for n, _ in self.module.named_parameters()):
            raise ValueError("model_type=lora but the module produced no lora collection")
        init_lora = self._get("init_lora")
        if init_lora and self.model.lora_rank > 0:
            # --init_lora: warm-start the adapter from an existing LoRA file
            missing = load_lora_safetensors(self.model, str(init_lora), self.module)
            logger.info("warm-started LoRA adapter from %s (%d adapters not in the file)", init_lora, len(missing))

    def init_ema_model(self) -> None:
        self.ema_config = None
        if self._get("use_ema"):
            self.ema_config = EMAConfig(
                decay=float(self._get("ema_decay", 0.9999) or 0.9999),
                update_interval=int(self._get("ema_update_interval", 1) or 1),
            )

    def init_distillation(self) -> None:
        """Distillation and ODE pairs are not ported; ``_check_unported``
        refused their options."""
        if self.data_plane is not None and any(
                b.config.dataset_type == "distillation_cache" for b in self.data_plane.bundles.values()):
            raise NotImplementedError("distillation caches (ODE pairs) are not ported (ROADMAP Queue 1 item 4g)")

    def init_crepa(self) -> None:
        """CREPA / U-REPA are not ported; ``_check_unported`` refused them."""

    def resume_and_prepare(self) -> None:
        """Optimizer, schedule, train state and step, then the resume
        (reference trainer.py:4980,3735,3952,4140,4636)."""
        self._stage("resume_and_prepare")
        self._check_unported()
        self.max_train_steps = int(self._get("max_train_steps", 1000) or 0)
        epochs = int(self._get("num_train_epochs", 0) or 0)
        if not self.max_train_steps and epochs and self.data_plane is not None:
            per_epoch = sum(
                bundle.sampler.batches_per_epoch()
                for bundle in self.data_plane.bundles.values()
                if bundle.config.dataset_type in ("image", "video", "audio")
            )
            self.max_train_steps = max(per_epoch * epochs, 1)
            logger.info("num_train_epochs=%d -> max_train_steps=%d (%d batches/epoch)",
                        epochs, self.max_train_steps, per_epoch)
        self.lr_schedule = get_lr_schedule(self.config, max(self.max_train_steps, 1))
        self.tx = get_optimizer(self.config, self.lr_schedule)
        self._state = create_train_state(self.model, self.module, self.tx, self.ema_config,
                                         quantize_mode=self.model.base_precision)
        self._step_fn = build_train_step(self.model, self.tx, self.lr_schedule, self.ema_config,
                                         self.grad_accum_steps)
        self._generator = torch.Generator(device=self.device)
        if self.device.type == "cuda":
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph_stream = torch.cuda.Stream(self.device)

        resume = self.checkpoint_manager.resolve_resume(self._get("resume_from_checkpoint"))
        if resume:
            check_resume_family(resume, self.model.NAME)
            _, extra = self.checkpoint_manager.restore(resume, self._state, self._frozen_source)
            self.global_step = int(extra.get("global_step", self._state.step))
            self.epoch = int(extra.get("epoch", 0))
            if self.data_plane is not None and extra.get("data_plane"):
                self.data_plane.load_state(extra["data_plane"])
            logger.info("resumed from %s at step %d", resume, self.global_step)
        self._stage("resume_and_prepare", "completed")

    def init_benchmark_base_model(self) -> None:
        """Render base-model images for before/after stitching (reference
        trainer.py:4434 init_benchmark_base_model)."""
        if (
            self.validation is None
            or self.validation.disabled
            or self._get("disable_benchmark")
            or self.model.lora_rank <= 0
        ):
            return
        with render_view(self._state, zero_adapters=True) as module:
            self.validation.run_benchmark(module)

    def init_trackers(self) -> None:
        self.trackers = build_trackers(self.config, self.output_dir)

    def init_huggingface_hub(self) -> None:
        self.publishing = PublishingManager(self.model, self.config, self.output_dir)

    # ---- checkpointing ----------------------------------------------------------------------
    def save_checkpoint(self, rolling: bool = False, final: bool = False) -> str:
        # under dataloader_prefetch the live cursor runs ahead of the trained
        # sequence: persist the state of the last batch the loop consumed
        data_plane_state = None
        if self.data_plane is not None:
            data_plane_state = self._consumed_iter_state or self.data_plane.save_state()
        extra = {
            "global_step": self.global_step,
            "epoch": self.epoch,
            "model_family": self.model.NAME,
            "data_plane": data_plane_state,
        }
        step_at_save = self.global_step
        # the adapter on the host now: later steps change the state in place
        lora_snapshot = None
        if self.model.lora_rank > 0:
            lora_snapshot = {k: p.detach().to("cpu", copy=True) for k, p in self._state.trainable.items()}

        def on_complete(final_path: str) -> None:
            self.webhook_handler.send_raw(checkpoint_event(final_path, step_at_save, rolling, self.job_id))
            self._export_lora(final_path, lora_snapshot)
            if self.publishing is not None:
                self.publishing.on_checkpoint(final_path, final=final)

        return self.checkpoint_manager.save(self.global_step, self._state, extra, rolling, on_complete=on_complete,
                                            frozen_source=self._frozen_reference())

    def _frozen_reference(self) -> Optional[Dict[str, Any]]:
        """The frozen base's source when checkpoints refer to the base
        (``checkpoint_frozen_base: reference``, the port's own key), else
        None (the whole state is written, as the JAX package writes it)."""
        mode = str(self._get("checkpoint_frozen_base") or "full")
        if mode not in ("full", "reference"):
            raise ValueError(f"checkpoint_frozen_base={mode!r}: use full or reference")
        return self._frozen_source if mode == "reference" else None

    def _export_lora(self, checkpoint_path: str, lora=None) -> None:
        if self.model.lora_rank <= 0:
            return
        try:
            if lora is None:
                lora = {k: p.detach().to("cpu", copy=True) for k, p in self._state.trainable.items()}
            if self.data_plane is not None and not hasattr(self, "_tag_frequency_cache"):
                # once per run; rides every export's metadata
                try:
                    self._tag_frequency_cache = self.data_plane.tag_frequency()
                    self._trigger_words_cache = self.data_plane.trigger_words()
                except Exception:
                    self._tag_frequency_cache = {}
                    self._trigger_words_cache = []
            save_lora_safetensors(
                self.model,
                lora,
                os.path.join(checkpoint_path, "pytorch_lora_weights.safetensors"),
                metadata=safetensors_modelspec(
                    self.model,
                    self.config,
                    trigger_words=getattr(self, "_trigger_words_cache", None),
                    tag_frequency=getattr(self, "_tag_frequency_cache", None),
                ),
            )
        except Exception as exc:
            logger.warning("LoRA export failed: %s", exc)

    # ---- batch transfer ---------------------------------------------------------------------
    def _device_batch(self, raw: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Host batch -> tensors on the device: every numeric array; with
        gradient accumulation a leading micro-batch axis (scalars broadcast
        to it)."""
        out = {}
        accum = self.grad_accum_steps
        for key, value in raw.items():
            if not isinstance(value, np.ndarray) or value.dtype.kind not in "fiub":
                continue
            if value.ndim == 0:
                if accum > 1:
                    value = np.broadcast_to(value, (accum,))
            elif accum > 1:
                if value.shape[0] % accum:
                    raise ValueError(
                        f"batch dim {value.shape[0]} not divisible by gradient_accumulation_steps {accum}")
                value = value.reshape(accum, value.shape[0] // accum, *value.shape[1:])
            out[key] = torch.from_numpy(np.ascontiguousarray(value)).to(self.device, non_blocking=False)
        return out

    # ---- preemption -------------------------------------------------------------------------
    def _install_preemption_handler(self) -> None:
        """SIGTERM (a preempted or drained machine) sets a flag: the loop
        stops after its step, checkpoints and exits cleanly."""

        def on_sigterm(signum, frame):
            self._preempted = True
            self.should_abort = True

        self._preempted = False
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:  # not the main thread
            self._prev_sigterm = None

    def _handle_preemption(self) -> None:
        logger.warning("SIGTERM at step %d: writing preemption checkpoint before exit", self.global_step)
        self.webhook_handler.send_raw(
            device_fault_event(
                f"preemption signal at step {self.global_step}; checkpointing",
                details={"step": self.global_step, "kind": "preemption"},
                job_id=self.job_id,
            )
        )
        path = self.save_checkpoint()
        self.checkpoint_manager.wait()
        self.webhook_handler.flush()
        logger.warning("preemption checkpoint complete: %s", path)

    def _run_step(self, batch: Dict[str, torch.Tensor]):
        """One train step with the generator seeded for ``global_step``.  On
        the card, the step of each batch shape (the keys, shapes and dtypes,
        as the JAX ``_compiled_steps`` are keyed) is captured once and
        replayed; every graph works on the one state, in one memory pool,
        captured on one side stream."""
        self._generator.manual_seed(step_seed(self.seed, self.global_step))
        if self.device.type != "cuda":
            return self._step_fn(self._state, batch, self._generator)
        key = tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in batch.items()))
        graphed = self._graphs.get(key)
        if graphed is None:
            start = time.perf_counter()
            graphed = jit_train_step(self._step_fn, self._state, batch, self._generator, pool=self._graph_pool,
                                     stream=self._graph_stream)
            torch.cuda.synchronize(self.device)
            self._graphs[key] = graphed
            self.capture_report.append({"step": self.global_step + 1, "seconds": time.perf_counter() - start,
                                        "shapes": {k: list(v.shape) for k, v in batch.items()}})
            # the warm-up moved the generator; the step draws from step_seed
            self._generator.manual_seed(step_seed(self.seed, self.global_step))
        return graphed(self._state, batch, self._generator)

    def _validate(self, step: int, force: bool = False, slug: str = "", use_ema: bool = False) -> List[str]:
        start = time.perf_counter()
        with render_view(self._state, use_ema=use_ema) as module:
            paths = self.validation.run_validations(module, step, force=force, slug=slug)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if paths:
            self.validation_report.append({"step": step, "slug": slug, "seconds": time.perf_counter() - start,
                                           "paths": paths})
        return paths

    def _evaluate(self, step: int) -> Optional[float]:
        """The eval loss on the state as ``render_view`` shows it (the JAX
        trainer evaluates ``TrainState.variables()``), logged as
        ``eval_loss`` to every tracker."""
        start = time.perf_counter()
        with render_view(self._state) as module:
            value = self.eval_loss.execute_eval(module)
        seconds = time.perf_counter() - start
        if value is not None:
            for tracker in self.trackers:
                tracker.log({"eval_loss": value}, step)
        self.eval_report.append({"step": step, "eval_loss": value, "seconds": seconds})
        logger.info("eval_loss %s at step %d (%.3f s)", value, step, seconds)
        return value

    # ---- the loop ---------------------------------------------------------------------------
    def train(self) -> None:
        self._stage("train")
        self._install_preemption_handler()
        self.profiler = ProfilerSession(self.config, self.output_dir)
        self.disk_guard = DiskGuard(self.config, self.output_dir)
        checkpoint_interval = self._get("checkpointing_steps")
        rolling_interval = self._get("checkpointing_rolling_steps")
        checkpoint_epoch_interval = self._get("checkpoint_epoch_interval")
        validation_epoch_interval = self._get("validation_epoch_interval")
        eval_interval = self._get("eval_steps_interval")
        log_interval = int(self._get("logging_steps", 1) or 1)
        webhook_interval = int(self._get("webhook_reporting_interval", 10) or 10)

        start_step = self.global_step
        if self.validation is not None and self._get("validation_on_startup") and start_step == 0:
            # --validation_on_startup: render once with the loaded weights before step 1
            self._validate(self.global_step, force=True)
        fetcher = None
        if self._get("dataloader_prefetch"):
            from ..data.batch_fetcher import BatchFetcher

            fetcher = BatchFetcher(
                self.data_plane.iterator,
                start_step=self.global_step,
                depth=int(self._get("dataloader_prefetch_qlen", 10) or 10),
            )
        try:
            while self.global_step < self.max_train_steps and not self.should_abort:
                epoch_before = self.epoch
                if fetcher is not None:
                    raw, self.epoch, pending_iter_state = fetcher.next_batch()
                else:
                    raw = self.data_plane.iterator.next_batch(step=self.global_step)
                    self.epoch = self.data_plane.iterator.epoch
                    pending_iter_state = None  # live cursor == consumed state
                epoch_rolled = self.epoch > epoch_before
                batch = self._device_batch(raw)
                self._state, metrics = self._run_step(batch)
                self.global_step += 1
                self._consumed_iter_state = pending_iter_state
                self.iteration_tracker.record_step()
                if epoch_rolled:
                    # epoch rollover hooks, after the step so the checkpoint's
                    # cursor sits past a batch that was trained on
                    if (
                        checkpoint_epoch_interval
                        and self.epoch % int(checkpoint_epoch_interval) == 0
                        and self.disk_guard.check_before_checkpoint()
                    ):
                        self.save_checkpoint()
                    if (
                        self.validation is not None
                        and validation_epoch_interval
                        and self.epoch % int(validation_epoch_interval) == 0
                    ):
                        self._validate(self.global_step, force=True)

                if self.global_step % log_interval == 0:
                    host_metrics = {k: float(v) for k, v in metrics.items()}
                    host_metrics["epoch"] = self.epoch
                    for tracker in self.trackers:
                        tracker.log(host_metrics, self.global_step)
                    if host_metrics.get("skipped_nonfinite", 0):
                        logger.warning("non-finite loss at step %d; update skipped", self.global_step)

                if self.global_step % webhook_interval == 0:
                    self.webhook_handler.send_raw(
                        training_status_event(
                            self.global_step,
                            self.max_train_steps,
                            self.epoch,
                            loss=float(metrics["loss"]),
                            learning_rate=float(metrics.get("lr", 0.0)),
                            iterations_per_second=self.iteration_tracker.rate(),
                            eta_seconds=self.iteration_tracker.eta_seconds(self.max_train_steps - self.global_step),
                            job_id=self.job_id,
                        )
                    )

                self.profiler.step(self.global_step)

                if checkpoint_interval and self.global_step % int(checkpoint_interval) == 0:
                    if self.disk_guard.check_before_checkpoint():
                        self.save_checkpoint()
                elif rolling_interval and self.global_step % int(rolling_interval) == 0:
                    if self.disk_guard.check_before_checkpoint():
                        self.save_checkpoint(rolling=True)

                if (
                    self.eval_loss is not None
                    and self.eval_loss.enabled
                    and eval_interval
                    and self.global_step % int(eval_interval) == 0
                ):
                    self._evaluate(self.global_step)

                if self.validation is not None and self.validation.would_validate(self.global_step):
                    # --ema_validation: none | ema_only | comparison;
                    # use_ema_for_validation=True is the ema_only shorthand
                    ema_mode = str(self._get("ema_validation") or "comparison")
                    has_ema = self._state.ema is not None
                    use_ema = has_ema and (bool(self._get("use_ema_for_validation")) or ema_mode == "ema_only")
                    self._validate(self.global_step, use_ema=use_ema)
                    if has_ema and ema_mode == "comparison" and not use_ema:
                        self._validate(self.global_step, force=True, slug="_ema", use_ema=True)

                self._consume_signals()

            if getattr(self, "_preempted", False):
                self._handle_preemption()
                self._stage("train", "completed", "preempted")
                return

            # final checkpoint + validation (reference trainer.py:7274 final export)
            if self.global_step > start_step:
                self.save_checkpoint(final=True)
            validation_paths = []
            if self.validation is not None:
                validation_paths = self._validate(self.global_step, force=True)
            if self.publishing is not None:
                self.publishing.write_model_card(
                    validation_prompts=self.validation.prompts if self.validation else None,
                    validation_images=validation_paths,
                    train_steps=self.global_step,
                )
            self._stage("train", "completed")
        except Exception as exc:
            if isinstance(exc, torch.cuda.OutOfMemoryError) or "CUDA" in str(exc):
                self.webhook_handler.send_raw(device_fault_event(str(exc), job_id=self.job_id))
            self.webhook_handler.send_raw(error_event("training failed", exc, self.job_id))
            self._stage("train", "failed", str(exc))
            if self.exit_on_error:
                logger.exception("training failed")
                raise SystemExit(1) from exc
            raise
        finally:
            if getattr(self, "_prev_sigterm", None) is not None:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            if fetcher is not None:
                fetcher.stop()
            self.checkpoint_manager.wait()
            self.profiler.close()
            for tracker in self.trackers:
                tracker.finish()
            self.webhook_handler.flush()

    def _consume_signals(self) -> None:
        """Manual validation/checkpoint/abort triggers from a signal file
        (reference train.py:88-143 consumers of SIMPLETUNER_ACCELERATE_SIGNAL_FILE)."""
        path = os.environ.get("SIMPLETUNER_SIGNAL_FILE")
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as handle:
                actions = [line.strip() for line in handle if line.strip()]
            os.remove(path)
        except OSError:
            return
        for action in actions:
            if action == "validation" and self.validation is not None:
                self._validate(self.global_step, force=True)
            elif action == "checkpoint":
                self.save_checkpoint()
            elif action == "abort":
                self.abort()

    # ---- full run -----------------------------------------------------------------------------
    def run(self) -> None:
        """The ordered lifecycle of the JAX ``run`` (reference train.py:42-86
        ``_run_training``); ``stage_report`` keeps each stage's seconds and,
        on the card, its peak device memory."""
        os.makedirs(self.output_dir, exist_ok=True)
        self._check_unported()
        cuda = self.device.type == "cuda"
        for name in RUN_ORDER:
            if cuda:
                torch.cuda.synchronize(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
            start = time.perf_counter()
            getattr(self, name)()
            entry = {"seconds": time.perf_counter() - start}
            if cuda:
                torch.cuda.synchronize(self.device)
                entry["peak_gib"] = torch.cuda.max_memory_allocated(self.device) / 2**30
                entry["allocated_gib"] = torch.cuda.memory_allocated(self.device) / 2**30
            self.stage_report[name] = entry
            logger.info("stage %s: %s", name, entry)


def run_trainer_job(config: Dict[str, Any], job_id: Optional[str] = None, device="cuda") -> Trainer:
    """Programmatic entry (reference trainer.py:7349 run_trainer_job)."""
    trainer = Trainer(config=TrainingConfig(dict(config)), device=device, job_id=job_id)
    trainer.run()
    return trainer
