"""Model-family base class: the static contract, LoRA targeting and the
flow-matching and DDPM training paths.

Counterpart of ``simpletuner_tpu/models/common.py::ModelFoundation``.  Where
the JAX methods take a Flax ``variables`` tree, the port takes the
``nn.Module`` that holds its weights; where they take a ``jax.random`` key,
the port takes a ``torch.Generator``.

Ported: the family contract (with ``TextEncoderSpec``,
``attach_text_encoders`` and the ``encode_text`` hook), ``denoise_fn``, the
LoRA target predicate (``lora_target_modules`` /
``_build_lora_target_predicate``), the quantized
base's settings (``base_precision``, ``quantized_matmul``), the schedules
(``flow_schedule_config``, ``ddpm_schedule_config`` with the family's beta
ladder, ``timestep_sampling_config`` with the refiner's window), and both
branches of ``prepare_batch`` (flow sigmas, or DDPM timesteps with the
epsilon / v / sample targets; the ``override_noise`` / ``override_sigmas`` /
``override_timesteps`` hooks), ``compute_loss`` and ``loss_fn``.  The alpha-bar
ladder and the timestep CDF are made once per device (``ddpm_tables``), so a
captured step reads them and makes no table.  Refused with
NotImplementedError: noise offset, input perturbation, diff2flow, ReflexFlow,
text-encoder training, T-LoRA, scheduled sampling, prior preservation,
REPA/CREPA and TwinFlow.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..training.losses import (
    DDPMScheduleConfig,
    FlowScheduleConfig,
    LossConfig,
    TimestepSamplingConfig,
    add_noise,
    diffusion_loss,
    flow_interpolate,
    flow_target,
    make_alphas_cumprod,
    parse_flow_custom_timesteps,
    sample_flow_sigmas,
    sample_timesteps,
    timestep_weights,
    velocity_target,
)
from ..training.quantization import resolve_precision, resolve_quantized_matmul
from .layers import apply_lora_target, set_quantized_matmul

# config keys whose training features are not ported: each must be unset
_UNPORTED_TRAINING = (
    "noise_offset", "offset_noise", "input_perturbation", "train_text_encoder",
    "scheduled_sampling_max_steps", "scheduled_sampling_max_step_offset", "urepa_enabled",
    "crepa_enabled", "twinflow_enabled", "distillation_method", "tread_config",
)


@dataclasses.dataclass(frozen=True)
class TextEncoderSpec:
    name: str
    family: str  # clip-l | clip-g | t5-xxl | t5
    subfolder: Optional[str] = None
    tokenizer_subfolder: Optional[str] = None
    max_length: int = 77
    output: str = "last_hidden_state"  # or "pooled" / "penultimate"


class ModelFoundation:
    NAME: str = "base"
    MODEL_TYPE: str = "transformer"  # transformer | unet
    PREDICTION_TYPE: str = "flow_matching"
    REQUIRES_VAE: bool = True
    MODALITY: str = "image"
    DEFAULT_RESOLUTION: int = 1024
    HUGGINGFACE_PATHS: Dict[str, str] = {}
    DEFAULT_FLAVOUR: Optional[str] = None
    TEXT_ENCODER_CONFIGURATION: Sequence[TextEncoderSpec] = ()
    # --slider_lora_target: attention-only adapter for concept-slider training
    SLIDER_LORA_TARGET: Sequence[str] = (
        "to_q", "to_k", "to_v", "to_out.0",
        "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out",
    )
    VAE_SCALING_FACTOR: float = 1.0
    VAE_SHIFT_FACTOR: float = 0.0
    # the family's DDPM betas (the SD-arch hub scheduler configs: scaled_linear
    # 0.00085 -> 0.012)
    DDPM_BETA_START: float = 0.00085
    DDPM_BETA_END: float = 0.012
    DDPM_BETA_SCHEDULE: str = "scaled_linear"
    # the config prefix of the family's staged (base/refiner, stage-1/stage-2)
    # validation mode, as the JAX TwoStageValidationMixin reads it: "sdxl" or
    # "pixart"; "" for a family without one
    STAGED_VALIDATION_PREFIX: str = ""

    @classmethod
    def get_acceleration_presets(cls) -> List[Dict[str, Any]]:
        """Declarative memory/speed presets for the UI and the configure
        wizard: the JAX package's single-device presets (remat policy, int8
        frozen base, quantized optimizer state), each with the config
        overrides that enact it.  The JAX ``multichip`` (FSDP) preset is left
        out: a mesh is not ported (ROADMAP Queue 1 item 5)."""
        return [
            {
                "name": "speed",
                "description": "No remat, bf16 base — fastest when the model fits device memory",
                "tradeoff": "highest device memory; full activation residency",
                "config": {"gradient_checkpointing": False, "base_model_precision": "no_change"},
            },
            {
                "name": "balanced",
                "description": "Full remat with attention outputs saved across the boundary",
                "tradeoff": "less activation memory for some recompute",
                "config": {"gradient_checkpointing": True, "gradient_checkpointing_policy": "attn"},
            },
            {
                "name": "memory",
                "description": "Full remat + int8 frozen base (LoRA) + int8 optimizer states",
                "tradeoff": "the smallest device memory; slower steps",
                "config": {
                    "gradient_checkpointing": True,
                    "gradient_checkpointing_policy": "full",
                    "base_model_precision": "int8",
                    "optimizer": "bnb-adamw8bit",
                },
            },
        ]

    def __init__(self, config: Any):
        self.config = config
        self.flavour = getattr(config, "model_flavour", None) or self.DEFAULT_FLAVOUR
        self.text_encoders: List[Any] = []
        self._ddpm_tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def is_flow(self) -> bool:
        prediction = getattr(self.config, "prediction_type", None) or self.PREDICTION_TYPE
        return prediction == "flow_matching"

    @property
    def prediction_type(self) -> str:
        return getattr(self.config, "prediction_type", None) or self.PREDICTION_TYPE

    def huggingface_path(self) -> Optional[str]:
        explicit = getattr(self.config, "pretrained_model_name_or_path", None)
        if explicit:
            return explicit
        if self.flavour and self.flavour in self.HUGGINGFACE_PATHS:
            return self.HUGGINGFACE_PATHS[self.flavour]
        if self.HUGGINGFACE_PATHS:
            return next(iter(self.HUGGINGFACE_PATHS.values()))
        return None

    # ---- adapters ----------------------------------------------------------------------
    @property
    def lora_rank(self) -> int:
        if getattr(self.config, "model_type", "lora") == "lora":
            return int(getattr(self.config, "lora_rank", 16) or 16)
        return 0

    @property
    def lora_alpha(self) -> Optional[float]:
        return getattr(self.config, "lora_alpha", None)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: bf16 under ``mixed_precision: bf16`` (the default), else f32."""
        return torch.bfloat16 if getattr(self.config, "mixed_precision", "bf16") == "bf16" else torch.float32

    def build_module(self, module_cls: Callable[..., nn.Module], **extra: Any) -> nn.Module:
        """``module_cls`` of the family's arch with LoRA adapters on every
        ``LoRADense`` the targets allow (f32 masters, B = 0 at init), the
        ``gradient_checkpointing`` remat and the int8 product mode of a
        quantized base (the base itself is quantized by
        ``create_train_state(quantize_mode=model.base_precision)`` after the
        weights are set, as in the JAX trainer)."""
        rank = self.lora_rank
        module = module_cls(config=self.arch, dtype=self.dtype, lora_rank=rank, lora_alpha=self.lora_alpha,
                            lora_algo=self.lora_algo if rank else "lora",
                            remat=bool(getattr(self.config, "gradient_checkpointing", False)), **extra)
        set_quantized_matmul(module, self.quantized_matmul)
        if rank:
            apply_lora_target(module, self._build_lora_target_predicate())
        return module

    # ---- quantized frozen base -----------------------------------------------------------
    @property
    def base_precision(self) -> Optional[str]:
        """``base_model_precision`` resolved to None, "int8", "fp8" or "int4":
        the ``quantize_mode`` that ``create_train_state`` takes."""
        return resolve_precision(self.config)

    @property
    def quantized_matmul(self) -> str:
        """The int8 product mode of the quantized base ("off", "forward",
        "full"), resolved from the config as ``apply_trace_globals`` does
        (common.py:102-105); ``create_module`` sets it on every layer."""
        return resolve_quantized_matmul(self.config)

    @property
    def lora_algo(self) -> str:
        """Only the PEFT-style ``lora`` algorithm is ported; LyCORIS types,
        PEFT modes other than plain LoRA, adapter dropout and other
        initialisations raise."""
        lora_type = (getattr(self.config, "lora_type", None) or "standard").lower()
        mode = (getattr(self.config, "peft_lora_mode", None) or "standard").lower()
        if lora_type != "standard" or mode != "standard":
            raise NotImplementedError(f"lora_type={lora_type!r} / peft_lora_mode={mode!r}: only plain LoRA is ported")
        if float(getattr(self.config, "lora_dropout", 0.0) or 0.0) > 0:
            raise NotImplementedError("lora_dropout > 0 is not ported")
        init = (getattr(self.config, "lora_init_type", None) or "default").lower()
        if init != "default":
            raise NotImplementedError(f"lora_init_type={init!r} is not ported (only 'default')")
        return "lora"

    def family_lora_targets(self) -> Optional[Sequence[str]]:
        """Family preset hook: diffusers module-name patterns (PEFT suffix
        semantics), or None to adapt every LoRADense."""
        return None

    def lora_target_modules(self) -> Optional[Sequence[str]]:
        """Manual --lora_target_modules / --peft_lora_target_modules >
        --slider_lora_target > family preset > None (adapt everything)."""
        cfg = self.config
        manual = getattr(cfg, "lora_target_modules", None) or getattr(cfg, "peft_lora_target_modules", None)
        if manual:
            if isinstance(manual, str):
                text = manual.strip()
                if os.path.isfile(text):  # JSON-file form of the reference field
                    with open(text) as handle:
                        manual = json.load(handle)
                elif text.startswith("["):
                    manual = json.loads(text)
                else:
                    manual = [t.strip() for t in text.split(",") if t.strip()]
            if not isinstance(manual, (list, tuple)) or not all(isinstance(t, str) for t in manual):
                raise ValueError(f"lora_target_modules must be a list of module name strings (got {manual!r})")
            return list(manual)
        if getattr(cfg, "slider_lora_target", False):
            return list(self.SLIDER_LORA_TARGET)
        return self.family_lora_targets()

    def _build_lora_target_predicate(self) -> Optional[Callable[[str], bool]]:
        """The resolved targets as a predicate over "/"-joined JAX module paths.

        A path matches when its dotted form, or a diffusers name it maps to
        through the family LoRA key map (``training/lora.py``),
        equals a target or ends with "." + target; a fused projection (Flux
        ``linear1`` = q|k|v|mlp) adapts whole when any of its split names
        matches."""
        targets = self.lora_target_modules()
        if targets is None:
            return None
        from ..training.lora import _key_map_for

        patterns = [t.replace("/", ".") for t in targets]
        key_map = _key_map_for(self)

        def predicate(path: str) -> bool:
            names = [path.replace("/", ".")]
            mapped = key_map.get(path)
            if isinstance(mapped, str):
                names.append(mapped)
            elif isinstance(mapped, list):
                names.extend(entry[0] for entry in mapped)
            return any(n == p or n.endswith("." + p) for n in names for p in patterns)

        return predicate

    # ---- schedules -------------------------------------------------------------------------
    def flow_schedule_config(self) -> FlowScheduleConfig:
        c = self.config
        fast = bool(getattr(c, "flux_fast_schedule", False))
        if fast and self.NAME not in ("flux", "chroma"):
            raise ValueError(f"--flux_fast_schedule is a flux/chroma schnell schedule; family {self.NAME!r} "
                             "does not support it")
        return FlowScheduleConfig(
            sigmoid_scale=getattr(c, "flow_sigmoid_scale", 1.0) or 1.0,
            schedule_shift=getattr(c, "flow_schedule_shift", None),
            auto_shift=bool(getattr(c, "flow_schedule_auto_shift", False)),
            use_uniform_schedule=bool(getattr(c, "flow_use_uniform_schedule", False)),
            use_beta_schedule=bool(getattr(c, "flow_use_beta_schedule", False)),
            beta_alpha=getattr(c, "flow_beta_schedule_alpha", 2.0) or 2.0,
            beta_beta=getattr(c, "flow_beta_schedule_beta", 2.0) or 2.0,
            custom_sigmas=parse_flow_custom_timesteps(getattr(c, "flow_custom_timesteps", None)),
            custom_mode=str(getattr(c, "flow_timesteps_mode", "fixed-list") or "fixed-list").replace("_", "-"),
            fast_schedule=fast,
        )

    def ddpm_schedule_config(self) -> DDPMScheduleConfig:
        return DDPMScheduleConfig(
            beta_start=self.DDPM_BETA_START,
            beta_end=self.DDPM_BETA_END,
            beta_schedule=self.DDPM_BETA_SCHEDULE,
            rescale_betas_zero_snr=bool(getattr(self.config, "rescale_betas_zero_snr", False)),
        )

    def timestep_sampling_config(self) -> TimestepSamplingConfig:
        c = self.config
        range_begin, range_end = 0, 0
        if getattr(c, "refiner_training", False) and not getattr(c, "sdxl_refiner_uses_full_range", False):
            # the refiner's window: the low-noise segment [0, strength T), or
            # inverted, the high-noise segment [strength T, T)
            steps = 1000
            strength = float(getattr(c, "refiner_training_strength", 0.2) or 0.2)
            if not 0.0 < strength < 1.0:
                raise ValueError("refiner_training_strength must be in (0, 1)")
            if getattr(c, "refiner_training_invert_schedule", False):
                range_begin, range_end = int(strength * steps), steps
            else:
                range_begin, range_end = 0, int(strength * steps)
        return TimestepSamplingConfig(
            range_begin=range_begin,
            range_end=range_end,
            bias_strategy=getattr(c, "timestep_bias_strategy", "none") or "none",
            bias_multiplier=getattr(c, "timestep_bias_multiplier", 1.0) or 1.0,
            bias_begin=getattr(c, "timestep_bias_begin", 0) or 0,
            bias_end=getattr(c, "timestep_bias_end", 1000) or 1000,
            bias_portion=getattr(c, "timestep_bias_portion", 0.25) or 0.25,
        )

    @property
    def alphas_cumprod(self) -> torch.Tensor:
        """The family's f32 alpha-bar ladder, on the CPU."""
        return self.ddpm_tables(torch.device("cpu"))[0]

    def ddpm_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(alpha-bar ladder, cumulative timestep weights) on ``device``, made
        there the first time (an eager or warm-up step), read afterwards."""
        device = torch.device(device)
        if device not in self._ddpm_tables:
            self._ddpm_tables[device] = (
                make_alphas_cumprod(self.ddpm_schedule_config(), device=device),
                torch.cumsum(timestep_weights(self.timestep_sampling_config(), device=device), dim=0),
            )
        return self._ddpm_tables[device]

    def loss_config(self) -> LossConfig:
        c = self.config
        return LossConfig(
            loss_type=getattr(c, "loss_type", "l2") or "l2",
            huber_schedule=getattr(c, "huber_schedule", "snr") or "snr",
            huber_c=getattr(c, "huber_c", 0.1) or 0.1,
            snr_gamma=getattr(c, "snr_gamma", None),
            soft_min_snr_gamma=getattr(c, "soft_min_snr_gamma", None),
            use_soft_min_snr=bool(getattr(c, "use_soft_min_snr", False)),
            soft_min_snr_sigma_data=float(getattr(c, "soft_min_snr_sigma_data", 1.0) or 1.0),
            prediction_type=self.prediction_type,
        )

    def check_training_config(self) -> None:
        """Refuse the training features of the JAX ``loss_fn`` that are not ported."""
        if self.prediction_type not in ("flow_matching", "epsilon", "v_prediction", "sample"):
            raise ValueError(f"unknown prediction_type {self.prediction_type!r}")
        if not self.is_flow and getattr(self.config, "diff2flow_enabled", False) and \
                getattr(self.config, "diff2flow_loss", False):
            raise NotImplementedError("diff2flow is not ported (ROADMAP Queue 1 item 7)")
        for key in _UNPORTED_TRAINING:
            if getattr(self.config, key, None):
                raise NotImplementedError(f"{key} is not ported")
        if self.lora_rank > 0:
            self.lora_algo  # raises on the adapter options that are not ported

    # ---- training path ---------------------------------------------------------------------
    def transform_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """The family's transform of the cached latents before noising
        (Zlab-i1 normalizes FLUX.2 latents per channel); the identity here."""
        return latents

    def prepare_batch(self, generator: torch.Generator, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Noise, sigmas or timesteps, and the noisy model input.

        ``batch`` holds ``latents`` (B, H, W, C) plus the family's conditioning;
        the latents pass through :meth:`transform_latents` first.  The result
        adds ``noisy_latents``, ``noise``, ``timesteps`` (flow: the sigmas,
        also under ``sigmas``; DDPM: int32 timesteps) and ``target``.
        A batch may carry its own ``override_noise`` and ``override_sigmas`` /
        ``override_timesteps``.  The noise is drawn first, then the sigmas or
        timesteps, from ``generator``."""
        self.check_training_config()
        latents = self.transform_latents(batch["latents"])
        prepared = dict(batch)
        prepared["latents"] = latents
        override_noise = prepared.pop("override_noise", None)
        override_sigmas = prepared.pop("override_sigmas", None)
        override_timesteps = prepared.pop("override_timesteps", None)
        noise = torch.randn(latents.shape, generator=generator, device=latents.device, dtype=torch.float32)
        if override_noise is not None:
            noise = override_noise.float()
        batch_size = latents.shape[0]
        if self.is_flow:
            seq_len = (latents.shape[1] // 2) * (latents.shape[2] // 2) if latents.dim() == 4 else None
            if override_sigmas is not None:
                sigmas = override_sigmas.float()
            else:
                sigmas = sample_flow_sigmas(
                    generator, batch_size, self.flow_schedule_config(), seq_len,
                    global_step=batch.get("global_step"), device=latents.device,
                )
            prepared["sigmas"] = sigmas
            prepared["timesteps"] = sigmas  # flow models take sigma in (0, 1) as the timestep
            prepared["noisy_latents"] = flow_interpolate(latents.float(), noise, sigmas)
            prepared["target"] = flow_target(latents.float(), noise)
        else:
            alphas_cumprod, cdf = self.ddpm_tables(latents.device)
            if override_timesteps is not None:
                timesteps = override_timesteps.to(torch.int32)
            else:
                timesteps = sample_timesteps(generator, batch_size, self.timestep_sampling_config(),
                                             device=latents.device, cdf=cdf).to(torch.int32)
            prepared["timesteps"] = timesteps
            prepared["noisy_latents"] = add_noise(latents.float(), noise, timesteps, alphas_cumprod)
            if self.prediction_type == "v_prediction":
                prepared["target"] = velocity_target(latents.float(), noise, timesteps, alphas_cumprod)
            elif self.prediction_type == "sample":
                prepared["target"] = latents.float()
            else:
                prepared["target"] = noise
        prepared["noise"] = noise
        return prepared

    def compute_loss(self, model_pred: torch.Tensor, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        flow = self.is_flow
        return diffusion_loss(
            model_pred,
            prepared["target"],
            self.loss_config(),
            timesteps=None if flow else prepared["timesteps"],
            alphas_cumprod=None if flow else self.ddpm_tables(model_pred.device)[0],
            sigmas=prepared.get("sigmas"),
            mask=prepared.get("loss_mask"),
            loss_weight=prepared.get("loss_weight"),
        )

    def loss_fn(
        self, module: nn.Module, generator: torch.Generator, batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """prepare -> predict -> loss, the body of the train step."""
        prepared = self.prepare_batch(generator, batch)
        if self.lora_rank > 0 and "is_regularisation_data" in prepared:
            raise NotImplementedError("prior preservation (regularisation data) is not ported")
        loss = self.compute_loss(self.model_predict(module, prepared), prepared)
        return loss, {"timesteps": prepared["timesteps"]}

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def denoise_fn(
        self, module: nn.Module, conditioning: Dict[str, torch.Tensor]
    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        """Returns f(latents, t) -> model_pred for the sampling loop."""

        def fn(latents: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            prepared = dict(conditioning)
            prepared["noisy_latents"] = latents
            prepared["timesteps"] = torch.full(
                (latents.shape[0],), float(t), dtype=torch.float32, device=latents.device
            )
            return self.model_predict(module, prepared)

        return fn

    def supports_multistage_validation(self) -> bool:
        """True in ``<prefix>_validation_pipeline_mode: full-pipeline`` (which
        ``Validation`` refuses, ROADMAP Queue 1 item 4d), as the JAX mixin
        decides it: not with ``validation_using_datasets`` or a ControlNet."""
        if not self.STAGED_VALIDATION_PREFIX:
            return False
        field = f"{self.STAGED_VALIDATION_PREFIX}_validation_pipeline_mode"
        mode = str(getattr(self.config, field, None) or "trained-stage").strip().lower()
        if mode not in ("trained-stage", "full-pipeline"):
            raise ValueError(f"{field} must be one of: full-pipeline, trained-stage")
        if mode != "full-pipeline" or getattr(self.config, "validation_using_datasets", False):
            return False
        return not (getattr(self.config, "controlnet", False) or getattr(self.config, "control", False))

    def check_user_config(self) -> None:
        """Family-specific config validation (``get_model_family`` calls it);
        raises ValueError on a bad combination."""

    # ---- host-side text encoding -----------------------------------------------------------
    def attach_text_encoders(self, encoders: Sequence[Any]) -> None:
        self.text_encoders = list(encoders)

    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, Any]]:
        """Encode prompts -> one embed dict per prompt (the cache payload format)."""
        raise NotImplementedError
