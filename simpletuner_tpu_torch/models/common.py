"""Model-family base class: the static contract, LoRA targeting and the
flow-matching training path.

Counterpart of ``simpletuner_tpu/models/common.py::ModelFoundation``.  Where
the JAX methods take a Flax ``variables`` tree, the port takes the
``nn.Module`` that holds its weights; where they take a ``jax.random`` key,
the port takes a ``torch.Generator``.

Ported: the family contract, ``denoise_fn``, the LoRA target predicate
(``lora_target_modules`` / ``_build_lora_target_predicate``), the quantized
base's settings (``base_precision``, ``quantized_matmul``), and the flow
branch of ``prepare_batch`` (with the ``override_noise``/``override_sigmas``
hooks), ``compute_loss`` and ``loss_fn``.  Refused with NotImplementedError:
DDPM (epsilon / v-prediction) training, noise offset, input perturbation,
diff2flow, ReflexFlow, text-encoder training, T-LoRA, scheduled sampling,
prior preservation, REPA/CREPA and TwinFlow.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..training.losses import (
    FlowScheduleConfig,
    LossConfig,
    diffusion_loss,
    flow_interpolate,
    flow_target,
    parse_flow_custom_timesteps,
    sample_flow_sigmas,
)
from ..training.quantization import resolve_precision, resolve_quantized_matmul

# config keys whose training features are not ported: each must be unset
_UNPORTED_TRAINING = (
    "noise_offset", "offset_noise", "input_perturbation", "train_text_encoder",
    "scheduled_sampling_max_steps", "scheduled_sampling_max_step_offset", "urepa_enabled",
    "crepa_enabled", "twinflow_enabled", "distillation_method", "tread_config",
)


class ModelFoundation:
    NAME: str = "base"
    PREDICTION_TYPE: str = "flow_matching"
    REQUIRES_VAE: bool = True
    DEFAULT_FLAVOUR: Optional[str] = None
    # --slider_lora_target: attention-only adapter for concept-slider training
    SLIDER_LORA_TARGET: Sequence[str] = (
        "to_q", "to_k", "to_v", "to_out.0",
        "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out",
    )
    VAE_SCALING_FACTOR: float = 1.0
    VAE_SHIFT_FACTOR: float = 0.0

    def __init__(self, config: Any):
        self.config = config
        self.flavour = getattr(config, "model_flavour", None) or self.DEFAULT_FLAVOUR

    @property
    def is_flow(self) -> bool:
        prediction = getattr(self.config, "prediction_type", None) or self.PREDICTION_TYPE
        return prediction == "flow_matching"

    @property
    def prediction_type(self) -> str:
        return getattr(self.config, "prediction_type", None) or self.PREDICTION_TYPE

    # ---- adapters ----------------------------------------------------------------------
    @property
    def lora_rank(self) -> int:
        if getattr(self.config, "model_type", "lora") == "lora":
            return int(getattr(self.config, "lora_rank", 16) or 16)
        return 0

    @property
    def lora_alpha(self) -> Optional[float]:
        return getattr(self.config, "lora_alpha", None)

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
        through the family LoRA key map (``simpletuner_tpu.training.lora``),
        equals a target or ends with "." + target; a fused projection (Flux
        ``linear1`` = q|k|v|mlp) adapts whole when any of its split names
        matches."""
        targets = self.lora_target_modules()
        if targets is None:
            return None
        from simpletuner_tpu.training.lora import _key_map_for

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
        if not self.is_flow:
            raise NotImplementedError(f"prediction_type={self.prediction_type!r}: only flow matching is ported")
        for key in _UNPORTED_TRAINING:
            if getattr(self.config, key, None):
                raise NotImplementedError(f"{key} is not ported")
        if self.lora_rank > 0:
            self.lora_algo  # raises on the adapter options that are not ported

    # ---- training path ---------------------------------------------------------------------
    def prepare_batch(self, generator: torch.Generator, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Noise, sigmas and the noisy model input (the flow branch).

        ``batch`` holds ``latents`` (B, H, W, C) plus the family's conditioning;
        the result adds ``noisy_latents``, ``noise``, ``sigmas``/``timesteps`` and
        ``target``.  A batch may carry its own ``override_noise`` and
        ``override_sigmas``."""
        self.check_training_config()
        latents = batch["latents"]
        prepared = dict(batch)
        override_noise = prepared.pop("override_noise", None)
        override_sigmas = prepared.pop("override_sigmas", None)
        prepared.pop("override_timesteps", None)
        noise = torch.randn(latents.shape, generator=generator, device=latents.device, dtype=torch.float32)
        if override_noise is not None:
            noise = override_noise.float()
        seq_len = (latents.shape[1] // 2) * (latents.shape[2] // 2) if latents.dim() == 4 else None
        if override_sigmas is not None:
            sigmas = override_sigmas.float()
        else:
            sigmas = sample_flow_sigmas(
                generator, latents.shape[0], self.flow_schedule_config(), seq_len,
                global_step=batch.get("global_step"), device=latents.device,
            )
        prepared["sigmas"] = sigmas
        prepared["timesteps"] = sigmas  # flow models take sigma in (0, 1) as the timestep
        prepared["noisy_latents"] = flow_interpolate(latents.float(), noise, sigmas)
        prepared["target"] = flow_target(latents.float(), noise)
        prepared["noise"] = noise
        return prepared

    def compute_loss(self, model_pred: torch.Tensor, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        return diffusion_loss(
            model_pred,
            prepared["target"],
            self.loss_config(),
            timesteps=None,
            alphas_cumprod=None,
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
