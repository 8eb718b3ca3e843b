"""The torch port's own copy of ``simpletuner_tpu/configuration/fields.py``: the port imports
nothing of the JAX package, so it keeps this host code itself.  Keep the
two in step (``tests/test_torch_host_modules.py`` holds them equal).

Typed config-field registry.

The reference generates its argparse CLI, WebUI forms, and documentation from a single
field registry (reference: simpletuner_sdk/server/services/field_registry/registry.py:15,
consumed by helpers/configuration/cmd_args.py:516).  We keep the same idea as a plain
typed registry: every trainer option is a ``ConfigField`` with a name, type, default,
choices and help text.  The CLI parser, the ``TrainingConfig`` dataclass and the docs
generator are all derived from this table, so the public flag surface stays
byte-compatible with the reference (``--model_family``, ``--optimizer``, ...).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class FieldType(enum.Enum):
    STR = "str"
    INT = "int"
    FLOAT = "float"
    BOOL = "bool"
    JSON = "json"  # dict / list parsed from a JSON string or passed through
    STR_LIST = "str_list"  # comma-separated string or list
    STR_OR_LIST = "str_or_list"  # one string, or a list of strings kept intact
    # (no comma splitting — prompts legitimately contain commas)
    PATH_OR_JSON = "path_or_json"  # filesystem path, or an inline parsed list/dict


@dataclasses.dataclass(frozen=True)
class ConfigField:
    name: str
    type: FieldType
    default: Any = None
    choices: Optional[Sequence[Any]] = None
    help: str = ""
    section: str = "general"
    # Validation hook: receives the coerced value, returns an error string or None.
    validator: Optional[Callable[[Any], Optional[str]]] = None
    aliases: Tuple[str, ...] = ()

    def coerce(self, value: Any) -> Any:
        """Coerce a raw (string or JSON) value to this field's python type."""
        if value is None:
            return None
        if self.type == FieldType.BOOL:
            if isinstance(value, bool):
                return value
            if isinstance(value, (int, float)):
                return bool(value)
            text = str(value).strip().lower()
            if text in ("true", "1", "yes", "on"):
                return True
            if text in ("false", "0", "no", "off", ""):
                return False
            raise ValueError(f"{self.name}: cannot interpret {value!r} as bool")
        if self.type == FieldType.INT:
            return int(float(value)) if not isinstance(value, bool) else int(value)
        if self.type == FieldType.FLOAT:
            return float(value)
        if self.type == FieldType.STR:
            return str(value)
        if self.type == FieldType.STR_LIST:
            if isinstance(value, (list, tuple)):
                return [str(v) for v in value]
            return [part.strip() for part in str(value).split(",") if part.strip()]
        if self.type == FieldType.STR_OR_LIST:
            if isinstance(value, (list, tuple)):
                return [str(v) for v in value]
            return str(value)
        if self.type == FieldType.JSON:
            if isinstance(value, (dict, list)):
                return value
            import json

            return json.loads(value)
        if self.type == FieldType.PATH_OR_JSON:
            # inline structures pass through untouched; strings stay paths
            return value if isinstance(value, (dict, list)) else str(value)
        raise ValueError(f"unknown field type {self.type}")


class FieldRegistry:
    """Ordered registry of trainer config fields."""

    def __init__(self) -> None:
        self._fields: Dict[str, ConfigField] = {}
        self._alias_map: Dict[str, str] = {}

    def add(self, field: ConfigField) -> ConfigField:
        if field.name in self._fields:
            raise ValueError(f"duplicate config field {field.name}")
        self._fields[field.name] = field
        for alias in field.aliases:
            self._alias_map[alias] = field.name
        return field

    def get(self, name: str) -> Optional[ConfigField]:
        name = self._alias_map.get(name, name)
        return self._fields.get(name)

    def resolve_name(self, name: str) -> str:
        return self._alias_map.get(name, name)

    def names(self) -> List[str]:
        return list(self._fields)

    def fields(self) -> List[ConfigField]:
        return list(self._fields.values())

    def defaults(self) -> Dict[str, Any]:
        return {f.name: f.default for f in self._fields.values()}


def _positive(name: str) -> Callable[[Any], Optional[str]]:
    def check(value: Any) -> Optional[str]:
        if value is not None and value <= 0:
            return f"{name} must be > 0, got {value}"
        return None

    return check


def _non_negative(name: str) -> Callable[[Any], Optional[str]]:
    def check(value: Any) -> Optional[str]:
        if value is not None and value < 0:
            return f"{name} must be >= 0, got {value}"
        return None

    return check


REGISTRY = FieldRegistry()


def _f(
    name: str,
    type: FieldType,
    default: Any = None,
    choices: Optional[Sequence[Any]] = None,
    help: str = "",
    section: str = "general",
    validator: Optional[Callable[[Any], Optional[str]]] = None,
    aliases: Tuple[str, ...] = (),
) -> None:
    REGISTRY.add(
        ConfigField(
            name=name,
            type=type,
            default=default,
            choices=choices,
            help=help,
            section=section,
            validator=validator,
            aliases=aliases,
        )
    )


# --- model selection -----------------------------------------------------------------
_f("model_family", FieldType.STR, None, help="Model family id (flux, sdxl, sd1x, ...)", section="model")
_f("model_flavour", FieldType.STR, None, help="Named flavour within the family (e.g. dev, schnell)", section="model")
_f(
    "model_type",
    FieldType.STR,
    "lora",
    # reference exposes ControlNet as the --controlnet bool (field registry
    # sections/model.py:105) with model_type full/lora; "controlnet" is also
    # accepted directly as the internal canonical form
    choices=["full", "lora", "controlnet"],
    help="Train the full model, a LoRA adapter, or a ControlNet branch",
    section="model",
)
_f("pretrained_model_name_or_path", FieldType.STR, None, help="Base model repo id or local path", section="model")
_f("pretrained_vae_model_name_or_path", FieldType.STR, None, section="model")
_f("pretrained_transformer_model_name_or_path", FieldType.STR, None, section="model")
_f("pretrained_unet_model_name_or_path", FieldType.STR, None, section="model")
_f("pretrained_text_encoder_model_name_or_path", FieldType.STR, None, section="model")
_f(
    "allow_untrained_init",
    FieldType.BOOL,
    False,
    help="Permit random-weight initialization when no pretrained checkpoint path "
    "resolves (pretraining from scratch / research runs). Without this flag a "
    "non-tiny run with missing weights fails loudly instead of silently "
    "fine-tuning noise.",
    section="model",
)
_f("revision", FieldType.STR, None, section="model")
_f("variant", FieldType.STR, None, section="model")
_f(
    "prediction_type",
    FieldType.STR,
    None,
    choices=["epsilon", "v_prediction", "flow_matching", "sample"],
    help="Override the model family's native prediction type",
    section="model",
)
_f("controlnet", FieldType.BOOL, False, section="model")
_f("control", FieldType.BOOL, False, help="Channel-wise control conditioning (instead of ControlNet)", section="model")

# --- LoRA / adapters ------------------------------------------------------------------
_f("lora_type", FieldType.STR, "standard", choices=["standard", "lycoris", "singlora"], section="lora")
_f("lora_rank", FieldType.INT, 16, validator=_non_negative("lora_rank"), section="lora")
_f("lora_alpha", FieldType.FLOAT, None, help="Defaults to lora_rank when unset", section="lora")
_f("lora_dropout", FieldType.FLOAT, 0.0, section="lora")
_f("lora_init_type", FieldType.STR, "default", choices=["default", "gaussian", "loftq", "olora", "pissa"], section="lora")
_f("init_lora", FieldType.STR, None, help="Path to an existing LoRA safetensors file to resume training from", section="lora")
_f("peft_lora_mode", FieldType.STR, "standard", choices=["standard", "singlora"], section="lora")
_f("lycoris_config", FieldType.STR, "config/lycoris_config.json", section="lora")
_f("slider_lora_target_strength", FieldType.FLOAT, 1.0, section="lora")
_f("slider_lora_negative_strength", FieldType.FLOAT, -1.0, section="lora")

# --- data -----------------------------------------------------------------------------
_f("data_backend_config", FieldType.PATH_OR_JSON, "config/multidatabackend.json", section="data")
_f("aspect_bucket_rounding", FieldType.INT, 2, section="data")
_f("aspect_bucket_alignment", FieldType.INT, 64, choices=[8, 16, 32, 64], section="data")
_f("resolution", FieldType.FLOAT, 1024, section="data")
_f(
    "resolution_type",
    FieldType.STR,
    "pixel_area",
    choices=["pixel", "area", "pixel_area"],
    section="data",
)
_f("minimum_image_size", FieldType.FLOAT, None, section="data")
_f("maximum_image_size", FieldType.FLOAT, None, section="data")
_f("target_downsample_size", FieldType.FLOAT, None, section="data")
_f("train_batch_size", FieldType.INT, 1, validator=_positive("train_batch_size"), section="data")
_f("dataloader_prefetch", FieldType.BOOL, False, section="data")
_f("dataloader_prefetch_qlen", FieldType.INT, 10, section="data")
_f("caption_dropout_probability", FieldType.FLOAT, 0.0, section="data")
_f("caption_strategy", FieldType.STR, "filename", choices=["filename", "textfile", "parquet", "instanceprompt", "csv"], section="data")
_f("instance_prompt", FieldType.STR, None, section="data")
_f("vae_batch_size", FieldType.INT, 4, section="data")
_f("vae_cache_disable", FieldType.BOOL, False, section="data")
_f("vae_cache_ondemand", FieldType.BOOL, False, section="data")
_f("text_cache_disable", FieldType.BOOL, False, section="data")
_f("text_encoder_batch_size", FieldType.INT, 4, section="data")
_f("write_batch_size", FieldType.INT, 128, section="data")
_f("read_batch_size", FieldType.INT, 25, section="data")
_f("image_processing_batch_size", FieldType.INT, 32, section="data")
_f("enable_multiprocessing", FieldType.BOOL, False, section="data")
_f("max_workers", FieldType.INT, 32, section="data")
_f("metadata_update_interval", FieldType.INT, 3600, section="data")
_f("delete_problematic_images", FieldType.BOOL, False, section="data")
_f("skip_file_discovery", FieldType.STR, "", section="data")
_f("cache_dir", FieldType.STR, "cache", section="data")
_f("compress_disk_cache", FieldType.BOOL, False, section="data")

# --- training loop --------------------------------------------------------------------
_f("max_train_steps", FieldType.INT, 0, section="training")
_f("num_train_epochs", FieldType.INT, 0, section="training")
_f("seed", FieldType.INT, 42, section="training")
_f("gradient_accumulation_steps", FieldType.INT, 1, validator=_positive("gradient_accumulation_steps"), section="training")
_f("gradient_checkpointing", FieldType.BOOL, False, section="training")
_f("gradient_checkpointing_interval", FieldType.INT, None, section="training")
_f("learning_rate", FieldType.FLOAT, 1e-4, section="training")
_f("text_encoder_lr", FieldType.FLOAT, None, section="training")
_f(
    "lr_scheduler",
    FieldType.STR,
    "constant",
    choices=[
        "constant",
        "constant_with_warmup",
        "cosine",
        "cosine_with_restarts",
        "cosine_annealing_hard_restarts",
        "linear",
        "polynomial",
        "sine",
    ],
    section="training",
)
_f("lr_warmup_steps", FieldType.INT, 0, section="training")
_f("lr_num_cycles", FieldType.INT, 1, section="training")
_f("lr_power", FieldType.FLOAT, 1.0, section="training")
_f("lr_end", FieldType.FLOAT, 1e-7, section="training")
_f("optimizer", FieldType.STR, "adamw_bf16", section="training")
_f("optimizer_config", FieldType.STR, None, help="Comma-separated key=value optimizer overrides", section="training")
_f("optimizer_beta1", FieldType.FLOAT, None, section="training")
_f("optimizer_beta2", FieldType.FLOAT, None, section="training")
_f("optimizer_release_gradients", FieldType.BOOL, False, section="training")
_f("adam_beta1", FieldType.FLOAT, 0.9, section="training")
_f("adam_beta2", FieldType.FLOAT, 0.999, section="training")
_f("adam_weight_decay", FieldType.FLOAT, 1e-2, section="training")
_f("adam_epsilon", FieldType.FLOAT, 1e-8, section="training")
_f("max_grad_norm", FieldType.FLOAT, 1.0, section="training")
_f("grad_clip_method", FieldType.STR, "norm", choices=["norm", "value"], section="training")
_f("train_text_encoder", FieldType.BOOL, False, section="training")
_f("tokenizer_max_length", FieldType.INT, None, section="training")
_f("ignore_final_epochs", FieldType.BOOL, False, section="training")

# --- loss -----------------------------------------------------------------------------
_f("loss_type", FieldType.STR, "l2", choices=["l2", "huber", "smooth_l1"], section="loss")
_f("huber_schedule", FieldType.STR, "snr", choices=["snr", "exponential", "constant"], section="loss")
_f("huber_c", FieldType.FLOAT, 0.1, section="loss")
_f("snr_gamma", FieldType.FLOAT, None, section="loss")
_f("masked_loss_probability", FieldType.FLOAT, 1.0, section="loss")
_f("soft_min_snr_gamma", FieldType.FLOAT, None, section="loss")

# --- flow matching --------------------------------------------------------------------
_f("flow_schedule_shift", FieldType.FLOAT, None, section="flow")
_f("flow_schedule_auto_shift", FieldType.BOOL, False, section="flow")
_f(
    "flow_sigmoid_scale",
    FieldType.FLOAT,
    1.0,
    help="Scale factor for sigmoid timestep sampling for flow-matching models",
    section="flow",
)
_f(
    "flow_use_uniform_schedule",
    FieldType.BOOL,
    False,
    section="flow",
)
_f("flow_use_beta_schedule", FieldType.BOOL, False, section="flow")
_f("flow_beta_schedule_alpha", FieldType.FLOAT, 2.0, section="flow")
_f("flow_beta_schedule_beta", FieldType.FLOAT, 2.0, section="flow")
_f("flux_guidance_mode", FieldType.STR, "constant", choices=["constant", "random-range"], section="flow")
_f("flux_guidance_value", FieldType.FLOAT, 1.0, section="flow")
_f("flux_guidance_min", FieldType.FLOAT, 0.0, section="flow")
_f("flux_guidance_max", FieldType.FLOAT, 4.0, section="flow")

# --- timestep sampling (epsilon / v-pred) ----------------------------------------------
_f(
    "timestep_bias_strategy",
    FieldType.STR,
    "none",
    choices=["none", "earlier", "later", "range"],
    section="timesteps",
)
_f("timestep_bias_multiplier", FieldType.FLOAT, 1.0, section="timesteps")
_f("timestep_bias_begin", FieldType.INT, 0, section="timesteps")
_f("timestep_bias_end", FieldType.INT, 1000, section="timesteps")
_f("timestep_bias_portion", FieldType.FLOAT, 0.25, section="timesteps")
_f("training_scheduler_timestep_spacing", FieldType.STR, "trailing", choices=["leading", "linspace", "trailing"], section="timesteps")
_f("rescale_betas_zero_snr", FieldType.BOOL, False, section="timesteps")
_f("refiner_training", FieldType.BOOL, False, section="timesteps")
_f("refiner_training_strength", FieldType.FLOAT, 0.2, section="timesteps")

# --- precision / memory ----------------------------------------------------------------
_f("mixed_precision", FieldType.STR, "bf16", choices=["bf16", "fp32", "no"], section="precision")
_f(
    "base_model_precision",
    FieldType.STR,
    "no_change",
    help="Base (frozen) model quantization: no_change | int8-quanto | int8 | fp8 | nf4 ...",
    section="precision",
)
_f(
    "quantized_matmul",
    FieldType.STR,
    "auto",
    choices=["off", "forward", "full", "auto"],
    help="Run int8-base matmuls on the int8 MXU path (2x bf16 peak): "
         "forward = int8 fwd only, full = int8 fwd + int8 dx backward, "
         "auto (default) = full for int8/int4 bases, off otherwise",
    section="precision",
)
_f("text_encoder_precision", FieldType.STR, None, section="precision")
_f("quantize_via", FieldType.STR, "accelerator", choices=["cpu", "accelerator"], section="precision")
_f("keep_vae_loaded", FieldType.BOOL, False, section="precision")
_f("unload_text_encoders", FieldType.BOOL, True, aliases=("unload_text_encoder",), section="precision")
_f("offload_during_startup", FieldType.BOOL, False, section="precision")

# --- EMA -------------------------------------------------------------------------------
_f("use_ema", FieldType.BOOL, False, section="ema")
_f("ema_decay", FieldType.FLOAT, 0.9999, section="ema")
_f("ema_update_interval", FieldType.INT, None, section="ema")
_f("ema_device", FieldType.STR, "accelerator", choices=["accelerator", "cpu"], section="ema")
_f("ema_validation", FieldType.STR, "comparison", choices=["none", "ema_only", "comparison"], section="ema")
_f("ema_foreach_disable", FieldType.BOOL, False, section="ema")

# --- checkpointing ----------------------------------------------------------------------
_f("output_dir", FieldType.STR, "output/models", section="checkpoint")
_f("checkpoint_step_interval", FieldType.INT, 500, aliases=("checkpointing_steps",), section="checkpoint")
_f("checkpoint_epoch_interval", FieldType.INT, None, section="checkpoint")
_f("checkpointing_rolling_steps", FieldType.INT, 0, section="checkpoint")
_f("checkpointing_use_tempdir", FieldType.BOOL, False, section="checkpoint")
_f("checkpoints_total_limit", FieldType.INT, None, section="checkpoint")
_f("checkpoints_rolling_total_limit", FieldType.INT, 1, section="checkpoint")
_f("resume_from_checkpoint", FieldType.STR, None, section="checkpoint")

# --- validation -------------------------------------------------------------------------
_f("validation_step_interval", FieldType.INT, None, aliases=("validation_steps",), section="validation")
_f("validation_epoch_interval", FieldType.INT, None, section="validation")
_f("validation_prompt", FieldType.STR_OR_LIST, None,
   help="Validation prompt, or a list of prompts (rendered per interval)", section="validation")
_f("validation_negative_prompt", FieldType.STR, "blurry, cropped, ugly", section="validation")
_f("validation_resolution", FieldType.STR, "256x256", section="validation")
_f("validation_seed", FieldType.INT, None, section="validation")
_f("validation_num_inference_steps", FieldType.INT, 20, section="validation")
_f("validation_guidance", FieldType.FLOAT, 3.0, section="validation")
_f("validation_guidance_rescale", FieldType.FLOAT, 0.0, section="validation")
_f("validation_guidance_real", FieldType.FLOAT, 1.0, section="validation")
_f("validation_no_cfg_until_timestep", FieldType.INT, 2, section="validation")
_f("validation_num_video_frames", FieldType.INT, None, section="validation")
_f("num_validation_images", FieldType.INT, 1, section="validation")
_f("validation_disable", FieldType.BOOL, False, section="validation")
_f("validation_prompt_library", FieldType.BOOL, False, section="validation")
_f("user_prompt_library", FieldType.STR, None, section="validation")
_f("eval_steps_interval", FieldType.INT, None, section="validation")
_f("eval_timesteps", FieldType.INT, 28, section="validation")
_f("num_eval_images", FieldType.INT, 4, section="validation")
_f("eval_dataset_id", FieldType.STR, None, section="validation")
_f("disable_benchmark", FieldType.BOOL, False, section="validation")

# --- parallelism (TPU mesh axes) ---------------------------------------------------------
_f("fsdp", FieldType.BOOL, False, help="Shard params/grads/optimizer over the fsdp mesh axis", section="parallel")
_f("fsdp_size", FieldType.INT, None, help="Devices on the fsdp axis (defaults to all)", section="parallel")
_f("context_parallel_size", FieldType.INT, 1, section="parallel")
_f(
    "context_parallel_comm_strategy",
    FieldType.STR,
    "allgather",
    choices=["allgather", "alltoall"],
    help="ring (allgather) or Ulysses (alltoall) context parallelism",
    section="parallel",
)
_f("tensor_parallel_size", FieldType.INT, 1, section="parallel")
_f("dp_replicate_size", FieldType.INT, None, section="parallel")

# --- acceleration -------------------------------------------------------------------------
_f(
    "attention_mechanism",
    FieldType.STR,
    "auto",
    help="auto | pallas_flash | xla | splash | sla (reference aliases map on)",
    section="acceleration",
)
_f("sageattention_usage", FieldType.STR, "untrained", section="acceleration")
_f("tread_config", FieldType.JSON, None, help="TREAD token-dropout router config", section="acceleration")
_f("flowmap_gate", FieldType.FLOAT, None, help="FlowMap interval-embedding gate (AnyFlow; enables a delta time embedder)", section="distillation")
_f(
    "flowmap_deltatime_type",
    FieldType.STR,
    None,
    choices=["r", "t-r"],
    help="FlowMap delta-time parameterisation: embed r itself or the width t-r",
    section="distillation",
)
_f("fuse_qkv_projections", FieldType.BOOL, False, section="acceleration",
   help="Accepted for config compatibility; on TPU XLA already fuses the "
        "Q/K/V GEMMs that share an input operand, so this is a no-op")

# --- observability --------------------------------------------------------------------------
_f("report_to", FieldType.STR, "none", help="wandb|tensorboard|none|comma-separated", section="observability")
_f("tracker_project_name", FieldType.STR, "simpletuner-tpu", section="observability")
_f("tracker_run_name", FieldType.STR, None, section="observability")
_f("logging_dir", FieldType.STR, "logs", section="observability")
_f("webhook_config", FieldType.STR, None, section="observability")
_f("webhook_reporting_interval", FieldType.INT, None, section="observability")
_f("progress_update_interval", FieldType.INT, 10, section="observability")

# --- hub / publishing ------------------------------------------------------------------------
_f("push_to_hub", FieldType.BOOL, False, section="publishing")
_f("push_checkpoints_to_hub", FieldType.BOOL, False, section="publishing")
_f("hub_model_id", FieldType.STR, None, section="publishing")
_f("model_card_private", FieldType.BOOL, False, section="publishing")
_f("model_card_note", FieldType.STR, None, section="publishing")
_f("modelspec_trigger_words", FieldType.STR_LIST, None, section="publishing")

# --- distillation ------------------------------------------------------------------------------
_f(
    "distillation_method",
    FieldType.STR,
    None,
    choices=["lcm", "teacher_matching", "dcm", "dmd", "perflow", "flow_dpo", "self_forcing", "anyflow"],
    section="distillation",
)
_f("distillation_config", FieldType.JSON, None, section="distillation")
_f(
    "distillation_cache_num_pairs",
    FieldType.INT,
    32,
    help="Teacher ODE pairs to materialise when a distillation_cache dataset is empty",
    section="distillation",
)
_f(
    "distillation_cache_ode_steps",
    FieldType.INT,
    8,
    help="Euler steps for the teacher probability-flow solve when generating ODE pairs",
    section="distillation",
)

# --- misc ---------------------------------------------------------------------------------------
_f("allow_tf32", FieldType.BOOL, True, section="misc")
_f("disable_tf32", FieldType.BOOL, False, section="misc")
_f("noise_offset", FieldType.FLOAT, 0.0, section="misc")
_f("noise_offset_probability", FieldType.FLOAT, 0.25, section="misc")
_f("input_perturbation", FieldType.FLOAT, 0.0, section="misc")
_f("input_perturbation_steps", FieldType.INT, 0, section="misc")
_f("offset_noise", FieldType.BOOL, False, section="misc")
_f("diff2flow_enabled", FieldType.BOOL, False, section="misc")

# --- tpu-build additions (registered so CLI flags + OPTIONS.md cover them) ----------------------
_f("layersync_gamma", FieldType.FLOAT, 0.0, help="LayerSync hidden-state regularizer weight", section="loss")
_f("layersync_source_layer", FieldType.INT, 2, section="loss")
_f("layersync_target_layer", FieldType.INT, -1, section="loss")
_f("crepa_weight", FieldType.FLOAT, 0.0, help="CREPA teacher-alignment weight (needs conditioning_image_embeds)", section="loss")
_f("crepa_layer", FieldType.INT, 8, section="loss")
_f("moe_gate_loss_weight", FieldType.FLOAT, 0.01, help="MoE gate load-balance aux weight (hidream)", section="loss")
_f("scheduled_sampling_max_steps", FieldType.INT, 0, help="Self-rollout steps for exposure-bias training", section="loss")
_f("scheduled_sampling_probability", FieldType.FLOAT, 0.5, section="loss")
_f("scheduled_sampling_step_size", FieldType.FLOAT, 0.05, section="loss")
_f("scheduled_sampling_reflexflow", FieldType.BOOL, None, help="ReflexFlow exposure weighting (default on with scheduled sampling on flow models)", section="loss")
_f("scheduled_sampling_reflexflow_alpha", FieldType.FLOAT, 1.0, section="loss")
_f("scheduled_sampling_reflexflow_beta1", FieldType.FLOAT, 10.0, help="ReflexFlow angular direction-regression scale", section="loss")
_f("scheduled_sampling_reflexflow_beta2", FieldType.FLOAT, 1.0, section="loss")
_f("twinflow_enabled", FieldType.BOOL, False, help="TwinFlow RCGM consistency aux losses for few-step flow models", section="loss")
_f("twinflow_estimate_order", FieldType.INT, 2, section="loss")
_f("twinflow_delta_t", FieldType.FLOAT, 0.01, section="loss")
_f("twinflow_target_clamp", FieldType.FLOAT, 1.0, section="loss")
_f("twinflow_realvel_weight", FieldType.FLOAT, 1.0, section="loss")
_f("twinflow_adversarial_enabled", FieldType.BOOL, False, help="negative-time twin stage (not ported; fails loudly)", section="loss")
_f("urepa_enabled", FieldType.BOOL, False, help="U-REPA mid-block alignment for UNets (teacher features from cache)", section="loss")
_f("urepa_lambda", FieldType.FLOAT, 0.5, section="loss")
_f("urepa_manifold_weight", FieldType.FLOAT, 3.0, section="loss")
_f("max_grounding_entities", FieldType.INT, 0, help="GLIGEN bbox grounding slots per sample (UNet families); 0 = off", section="model")
_f("enable_nsfw_check", FieldType.BOOL, False, help="Scan and reject NSFW images during VAE caching", section="data")
_f("nsfw_check_models", FieldType.STR, None, help="CSV of model_id:threshold classifier specs", section="data")
_f("nsfw_check_min_votes", FieldType.INT, 1, section="data")
_f("validation_using_datasets", FieldType.BOOL, False, help="img2img validation seeded from training-set latents", section="validation")
_f("validation_strength", FieldType.FLOAT, 0.2, help="img2img denoise strength (fraction of steps run)", section="validation")
_f("validation_adapters", FieldType.JSON, None, help="Extra LoRA adapters to sweep during validation: [{path, strength, label}]", section="validation")
_f(
    "validation_adapter_mode",
    FieldType.STR,
    "comparison",
    choices=["comparison", "adapter_only", "none"],
    section="validation",
)
_f(
    "validation_method",
    FieldType.STR,
    "simpletuner-local",
    choices=["simpletuner-local", "external-script"],
    section="validation",
)
_f("validation_external_script", FieldType.STR, None, help="Command template with {local_checkpoint_path}/{global_step}/... placeholders", section="validation")
_f("validation_external_background", FieldType.BOOL, False, section="validation")
_f("checkpointing_use_async", FieldType.BOOL, False, help="Finalize checkpoints on a background thread", section="checkpoint")
_f("slider_positive_prompt", FieldType.STR, None, help="Slider LoRA: positive-polarity prompt", section="model")
_f("slider_negative_prompt", FieldType.STR, None, help="Slider LoRA: negative-polarity prompt", section="model")
_f("assistant_lora_path", FieldType.STR, None, help="Frozen guidance adapter merged into the base at load", section="model")
_f("assistant_lora_scale", FieldType.FLOAT, 1.0, section="model")
_f("validation_preview", FieldType.BOOL, False, help="Save intermediate-step preview strips during validation", section="validation")
_f("validation_parallel", FieldType.BOOL, False,
   help="Render all validation prompts in one batched pass sharded over the mesh "
        "(data/fsdp axes; attention rides the context axis when enabled)", section="validation")
_f("validation_preview_tae_path", FieldType.STR, None,
   help="taesd decoder safetensors for cheap preview decoding (full VAE used when unset)", section="validation")
_f("validation_negative_prompt_2", FieldType.STR, None, section="validation")
_f("validation_audio_duration", FieldType.FLOAT, 5.0, section="validation")
_f("validation_audio_sample_rate", FieldType.INT, 44100, section="validation")
_f("profile_steps", FieldType.STR, None, help="jax.profiler trace window, e.g. '10-15'", section="observability")
_f("disk_space_threshold_gb", FieldType.FLOAT, 5.0, section="observability")
_f("disk_space_action", FieldType.STR, "warn", choices=["warn", "stop"], section="observability")
_f("compile_cache_dir", FieldType.STR, None, help="Persistent XLA compile cache directory", section="acceleration")
_f("gradient_checkpointing_policy", FieldType.STR, "full",
   choices=["full", "dots", "attn", "attn_all", "single"],
   help="Remat policy (attn = save flash-attention outputs across the remat boundary; "
        "single = remat only single-stream blocks)",
   section="acceleration")
_f("gradient_checkpointing_skip_last", FieldType.INT, 0,
   help="Mixed remat: the last N single-stream blocks keep activations (no remat) — "
        "buys back recompute FLOPs when HBM headroom allows (e.g. int4 base)",
   section="acceleration")
_f("use_ema_for_validation", FieldType.BOOL, False, section="validation")
_f("controlnet_depth", FieldType.INT, 2, help="ControlNet branch depth (DiT families)", section="model")
_f("image_embed_model", FieldType.STR, None, help="CLIP-vision repo for image-embed caches", section="data")
_f("s2v_audio_feature_dim", FieldType.INT, 64, section="model")


# --- extended reference surface (generated; see fields_extended.py) -------------------
from .fields_extended import register as _register_extended

_register_extended(_f, FieldType)
