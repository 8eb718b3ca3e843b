"""TrainingConfig — the typed, validated view of the trainer's options.

The torch port's copy of ``simpletuner_tpu/configuration/args.py``: the
registry's defaults under the given values, attribute and ``get`` access,
``to_dict``, the same cross-field checks and ``from_cli`` (a ``--config``
file under ``--key value`` flags).  The optimizer name is checked against
the JAX optimizer registry's names (``training/optimizers.py::JAX_OPTIMIZERS``),
as the JAX class checks it; a name the port does not train is refused by its
``get_optimizer``.  The port does not warn about unwired fields
(``configuration/wiring.py``).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

from .fields import REGISTRY, FieldType
from .loader import coerce_values, load_config, normalize_key


class TrainingConfig:
    """Attribute-style access over a validated config mapping.

    Unknown keys (model-specific extras) are preserved and accessible; missing known
    keys fall back to registry defaults.
    """

    def __init__(self, values: Optional[Dict[str, Any]] = None) -> None:
        object.__setattr__(self, "_values", dict(REGISTRY.defaults()))
        object.__setattr__(self, "_provided", {normalize_key(k) for k in (values or {})})
        if values:
            for key, value in values.items():
                self._values[normalize_key(key)] = value
        self._cross_validate()

    # -- mapping / attribute protocol ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._values[name] = value

    def __contains__(self, name: str) -> bool:
        return normalize_key(name) in self._values

    def get(self, name: str, default: Any = None) -> Any:
        return self._values.get(normalize_key(name), default)

    def was_provided(self, name: str) -> bool:
        """True when the user set this key (vs a registry default)."""
        return normalize_key(name) in object.__getattribute__(self, "_provided")

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    # -- validation -----------------------------------------------------------------------
    def _cross_validate(self) -> None:
        errors: List[str] = []
        v = self._values
        if v.get("controlnet") and v.get("model_type") != "controlnet":
            v["model_type"] = "controlnet"
        if not v.get("max_train_steps") and not v.get("num_train_epochs"):
            v["num_train_epochs"] = v.get("num_train_epochs") or 0
        if v.get("model_type") == "lora" and v.get("lora_rank") and v.get("lora_rank") <= 0:
            errors.append("lora_rank must be positive for model_type=lora")
        if v.get("lora_alpha") is None:
            v["lora_alpha"] = v.get("lora_rank")
        cp = v.get("context_parallel_size") or 1
        if cp < 1:
            errors.append("context_parallel_size must be >= 1")
        if v.get("gradient_accumulation_steps", 1) < 1:
            errors.append("gradient_accumulation_steps must be >= 1")
        if v.get("mixed_precision") == "no":
            v["mixed_precision"] = "fp32"
        optimizer = v.get("optimizer")
        if optimizer:
            from ..training.optimizers import JAX_OPTIMIZERS

            if optimizer not in JAX_OPTIMIZERS:
                errors.append(f"unknown optimizer {optimizer!r}")
        if errors:
            raise ValueError("invalid config: " + "; ".join(errors))

    # -- constructors ------------------------------------------------------------------------
    @classmethod
    def from_file(cls, config_path: Optional[str] = None, **overrides: Any) -> "TrainingConfig":
        return cls(load_config(config_path=config_path, overrides=overrides or None))

    @classmethod
    def from_cli(cls, argv: Optional[List[str]] = None) -> "TrainingConfig":
        parser = build_arg_parser()
        namespace, unknown = parser.parse_known_args(argv)
        file_values: Dict[str, Any] = {}
        if namespace.config is not None:
            file_values = load_config(config_path=namespace.config)
        cli_values = {
            key: value for key, value in vars(namespace).items() if key != "config" and value is not None
        }
        # unknown passthrough: --foo bar pairs
        index = 0
        while index < len(unknown):
            token = unknown[index]
            if token.startswith("--"):
                if "=" in token:
                    key, value = token[2:].split("=", 1)
                    cli_values[normalize_key(key)] = value
                    index += 1
                elif index + 1 < len(unknown) and not unknown[index + 1].startswith("--"):
                    cli_values[normalize_key(token[2:])] = unknown[index + 1]
                    index += 2
                else:
                    cli_values[normalize_key(token[2:])] = True
                    index += 1
            else:
                index += 1
        file_values.update(cli_values)
        return cls(coerce_values(file_values))


def build_arg_parser() -> argparse.ArgumentParser:
    """argparse surface generated from the field registry (flag-per-field)."""
    parser = argparse.ArgumentParser(
        "simpletuner-tpu", description="TPU-native diffusion training", allow_abbrev=False
    )
    parser.add_argument("--config", default=None, help="Path to config.json/toml/env")
    for field in REGISTRY.fields():
        kwargs: Dict[str, Any] = {"default": None, "help": field.help}
        if field.type == FieldType.BOOL:
            kwargs["type"] = str  # coerced later so "false" works like the reference
        elif field.type == FieldType.INT:
            kwargs["type"] = int
        elif field.type == FieldType.FLOAT:
            kwargs["type"] = float
        else:
            kwargs["type"] = str
        parser.add_argument(f"--{field.name}", **kwargs)
    return parser
