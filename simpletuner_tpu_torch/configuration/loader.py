"""The torch port's own copy of ``simpletuner_tpu/configuration/loader.py``: the port imports
nothing of the JAX package, so it keeps this host code itself.  Keep the
two in step (``tests/test_torch_host_modules.py`` holds them equal).

Config file loading.

Mirrors the reference's precedence and normalization rules
(reference: helpers/configuration/loader.py:16-55):

* a config directory (default ``config/``, overridable with ``SIMPLETUNER_ENV`` to pick
  ``config/<env>/``) is searched for ``config.json`` → ``config.toml`` → ``config.env``;
* keys may be written ``--key`` (the reference's config.json.example style), ``key``, or
  ``TRAINER_EXTRA_ARGS``-style env lines;
* environment variables of the form ``SIMPLETUNER_<UPPER_KEY>`` override file values;
* values pass through the field registry for type coercion.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional

from .fields import REGISTRY

_ENV_LINE = re.compile(r"^\s*(?:export\s+)?([A-Za-z_][A-Za-z0-9_]*)=(.*)$")


def normalize_key(key: str) -> str:
    key = key.strip()
    while key.startswith("-"):
        key = key[1:]
    return REGISTRY.resolve_name(key)


def _strip_quotes(value: str) -> str:
    value = value.strip()
    if len(value) >= 2 and value[0] == value[-1] and value[0] in "'\"":
        return value[1:-1]
    return value


def load_env_file(path: Path) -> Dict[str, Any]:
    """Parse a ``config.env`` file (KEY=VALUE lines, TRAINER_EXTRA_ARGS supported)."""
    raw: Dict[str, Any] = {}
    extra_args: str = ""
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        match = _ENV_LINE.match(line)
        if not match:
            continue
        key, value = match.group(1), _strip_quotes(match.group(2))
        if key == "TRAINER_EXTRA_ARGS":
            extra_args += " " + value
            continue
        # The reference's config.env style: TRAIN_BATCH_SIZE=1, RESOLUTION=1024 ...
        raw[key.lower()] = value
    for token in extra_args.split("--"):
        token = token.strip()
        if not token:
            continue
        if "=" in token:
            key, value = token.split("=", 1)
        elif " " in token:
            key, value = token.split(" ", 1)
        else:
            key, value = token, "true"
        raw[key.strip()] = _strip_quotes(value)
    return raw


def load_toml_file(path: Path) -> Dict[str, Any]:
    import tomllib

    with path.open("rb") as handle:
        return tomllib.load(handle)


def load_json_file(path: Path) -> Dict[str, Any]:
    return json.loads(path.read_text())


def find_config_file(config_dir: str = "config", env: Optional[str] = None) -> Optional[Path]:
    env = env or os.environ.get("SIMPLETUNER_ENV") or os.environ.get("ENV")
    base = Path(config_dir)
    if env and env not in (".", "default"):
        base = base / env
    for name in ("config.json", "config.toml", "config.env"):
        candidate = base / name
        if candidate.exists():
            return candidate
    return None


def load_config_values(path: Path) -> Dict[str, Any]:
    """Load raw key→value mapping from a config file of any supported format."""
    suffix = path.suffix.lower()
    if suffix == ".json":
        raw = load_json_file(path)
    elif suffix == ".toml":
        raw = load_toml_file(path)
    elif suffix == ".env":
        raw = load_env_file(path)
    else:
        raise ValueError(f"unsupported config format: {path}")
    return {normalize_key(str(key)): value for key, value in raw.items()}


def apply_env_overrides(values: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(values)
    for key, value in os.environ.items():
        if not key.startswith("SIMPLETUNER_CONFIG_"):
            continue
        out[normalize_key(key[len("SIMPLETUNER_CONFIG_"):].lower())] = value
    return out


def coerce_values(values: Dict[str, Any], strict: bool = False) -> Dict[str, Any]:
    """Run raw values through the field registry; unknown keys pass through untouched."""
    coerced: Dict[str, Any] = {}
    errors = []
    for key, value in values.items():
        field = REGISTRY.get(key)
        if field is None:
            if strict:
                errors.append(f"unknown config key: {key}")
            coerced[key] = value
            continue
        try:
            value = field.coerce(value)
        except (ValueError, TypeError) as exc:
            errors.append(str(exc))
            continue
        if field.choices and value is not None and value not in field.choices:
            errors.append(f"{key}: {value!r} not in {list(field.choices)}")
            continue
        if field.validator:
            message = field.validator(value)
            if message:
                errors.append(message)
                continue
        coerced[field.name] = value
    if errors:
        raise ValueError("invalid config: " + "; ".join(errors))
    return coerced


def load_config(
    config_path: Optional[str] = None,
    config_dir: str = "config",
    overrides: Optional[Dict[str, Any]] = None,
    strict: bool = False,
) -> Dict[str, Any]:
    """Full pipeline: locate file → parse → env overrides → coercion. Returns dict of values."""
    values: Dict[str, Any] = {}
    path = Path(config_path) if config_path else find_config_file(config_dir)
    if path is not None:
        values.update(load_config_values(path))
    if overrides:
        values.update({normalize_key(k): v for k, v in overrides.items()})
    values = apply_env_overrides(values)
    return coerce_values(values, strict=strict)
