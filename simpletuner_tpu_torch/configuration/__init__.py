"""The port's configuration: the field registry, the config-file loader and
the dataloader-config parser, copied from ``simpletuner_tpu/configuration``
(the JAX package's ``TrainingConfig`` is not: its cross-validation reaches the
JAX optimizer registry)."""

from .dataloader import DataloaderConfigError, DatasetConfig, load_dataloader_config
from .fields import REGISTRY, ConfigField, FieldRegistry, FieldType
from .loader import find_config_file, load_config, normalize_key

__all__ = [
    "DataloaderConfigError",
    "DatasetConfig",
    "load_dataloader_config",
    "REGISTRY",
    "ConfigField",
    "FieldRegistry",
    "FieldType",
    "find_config_file",
    "load_config",
    "normalize_key",
]
