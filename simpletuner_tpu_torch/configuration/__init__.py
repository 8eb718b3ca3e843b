"""The port's configuration: the field registry, the config-file loader, the
dataloader-config parser and ``TrainingConfig``, copied from
``simpletuner_tpu/configuration`` (``TrainingConfig`` leaves the optimizer
name to the port's ``get_optimizer``)."""

from .args import TrainingConfig
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
    "TrainingConfig",
]
