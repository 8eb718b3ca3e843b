from .manager import PublishingManager
from .metadata import build_model_card, safetensors_modelspec

__all__ = ["PublishingManager", "build_model_card", "safetensors_modelspec"]
