from .model import AuraFlow
from .transformer import AuraFlowConfig, AuraFlowTransformer, find_multiple

__all__ = ["AuraFlow", "AuraFlowConfig", "AuraFlowTransformer", "find_multiple"]
