from .model import ACEStep
from .transformer import ACEStepConfig, ACEStepTransformer, lite_la_attention, qwen2_apply_rope, qwen2_rope_tables

__all__ = ["ACEStep", "ACEStepConfig", "ACEStepTransformer", "lite_la_attention", "qwen2_apply_rope",
           "qwen2_rope_tables"]
