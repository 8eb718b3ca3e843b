from .attention import (
    dot_product_attention,
    get_attention_backend,
    set_attention_backend,
    set_context_parallel,
)
from .flash_attention import (
    DEFAULT_MASK_VALUE,
    SEGMENT_PAD_ID,
    flash_attention,
    flash_backward,
    flash_bwd_dkv_kernel,
    flash_bwd_dq_kernel,
    flash_fwd_kernel,
    mha_backward_reference,
    mha_reference,
    mha_reference_lse,
)
from .rope import apply_rope, axial_rope, rope_frequencies
