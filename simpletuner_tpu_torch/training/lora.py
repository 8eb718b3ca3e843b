"""LoRA key maps: the port's module paths onto the diffusers key names.

The torch port's copy of the part of ``simpletuner_tpu/training/lora.py`` it
uses: ``flux_key_map`` (lora.py:76) and ``_key_map_for`` (lora.py:680), which
resolve the ``flux_lora_target`` presets and name the adapters of an export.
The port keeps the JAX submodule names, so one map serves both packages.
"""

from __future__ import annotations

from typing import Any, Dict


def flux_key_map(arch) -> Dict[str, Any]:
    h = arch.hidden_size
    mapping: Dict[str, Any] = {
        "img_in": "x_embedder",
        "txt_in": "context_embedder",
    }
    double = {
        "img_attn_q": "attn.to_q",
        "img_attn_k": "attn.to_k",
        "img_attn_v": "attn.to_v",
        "img_attn_proj": "attn.to_out.0",
        "txt_attn_q": "attn.add_q_proj",
        "txt_attn_k": "attn.add_k_proj",
        "txt_attn_v": "attn.add_v_proj",
        "txt_attn_proj": "attn.to_add_out",
        "img_mlp/proj_in": "ff.net.0.proj",
        "img_mlp/proj_out": "ff.net.2",
        "txt_mlp/proj_in": "ff_context.net.0.proj",
        "txt_mlp/proj_out": "ff_context.net.2",
        # modulation linears (ai-toolkit LoRA target surface)
        "img_mod/lin": "norm1.linear",
        "txt_mod/lin": "norm1_context.linear",
    }
    for layer in range(arch.depth_double):
        for ours, theirs in double.items():
            mapping[f"double_{layer}/{ours}"] = f"transformer_blocks.{layer}.{theirs}"
    mlp_dim = int(h * arch.mlp_ratio)
    for layer in range(arch.depth_single):
        prefix = f"single_transformer_blocks.{layer}"
        mapping[f"single_{layer}/linear1"] = [
            (f"{prefix}.attn.to_q", 0, h),
            (f"{prefix}.attn.to_k", h, 2 * h),
            (f"{prefix}.attn.to_v", 2 * h, 3 * h),
            (f"{prefix}.proj_mlp", 3 * h, 3 * h + mlp_dim),
        ]
        mapping[f"single_{layer}/linear2"] = f"{prefix}.proj_out"
        mapping[f"single_{layer}/modulation/lin"] = f"{prefix}.norm.linear"
    return mapping


# family name -> key map builder, for the families the port has
_KEY_MAPS = {
    "flux": lambda m: flux_key_map(m.arch),
}


def _key_map_for(model) -> Dict[str, Any]:
    builder = _KEY_MAPS.get(model.NAME)
    if builder is not None:
        return builder(model)
    # generic: keep flax path with slashes -> dots
    return {}
