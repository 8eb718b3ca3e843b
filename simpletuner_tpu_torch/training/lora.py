"""LoRA key maps and adapter files in the PEFT (diffusers) and ComfyUI layouts.

The torch port's copy of the part of ``simpletuner_tpu/training/lora.py`` it
uses: ``flux_key_map`` (lora.py:76), ``unet_key_map`` (lora.py:116; sdxl,
sd1x and sd2x), ``sd3_key_map`` (lora.py:158), ``pixart_key_map``
(lora.py:336), ``wan_key_map`` (lora.py:316), ``auraflow_key_map`` (lora.py:561),
``ltx_key_map`` (lora.py:589), ``lumina2_key_map`` (lora.py:468; chroma takes
``flux_key_map``, lora.py:651), ``kandinsky5_key_map`` (lora.py:289; both
Kandinsky flavours), ``hunyuanvideo_key_map`` (lora.py:620), ``flux2_key_map``
(lora.py:419; kolors takes ``unet_key_map``, lora.py:655), ``krea2_key_map``
(lora.py:276), ``cosmos1_core_key_map`` (lora.py:215; cosmos), ``anima_key_map``
(lora.py:232), ``ernie_key_map`` (lora.py:252), ``ideogram_key_map`` (lora.py:264;
omnigen has no map, so its adapter files carry the flattened module paths, as in
the JAX package), ``longcat_video_key_map`` (lora.py:201), ``sana_key_map``
(lora.py:547), ``sanavideo_key_map`` (lora.py:237), ``cosmos3_key_map``
(lora.py:354), ``ltx2_key_map`` (lora.py:375) and ``acestep_key_map``
(lora.py:398; wan_s2v takes ``wan_key_map``, lora.py:659), and ``_key_map_for``
(lora.py:680), which resolve the LoRA target presets and
name the adapters of an export (the maps leave ``patch_in`` and
``context_in`` under their own names, as the JAX export does),
and the plain-LoRA path of the adapter files: ``lora_state_dict`` (:693),
``_emit``, ``save_lora_safetensors`` (:764) and ``load_lora_safetensors``
(:790-907), written with the port's own safetensors reader and writer.  The
port keeps the JAX submodule names, so one map serves both packages, and the
port's adapters are already in the torch orientation of a file: ``lora_A``
(r, in) and ``lora_B`` (out, r).  A file saved here loads into the JAX
package and back.  LyCORIS layouts (LoKr, LoHa, (IA)^3) and DoRA magnitudes
are not ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Union

import torch
from torch import nn

from ..models.layers import lora_parameters
from ..models.weight_import import load_safetensors_file, save_safetensors


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


def unet_key_map(arch) -> Dict[str, Any]:
    """diffusers ``UNet2DConditionModel`` paths (sdxl; sd1x/sd2x/kolors share them)."""
    mapping: Dict[str, Any] = {}
    levels = len(arch.block_out_channels)

    def spatial(ours: str, theirs: str, depth: int) -> None:
        for i in range(depth):
            for attn in ("attn1", "attn2"):
                for proj, tproj in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out", "to_out.0")):
                    mapping[f"{ours}/blocks_{i}/{attn}/{proj}"] = f"{theirs}.transformer_blocks.{i}.{attn}.{tproj}"
            mapping[f"{ours}/blocks_{i}/ff_proj"] = f"{theirs}.transformer_blocks.{i}.ff.net.0.proj"
            mapping[f"{ours}/blocks_{i}/ff_out"] = f"{theirs}.transformer_blocks.{i}.ff.net.2"
        mapping[f"{ours}/proj_in"] = f"{theirs}.proj_in"
        mapping[f"{ours}/proj_out"] = f"{theirs}.proj_out"

    for level in range(levels):
        if not arch.cross_attention_blocks[level]:
            continue
        for block in range(arch.layers_per_block):
            spatial(f"down_{level}_attn_{block}", f"down_blocks.{level}.attentions.{block}", arch.depth_at(level))
        u = levels - 1 - level  # diffusers up index
        for block in range(arch.layers_per_block + 1):
            spatial(f"up_{level}_attn_{block}", f"up_blocks.{u}.attentions.{block}", arch.depth_at(level))
    spatial("mid_attn", "mid_block.attentions.0", arch.depth_at(levels - 1))
    return mapping


def sd3_key_map(arch) -> Dict[str, Any]:
    mapping: Dict[str, Any] = {}
    table = {
        "img_attn_q": "attn.to_q",
        "img_attn_k": "attn.to_k",
        "img_attn_v": "attn.to_v",
        "txt_attn_q": "attn.add_q_proj",
        "txt_attn_k": "attn.add_k_proj",
        "txt_attn_v": "attn.add_v_proj",
        "img_attn_proj": "attn.to_out.0",
        "txt_attn_proj": "attn.to_add_out",
        "img_mlp_in": "ff.net.0.proj",
        "img_mlp_out": "ff.net.2",
        "txt_mlp_in": "ff_context.net.0.proj",
        "txt_mlp_out": "ff_context.net.2",
    }
    for layer in range(arch.depth):
        for ours, theirs in table.items():
            mapping[f"block_{layer}/{ours}"] = f"transformer_blocks.{layer}.{theirs}"
    return mapping


def pixart_key_map(arch) -> Dict[str, Any]:
    mapping: Dict[str, Any] = {
        "caption_in_1": "caption_projection.linear_1",
        "caption_in_2": "caption_projection.linear_2",
    }
    table = {
        "attn1_q": "attn1.to_q", "attn1_k": "attn1.to_k", "attn1_v": "attn1.to_v",
        "attn1_proj": "attn1.to_out.0",
        "attn2_q": "attn2.to_q", "attn2_k": "attn2.to_k", "attn2_v": "attn2.to_v",
        "attn2_proj": "attn2.to_out.0",
        "ff_in": "ff.net.0.proj", "ff_out": "ff.net.2",
    }
    for layer in range(arch.depth):
        for ours, theirs in table.items():
            mapping[f"block_{layer}/{ours}"] = f"transformer_blocks.{layer}.{theirs}"
    return mapping


def auraflow_key_map(arch) -> Dict[str, Any]:
    attention = {"attn_q": "attn.to_q", "attn_k": "attn.to_k", "attn_v": "attn.to_v", "attn_proj": "attn.to_out.0"}
    ff = {f"ff/{name}": f"ff.{name}" for name in ("linear_1", "linear_2", "out_projection")}
    joint = {**attention, "attn_add_q": "attn.add_q_proj", "attn_add_k": "attn.add_k_proj",
             "attn_add_v": "attn.add_v_proj", "attn_add_proj": "attn.to_add_out", **ff,
             **{f"ff_context/{name}": f"ff_context.{name}" for name in ("linear_1", "linear_2", "out_projection")}}
    mapping: Dict[str, Any] = {}
    for layer in range(arch.depth_double):
        for ours, theirs in joint.items():
            mapping[f"double_{layer}/{ours}"] = f"joint_transformer_blocks.{layer}.{theirs}"
    for layer in range(arch.depth_single):
        for ours, theirs in {**attention, **ff}.items():
            mapping[f"single_{layer}/{ours}"] = f"single_transformer_blocks.{layer}.{theirs}"
    return mapping


def wan_key_map(arch) -> Dict[str, Any]:
    table = {
        "self_attn_q": "attn1.to_q", "self_attn_k": "attn1.to_k", "self_attn_v": "attn1.to_v",
        "self_attn_proj": "attn1.to_out.0",
        "cross_attn_q": "attn2.to_q", "cross_attn_k": "attn2.to_k", "cross_attn_v": "attn2.to_v",
        "cross_attn_proj": "attn2.to_out.0",
        "ffn_in": "ffn.net.0.proj", "ffn_out": "ffn.net.2",
    }
    mapping: Dict[str, Any] = {}
    for layer in range(arch.depth):
        for ours, theirs in table.items():
            mapping[f"block_{layer}/{ours}"] = f"blocks.{layer}.{theirs}"
    return mapping


def ltx_key_map(arch) -> Dict[str, Any]:
    table = {
        "attn1_q": "attn1.to_q", "attn1_k": "attn1.to_k", "attn1_v": "attn1.to_v",
        "attn1_proj": "attn1.to_out.0",
        "attn2_q": "attn2.to_q", "attn2_k": "attn2.to_k", "attn2_v": "attn2.to_v",
        "attn2_proj": "attn2.to_out.0",
        "ff_in": "ff.net.0.proj", "ff_out": "ff.net.2",
    }
    mapping: Dict[str, Any] = {}
    for layer in range(arch.depth):
        for ours, theirs in table.items():
            mapping[f"block_{layer}/{ours}"] = f"transformer_blocks.{layer}.{theirs}"
    return mapping


def lumina2_key_map(arch) -> Dict[str, Any]:
    """diffusers ``Lumina2Transformer2DModel`` paths: the joint ``layers`` and the
    context / noise refiners, bias-free GQA attention and the SwiGLU."""
    mapping: Dict[str, Any] = {
        "cap_in": "time_caption_embed.caption_embedder.1",
        "patch_in": "x_embedder",
        "final_proj": "norm_out.linear_2",
    }
    table = {
        "attn_q": "attn.to_q", "attn_k": "attn.to_k", "attn_v": "attn.to_v",
        "attn_proj": "attn.to_out.0",
        "feed_forward/linear_1": "feed_forward.linear_1",
        "feed_forward/linear_2": "feed_forward.linear_2",
        "feed_forward/linear_3": "feed_forward.linear_3",
    }
    groups = [(f"layer_{i}", f"layers.{i}") for i in range(arch.depth)]
    groups += [(f"noise_refiner_{i}", f"noise_refiner.{i}") for i in range(arch.refiner_depth)]
    groups += [(f"context_refiner_{i}", f"context_refiner.{i}") for i in range(arch.refiner_depth)]
    for ours_prefix, theirs_prefix in groups:
        for ours, theirs in table.items():
            mapping[f"{ours_prefix}/{ours}"] = f"{theirs_prefix}.{theirs}"
    return mapping


def kandinsky5_key_map(arch) -> Dict[str, Any]:
    """``Kandinsky5Transformer3DModel`` paths: the text blocks' self-attention
    and feed-forward, the visual blocks' self- and cross-attention and
    feed-forward, the visual embedding and the out projection."""
    mapping: Dict[str, Any] = {"visual_in": "visual_embeddings.in_layer", "out_proj": "out_layer.out_layer"}
    attn = ("to_query", "to_key", "to_value", "out_layer")
    groups = [(f"text_block_{i}", f"text_transformer_blocks.{i}", ("self_attention",))
              for i in range(arch.num_text_blocks)]
    groups += [(f"visual_block_{i}", f"visual_transformer_blocks.{i}", ("self_attention", "cross_attention"))
               for i in range(arch.num_visual_blocks)]
    for ours_prefix, theirs_prefix, branches in groups:
        for branch in branches:
            for name in attn:
                mapping[f"{ours_prefix}/{branch}/{name}"] = f"{theirs_prefix}.{branch}.{name}"
        for name in ("in_layer", "out_layer"):
            mapping[f"{ours_prefix}/feed_forward/{name}"] = f"{theirs_prefix}.feed_forward.{name}"
    return mapping


def hunyuanvideo_key_map(arch) -> Dict[str, Any]:
    """diffusers ``HunyuanVideo15Transformer3DModel`` paths of the dual-stream
    blocks (``patch_in`` keeps its own name)."""
    table = {
        "img_attn_q": "attn.to_q", "img_attn_k": "attn.to_k", "img_attn_v": "attn.to_v",
        "txt_attn_q": "attn.add_q_proj", "txt_attn_k": "attn.add_k_proj", "txt_attn_v": "attn.add_v_proj",
        "img_attn_proj": "attn.to_out.0", "txt_attn_proj": "attn.to_add_out",
        "img_mlp_in": "ff.net.0.proj", "img_mlp_out": "ff.net.2",
        "txt_mlp_in": "ff_context.net.0.proj", "txt_mlp_out": "ff_context.net.2",
    }
    return {f"block_{layer}/{ours}": f"transformer_blocks.{layer}.{theirs}"
            for layer in range(arch.depth) for ours, theirs in table.items()}


def qwen_image_key_map(arch) -> Dict[str, Any]:
    """diffusers ``QwenImageTransformer2DModel`` paths of the double-stream
    blocks (MageFlow and Z-Image share them; ``img_in`` / ``txt_in`` keep
    their own names)."""
    table = {
        "img_attn_q": "attn.to_q", "img_attn_k": "attn.to_k", "img_attn_v": "attn.to_v",
        "txt_attn_q": "attn.add_q_proj", "txt_attn_k": "attn.add_k_proj", "txt_attn_v": "attn.add_v_proj",
        "img_attn_proj": "attn.to_out.0", "txt_attn_proj": "attn.to_add_out",
        "img_mlp_in": "img_mlp.net.0.proj", "img_mlp_out": "img_mlp.net.2",
        "txt_mlp_in": "txt_mlp.net.0.proj", "txt_mlp_out": "txt_mlp.net.2",
    }
    return {f"block_{layer}/{ours}": f"transformer_blocks.{layer}.{theirs}"
            for layer in range(arch.depth) for ours, theirs in table.items()}


def hidream_key_map(arch) -> Dict[str, Any]:
    """diffusers ``HiDreamImageTransformer2DModel`` paths: the blocks under
    ``.block``, a plain-Linear ``to_out``; the caption projections and
    ``final_proj`` keep their own names, as in the JAX map."""
    mapping: Dict[str, Any] = {"patch_in": "x_embedder.proj"}
    attn = {"attn_q": "attn1.to_q", "attn_k": "attn1.to_k", "attn_v": "attn1.to_v", "attn_proj": "attn1.to_out"}
    attn_t = {f"{ours}_t": f"{theirs}_t" for ours, theirs in attn.items()}
    shared = {f"ff_i/shared_experts/w{j}": f"ff_i.shared_experts.w{j}" for j in (1, 2, 3)}
    ff_t = {f"ff_t/w{j}": f"ff_t.w{j}" for j in (1, 2, 3)}
    for i in range(arch.depth_double):
        for ours, theirs in {**attn, **attn_t, **shared, **ff_t}.items():
            mapping[f"double_{i}/{ours}"] = f"double_stream_blocks.{i}.block.{theirs}"
    for i in range(arch.depth_single):
        for ours, theirs in {**attn, **shared}.items():
            mapping[f"single_{i}/{ours}"] = f"single_stream_blocks.{i}.block.{theirs}"
    return mapping


def flux2_key_map(arch) -> Dict[str, Any]:
    """diffusers ``Flux2Transformer2DModel`` paths: the double blocks' split
    projections and feed-forwards, the single blocks' fused
    ``to_qkv_mlp_proj`` / ``to_out``, and the adapted embedders and head."""
    mapping: Dict[str, Any] = {"patch_in": "x_embedder", "txt_in": "context_embedder", "final_proj": "proj_out"}
    double = {
        "attn_q": "attn.to_q", "attn_k": "attn.to_k", "attn_v": "attn.to_v",
        "attn_add_q": "attn.add_q_proj", "attn_add_k": "attn.add_k_proj", "attn_add_v": "attn.add_v_proj",
        "attn_proj": "attn.to_out.0", "attn_add_proj": "attn.to_add_out",
        "ff_in": "ff.linear_in", "ff_out": "ff.linear_out",
        "ff_context_in": "ff_context.linear_in", "ff_context_out": "ff_context.linear_out",
    }
    single = {"qkv_mlp": "attn.to_qkv_mlp_proj", "proj_out": "attn.to_out"}
    for i in range(arch.depth_double):
        mapping.update({f"double_{i}/{ours}": f"transformer_blocks.{i}.{theirs}" for ours, theirs in double.items()})
    for i in range(arch.depth_single):
        mapping.update({f"single_{i}/{ours}": f"single_transformer_blocks.{i}.{theirs}"
                        for ours, theirs in single.items()})
    return mapping


def z_image_omni_key_map(arch) -> Dict[str, Any]:
    """``ZImageOmniTransformer2DModel`` paths: diffusers attention names inside
    ``attention``, the SwiGLU ``feed_forward.w1/w2/w3``, the per-patch
    embedders keyed ``"{patch}-1"``."""
    patch_key = f"{arch.patch_size}-1"
    mapping: Dict[str, Any] = {
        "x_embedder": f"all_x_embedder.{patch_key}",
        "cap_embedder": "cap_embedder.1",
        "siglip_embedder": "siglip_embedder.1",
        "final_linear": f"all_final_layer.{patch_key}.linear",
    }
    table = {
        "attn_q": "attention.to_q", "attn_k": "attention.to_k",
        "attn_v": "attention.to_v", "attn_proj": "attention.to_out.0",
        "feed_forward/w1": "feed_forward.w1", "feed_forward/w2": "feed_forward.w2",
        "feed_forward/w3": "feed_forward.w3",
    }
    groups = [(f"layer_{i}", f"layers.{i}") for i in range(arch.depth)]
    for prefix in ("noise_refiner", "context_refiner", "siglip_refiner"):
        groups += [(f"{prefix}_{i}", f"{prefix}.{i}") for i in range(arch.refiner_depth)]
    for ours_prefix, theirs_prefix in groups:
        for ours, theirs in table.items():
            mapping[f"{ours_prefix}/{ours}"] = f"{theirs_prefix}.{theirs}"
    return mapping


def zlab_i1_key_map(arch) -> Dict[str, Any]:
    """``ZlabI1Transformer2DModel`` paths: ``in_blocks`` / ``mid_block`` /
    ``out_blocks`` with the per-modality fused qkv, the SwiGLU ``w12`` / ``w3``
    and the out blocks' skip linears; the connector's input and the head."""
    mapping: Dict[str, Any] = {
        "final_linear": "final_layer.linear",
        "text_adapter/connector_in": "text_encoder_adapter.connector_in",
    }
    table = {
        "qkv_image": "attn.qkv_image", "qkv_text": "attn.qkv_text",
        "proj_image": "attn.proj_image", "proj_text": "attn.proj_text",
        "mlp_image/w12": "mlp_image.w12", "mlp_image/w3": "mlp_image.w3",
        "mlp_text/w12": "mlp_text.w12", "mlp_text/w3": "mlp_text.w3",
    }
    groups = [("mid", "mid_block")]
    groups += [(f"in_{i}", f"in_blocks.{i}") for i in range(arch.num_in_blocks)]
    groups += [(f"out_{i}", f"out_blocks.{i}") for i in range(arch.num_in_blocks)]
    for ours_prefix, theirs_prefix in groups:
        for ours, theirs in table.items():
            mapping[f"{ours_prefix}/{ours}"] = f"{theirs_prefix}.{theirs}"
        if ours_prefix.startswith("out_"):
            mapping[f"{ours_prefix}/skip_image"] = f"{theirs_prefix}.skip_linear_image"
            mapping[f"{ours_prefix}/skip_text"] = f"{theirs_prefix}.skip_linear_text"
    return mapping


# family name -> key map builder, for the families the port has
def krea2_key_map(arch) -> Dict[str, Any]:
    """Krea2Transformer2DModel layout."""
    mapping: Dict[str, Any] = {"img_in": "img_in", "final_linear": "final_layer.linear"}
    attn = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_gate": "to_gate", "to_out": "to_out.0"}
    for layer in range(arch.num_layers):
        for ours, theirs in attn.items():
            mapping[f"block_{layer}/attn/{ours}"] = f"transformer_blocks.{layer}.attn.{theirs}"
        for p in ("gate", "up", "down"):
            mapping[f"block_{layer}/ff/{p}"] = f"transformer_blocks.{layer}.ff.{p}"
    return mapping


def cosmos1_core_key_map(core, ours_prefix: str = "", theirs_prefix: str = "") -> Dict[str, Any]:
    """The Cosmos core's layout (CosmosTransformer3DModel); ``patch_embed``
    keeps its own name, as in the JAX map."""
    mapping: Dict[str, Any] = {f"{ours_prefix}proj_out": f"{theirs_prefix}proj_out"}
    for layer in range(core.num_layers):
        ours, theirs = f"{ours_prefix}block_{layer}", f"{theirs_prefix}transformer_blocks.{layer}"
        for attn in ("attn1", "attn2"):
            for p in ("q", "k", "v"):
                mapping[f"{ours}/{attn}_{p}"] = f"{theirs}.{attn}.to_{p}"
            mapping[f"{ours}/{attn}_out"] = f"{theirs}.{attn}.to_out.0"
        mapping[f"{ours}/ff_in"] = f"{theirs}.ff.net.0.proj"
        mapping[f"{ours}/ff_out"] = f"{theirs}.ff.net.2"
    return mapping


def anima_key_map(arch) -> Dict[str, Any]:
    """AnimaTransformerModel layout: the core under ``core.`` (the adapter has no LoRA)."""
    return cosmos1_core_key_map(arch.core, ours_prefix="core/", theirs_prefix="core.")


def ernie_key_map(arch) -> Dict[str, Any]:
    """ErnieImageTransformer2DModel layout (``x_embedder`` keeps its own name)."""
    mapping: Dict[str, Any] = {"final_linear": "final_linear"}
    for layer in range(arch.num_layers):
        for ours, theirs in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out", "to_out.0")):
            mapping[f"layer_{layer}/{ours}"] = f"layers.{layer}.self_attention.{theirs}"
        for p in ("gate_proj", "up_proj", "linear_fc2"):
            mapping[f"layer_{layer}/{p}"] = f"layers.{layer}.mlp.{p}"
    return mapping


def ideogram_key_map(arch) -> Dict[str, Any]:
    """Ideogram4Transformer layout (``llm_cond_proj`` keeps its own name)."""
    mapping: Dict[str, Any] = {"input_proj": "input_proj", "final_linear": "final_layer.linear"}
    for layer in range(arch.num_layers):
        mapping[f"layer_{layer}/qkv"] = f"layers.{layer}.attention.qkv"
        mapping[f"layer_{layer}/o"] = f"layers.{layer}.attention.o"
        for p in ("w1", "w2", "w3"):
            mapping[f"layer_{layer}/{p}"] = f"layers.{layer}.feed_forward.{p}"
    return mapping


def longcat_video_key_map(arch) -> Dict[str, Any]:
    """LongCatVideoTransformer3DModel layout (the FFN included)."""
    mapping: Dict[str, Any] = {"final_linear": "final_layer.linear"}
    for layer in range(arch.depth):
        for ours, theirs in (("qkv", "attn.qkv"), ("attn_proj", "attn.proj"), ("crs_q", "cross_attn.q_linear"),
                             ("crs_kv", "cross_attn.kv_linear"), ("crs_proj", "cross_attn.proj"),
                             ("ffn_w1", "ffn.w1"), ("ffn_w2", "ffn.w2"), ("ffn_w3", "ffn.w3")):
            mapping[f"block_{layer}/{ours}"] = f"blocks.{layer}.{theirs}"
    return mapping


_SANA_ATTENTION = {f"{attn}_{ours}": f"{attn}.{theirs}" for attn in ("attn1", "attn2")
                   for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj", "to_out.0"))}


def sana_key_map(arch, layers: Optional[int] = None) -> Dict[str, Any]:
    """SanaTransformer2DModel layout: the blocks' attention projections
    (``patch_in`` and the caption MLP keep their own names)."""
    return {f"block_{layer}/{ours}": f"transformer_blocks.{layer}.{theirs}"
            for layer in range(arch.depth if layers is None else layers) for ours, theirs in _SANA_ATTENTION.items()}


def sanavideo_key_map(arch) -> Dict[str, Any]:
    """SanaVideoTransformer3DModel layout: Sana's attention table and ``proj_out``."""
    return {"proj_out": "proj_out", **sana_key_map(arch, arch.num_layers)}


def cosmos3_key_map(arch) -> Dict[str, Any]:
    """Cosmos3OmniTransformer flat layout: the understanding pathway on
    ``self_attn.to_*`` and ``mlp``, the generation pathway on ``add_*_proj``,
    ``to_add_out`` and ``mlp_moe_gen``."""
    mapping: Dict[str, Any] = {"proj_in": "proj_in", "proj_out": "proj_out"}
    table = {
        "attn_und_q": "self_attn.to_q", "attn_und_k": "self_attn.to_k",
        "attn_und_v": "self_attn.to_v", "attn_und_out": "self_attn.to_out",
        "attn_gen_q": "self_attn.add_q_proj", "attn_gen_k": "self_attn.add_k_proj",
        "attn_gen_v": "self_attn.add_v_proj", "attn_gen_out": "self_attn.to_add_out",
    }
    for mlp in ("mlp", "mlp_moe_gen"):
        table.update({f"{mlp}/{p}": f"{mlp}.{p}" for p in ("gate_proj", "up_proj", "down_proj")})
    for i in range(arch.num_layers):
        for ours, theirs in table.items():
            mapping[f"layer_{i}/{ours}"] = f"layers.{i}.{theirs}"
    return mapping


def ltx2_key_map(arch) -> Dict[str, Any]:
    """LTX2VideoTransformer3DModel layout: the projections in and out of both
    streams, the six attentions and the two FFNs of each block (the caption
    MLPs keep their dotted JAX paths, as in the JAX map)."""
    mapping: Dict[str, Any] = {name: name for name in ("proj_in", "audio_proj_in", "proj_out", "audio_proj_out")}
    for i in range(arch.num_layers):
        for mod in ("attn1", "audio_attn1", "attn2", "audio_attn2", "audio_to_video_attn", "video_to_audio_attn"):
            for ours, theirs in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out", "to_out.0")):
                mapping[f"block_{i}/{mod}/{ours}"] = f"transformer_blocks.{i}.{mod}.{theirs}"
        for ff in ("ff", "audio_ff"):
            mapping[f"block_{i}/{ff}/proj_in"] = f"transformer_blocks.{i}.{ff}.net.0.proj"
            mapping[f"block_{i}/{ff}/proj_out"] = f"transformer_blocks.{i}.{ff}.net.2"
    return mapping


def acestep_key_map(arch) -> Dict[str, Any]:
    """ACE-Step's layout (ACEStepTransformer2DModel): Lite-LA self-attention
    and cross-attention blocks, ``to_out`` a ModuleList (``.0``)."""
    mapping: Dict[str, Any] = {"speaker_embedder": "speaker_embedder", "genre_embedder": "genre_embedder",
                               "lyric_proj": "lyric_proj", "final_proj": "final_layer.linear"}
    table = {"attn_q": "attn.to_q", "attn_k": "attn.to_k", "attn_v": "attn.to_v", "attn_proj": "attn.to_out.0",
             "cross_q": "cross_attn.to_q", "cross_k": "cross_attn.to_k", "cross_v": "cross_attn.to_v",
             "cross_proj": "cross_attn.to_out.0"}
    for i in range(arch.num_layers):
        for ours, theirs in table.items():
            mapping[f"block_{i}/{ours}"] = f"transformer_blocks.{i}.{theirs}"
    return mapping


_KEY_MAPS = {
    "flux": lambda m: flux_key_map(m.arch),
    "sd1x": lambda m: unet_key_map(m.arch),
    "sd2x": lambda m: unet_key_map(m.arch),
    "sdxl": lambda m: unet_key_map(m.arch),
    "sd3": lambda m: sd3_key_map(m.arch),
    "pixart_sigma": lambda m: pixart_key_map(m.arch),
    "wan": lambda m: wan_key_map(m.arch),
    "auraflow": lambda m: auraflow_key_map(m.arch),
    "ltxvideo": lambda m: ltx_key_map(m.arch),
    "chroma": lambda m: flux_key_map(m.arch),
    "lumina2": lambda m: lumina2_key_map(m.arch),
    "kandinsky5_video": lambda m: kandinsky5_key_map(m.arch),
    "kandinsky5_image": lambda m: kandinsky5_key_map(m.arch),
    "hunyuanvideo": lambda m: hunyuanvideo_key_map(m.arch),
    "qwen_image": lambda m: qwen_image_key_map(m.arch),
    "mageflow": lambda m: qwen_image_key_map(m.arch),
    "z_image": lambda m: qwen_image_key_map(m.arch),
    "hidream": lambda m: hidream_key_map(m.arch),
    "flux2": lambda m: flux2_key_map(m.arch),
    "kolors": lambda m: unet_key_map(m.arch),
    "longcat_image": lambda m: flux_key_map(m.arch),
    "z_image_omni": lambda m: z_image_omni_key_map(m.arch),
    "zlab_i1": lambda m: zlab_i1_key_map(m.arch),
    "boogu_image": lambda m: lumina2_key_map(m.arch),
    "krea2": lambda m: krea2_key_map(m.arch),
    "cosmos": lambda m: cosmos1_core_key_map(m.arch),
    "anima": lambda m: anima_key_map(m.arch),
    "ernie": lambda m: ernie_key_map(m.arch),
    "ideogram": lambda m: ideogram_key_map(m.arch),
    "longcat_video": lambda m: longcat_video_key_map(m.arch),
    "sana": lambda m: sana_key_map(m.arch),
    "sanavideo": lambda m: sanavideo_key_map(m.arch),
    "cosmos3": lambda m: cosmos3_key_map(m.arch),
    "ltxvideo2": lambda m: ltx2_key_map(m.arch),
    "ace_step": lambda m: acestep_key_map(m.arch),
    "wan_s2v": lambda m: wan_key_map(m.arch),
}


def _key_map_for(model) -> Dict[str, Any]:
    builder = _KEY_MAPS.get(model.NAME)
    if builder is not None:
        return builder(model)
    # generic: keep flax path with slashes -> dots
    return {}


# ---------------------------------------------------------------------------------
# adapter files
# ---------------------------------------------------------------------------------


Adapters = Union[nn.Module, Mapping[str, torch.Tensor]]


def _adapters(module: Adapters) -> Dict[str, Dict[str, torch.Tensor]]:
    """The adapters by JAX module path: {"double_0/img_attn_q": {"lora_A",
    "lora_B"}}, from a module or from its ``lora_parameters`` (a snapshot of
    them, e.g. the trainer's host copy at a checkpoint)."""
    flat: Dict[str, Dict[str, torch.Tensor]] = {}
    tensors = lora_parameters(module) if isinstance(module, nn.Module) else module
    for path, param in tensors.items():
        parent, leaf = path.rsplit("/", 1)
        flat.setdefault(parent, {})[leaf] = param
    return flat


def _prefix(model) -> str:
    return "transformer." if getattr(model, "MODEL_TYPE", "transformer") == "transformer" else "unet."


def lora_state_dict(
    model, module: Adapters, format: str = "diffusers", alpha: Optional[float] = None
) -> Dict[str, torch.Tensor]:
    """The adapters of a module (or a snapshot of its ``lora_parameters``)
    as the tensors of an adapter file (f32, on the host): fused projections (Flux ``linear1``) split into their diffusers
    parts with the shared A and the slice of B."""
    key_map = _key_map_for(model)
    prefix = _prefix(model)
    alpha = alpha if alpha is not None else float(model.lora_alpha or model.lora_rank)
    tensors: Dict[str, torch.Tensor] = {}
    for path, leaves in _adapters(module).items():
        a = leaves["lora_A"].detach().to("cpu", torch.float32)  # (r, in)
        b = leaves["lora_B"].detach().to("cpu", torch.float32)  # (out, r)
        target = key_map.get(path, path.replace("/", "."))
        if isinstance(target, list):  # fused projection: shared A, sliced B
            for name, start, end in target:
                _emit(tensors, prefix + name, a, b[start:end], alpha, format)
        else:
            _emit(tensors, prefix + target, a, b, alpha, format)
    return tensors


def _emit(tensors: Dict[str, torch.Tensor], module: str, a: torch.Tensor, b: torch.Tensor, alpha: float,
          format: str) -> None:
    if format == "diffusers":
        tensors[f"{module}.lora_A.weight"] = a.contiguous()  # (r, in)
        tensors[f"{module}.lora_B.weight"] = b.contiguous()  # (out, r)
    elif format == "comfyui":
        key = "diffusion_model." + module.removeprefix("transformer.").removeprefix("unet.")
        tensors[f"{key}.lora_down.weight"] = a.contiguous()
        tensors[f"{key}.lora_up.weight"] = b.contiguous()
        tensors[f"{key}.alpha"] = torch.tensor(alpha, dtype=torch.float32)
    else:
        raise ValueError(f"unknown lora export format {format!r}")


def save_lora_safetensors(
    model,
    module: Adapters,
    path: str,
    format: str = "diffusers",
    metadata: Optional[Dict[str, str]] = None,
) -> None:
    """Write the adapters of a module (or a snapshot of its
    ``lora_parameters``) as a diffusers- or ComfyUI-layout file."""
    meta = {"format": "pt"}
    if metadata:
        meta.update({k: str(v) for k, v in metadata.items()})
    save_safetensors(lora_state_dict(model, module, format=format), path, metadata=meta)


def load_lora_safetensors(model, path: str, module: nn.Module) -> List[str]:
    """Copy a diffusers- or ComfyUI-layout adapter file into the module's
    adapters, in place; returns the adapter paths the file does not hold
    (those keep their values, as the JAX loader keeps the template's).  A
    fused projection takes the file's shared A and assembles B from its
    parts; parts with different A matrices would need a wider rank than the
    module has, and raise."""
    normalized: Dict[str, torch.Tensor] = {}
    for key, value in load_safetensors_file(path).items():
        key = key.replace("diffusion_model.", "transformer.")
        key = key.replace(".lora_down.weight", ".lora_A.weight").replace(".lora_up.weight", ".lora_B.weight")
        key = key.replace(".lora.down.weight", ".lora_A.weight").replace(".lora.up.weight", ".lora_B.weight")
        normalized[key] = value
    key_map = _key_map_for(model)
    prefix = _prefix(model)
    missing: List[str] = []
    with torch.no_grad():
        for path, leaves in _adapters(module).items():
            target = key_map.get(path, path.replace("/", "."))
            parts = target if isinstance(target, list) else [(target, 0, leaves["lora_B"].shape[0])]
            keys = [(f"{prefix}{name}.lora_A.weight", f"{prefix}{name}.lora_B.weight", start, end)
                    for name, start, end in parts]
            if any(a_key not in normalized for a_key, _, _, _ in keys):
                missing.append(path)
                continue
            a_first = normalized[keys[0][0]]
            if not all(normalized[a_key].shape == a_first.shape and torch.allclose(normalized[a_key], a_first)
                       for a_key, _, _, _ in keys):
                raise ValueError(f"{path}: the parts of the fused projection carry different A matrices; "
                                 f"their ranks add up beyond the module's rank {leaves['lora_A'].shape[0]}")
            b = torch.zeros(leaves["lora_B"].shape, dtype=torch.float32, device="cpu")
            for _, b_key, start, end in keys:
                b[start:end] = normalized[b_key].to(torch.float32)
            leaves["lora_A"].copy_(a_first.to(torch.float32))
            leaves["lora_B"].copy_(b)
    return missing
