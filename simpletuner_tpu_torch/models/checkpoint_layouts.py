"""Published checkpoint layouts, for writing seeded checkpoints.

The writing side of ``models/weight_import.py``: the tensor names and torch
shapes of the files its importers read, so that ``chip_smoke.py`` and the
tests can write seeded checkpoints with ``weight_import.save_safetensors``
when no published file is at hand.  Nothing in the library imports this
module.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch
from torch import nn


def flux_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers-layout Flux transformer
    (``FluxTransformer2DModel``) of ``arch``."""
    h, hd, mlp = arch.hidden_size, arch.head_dim, int(arch.hidden_size * arch.mlp_ratio)
    shapes: Dict[str, tuple] = {}

    def linear(name, out_features, in_features):
        shapes[f"{name}.weight"] = (out_features, in_features)
        shapes[f"{name}.bias"] = (out_features,)

    linear("x_embedder", h, arch.in_channels)
    linear("context_embedder", h, arch.txt_in_features)
    embedders = [("timestep_embedder", 256)]
    if arch.vector_embed:
        embedders.append(("text_embedder", arch.vec_in_features))
    if arch.guidance_embed:
        embedders.append(("guidance_embedder", 256))
    for name, in_features in embedders:
        linear(f"time_text_embed.{name}.linear_1", h, in_features)
        linear(f"time_text_embed.{name}.linear_2", h, h)
    linear("norm_out.linear", 2 * h, h)
    linear("proj_out", arch.in_channels, h)
    for i in range(arch.depth_double):
        p = f"transformer_blocks.{i}"
        linear(f"{p}.norm1.linear", 6 * h, h)
        linear(f"{p}.norm1_context.linear", 6 * h, h)
        for proj in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0", "to_add_out"):
            linear(f"{p}.attn.{proj}", h, h)
        for norm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            shapes[f"{p}.attn.{norm}.weight"] = (hd,)
        for ff in ("ff", "ff_context"):
            linear(f"{p}.{ff}.net.0.proj", mlp, h)
            linear(f"{p}.{ff}.net.2", h, mlp)
    for i in range(arch.depth_single):
        p = f"single_transformer_blocks.{i}"
        for proj in ("to_q", "to_k", "to_v"):
            linear(f"{p}.attn.{proj}", h, h)
        shapes[f"{p}.attn.norm_q.weight"] = (hd,)
        shapes[f"{p}.attn.norm_k.weight"] = (hd,)
        linear(f"{p}.proj_mlp", mlp, h)
        linear(f"{p}.proj_out", h, h + mlp)
        linear(f"{p}.norm.linear", 3 * h, h)
    return shapes


def sd3_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers-layout SD3 / SD3.5
    transformer (``SD3Transformer2DModel``) of ``arch``: the patchify conv,
    the position table (``pos_embed_max_size`` > 0), and a last block with
    ``context_pre_only`` (its context norm an ``AdaLayerNormContinuous``)."""
    h, hd, mlp = arch.hidden_size, arch.head_dim, int(arch.hidden_size * arch.mlp_ratio)
    p, c = arch.patch_size, arch.in_channels
    shapes: Dict[str, tuple] = {"pos_embed.proj.weight": (h, c, p, p), "pos_embed.proj.bias": (h,)}

    def linear(name, out_features, in_features):
        shapes[f"{name}.weight"] = (out_features, in_features)
        shapes[f"{name}.bias"] = (out_features,)

    if arch.pos_embed_max_size:
        shapes["pos_embed.pos_embed"] = (1, arch.pos_embed_max_size ** 2, h)
    linear("context_embedder", h, arch.context_dim)
    for name, in_features in (("timestep_embedder", 256), ("text_embedder", arch.pooled_dim)):
        linear(f"time_text_embed.{name}.linear_1", h, in_features)
        linear(f"time_text_embed.{name}.linear_2", h, h)
    linear("norm_out.linear", 2 * h, h)
    linear("proj_out", p * p * c, h)
    for i in range(arch.depth):
        b = f"transformer_blocks.{i}"
        last = i == arch.depth - 1
        linear(f"{b}.norm1.linear", 6 * h, h)
        linear(f"{b}.norm1_context.linear", (2 if last else 6) * h, h)
        projs = ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0")
        for proj in projs if last else projs + ("to_add_out",):
            linear(f"{b}.attn.{proj}", h, h)
        if arch.qk_norm:
            for norm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                shapes[f"{b}.attn.{norm}.weight"] = (hd,)
        for ff in ("ff",) if last else ("ff", "ff_context"):
            linear(f"{b}.{ff}.net.0.proj", mlp, h)
            linear(f"{b}.{ff}.net.2", h, mlp)
    return shapes


def unet_checkpoint_shapes(arch, conv_proj: bool = False) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers-layout
    ``UNet2DConditionModel`` of ``arch`` (``models/unet.py::UNetConfig``) as
    ``unet_params_from_diffusers`` reads it: a spatial transformer wherever
    ``cross_attention_blocks`` marks a level (the JAX sdxl preset marks all
    three, where the published SDXL UNet has none at level 0), Linear
    ``proj_in`` / ``proj_out`` (SD 2.x, SDXL) or, with ``conv_proj``, the 1x1
    convs of SD 1.x, the time and added-conditioning MLPs."""
    shapes: Dict[str, tuple] = {}
    c0, time_dim = arch.block_out_channels[0], arch.block_out_channels[0] * 4

    def linear(name, out_features, in_features, bias=True):
        shapes[f"{name}.weight"] = (out_features, in_features)
        if bias:
            shapes[f"{name}.bias"] = (out_features,)

    def conv(name, out_channels, in_channels, kernel):
        shapes[f"{name}.weight"] = (out_channels, in_channels, kernel, kernel)
        shapes[f"{name}.bias"] = (out_channels,)

    def norm(name, channels):
        shapes[f"{name}.weight"] = (channels,)
        shapes[f"{name}.bias"] = (channels,)

    def resnet(src, in_channels, out_channels):
        norm(f"{src}.norm1", in_channels)
        conv(f"{src}.conv1", out_channels, in_channels, 3)
        linear(f"{src}.time_emb_proj", out_channels, time_dim)
        norm(f"{src}.norm2", out_channels)
        conv(f"{src}.conv2", out_channels, out_channels, 3)
        if in_channels != out_channels:
            conv(f"{src}.conv_shortcut", out_channels, in_channels, 1)

    def spatial(src, channels, depth):
        norm(f"{src}.norm", channels)
        for proj in ("proj_in", "proj_out"):
            if conv_proj:
                conv(f"{src}.{proj}", channels, channels, 1)
            else:
                linear(f"{src}.{proj}", channels, channels)
        for i in range(depth):
            block = f"{src}.transformer_blocks.{i}"
            for attn, context in (("attn1", channels), ("attn2", arch.cross_attention_dim)):
                linear(f"{block}.{attn}.to_q", channels, channels, bias=False)
                linear(f"{block}.{attn}.to_k", channels, context, bias=False)
                linear(f"{block}.{attn}.to_v", channels, context, bias=False)
                linear(f"{block}.{attn}.to_out.0", channels, channels)
            for name in ("norm1", "norm2", "norm3"):
                norm(f"{block}.{name}", channels)
            linear(f"{block}.ff.net.0.proj", channels * 8, channels)
            linear(f"{block}.ff.net.2", channels, channels * 4)

    conv("conv_in", c0, arch.in_channels, 3)
    linear("time_embedding.linear_1", time_dim, c0)
    linear("time_embedding.linear_2", time_dim, time_dim)
    if arch.addition_embed_dim:
        linear("add_embedding.linear_1", time_dim, arch.addition_embed_dim)
        linear("add_embedding.linear_2", time_dim, time_dim)
    levels = len(arch.block_out_channels)
    skips, channels = [c0], c0
    for level, out_ch in enumerate(arch.block_out_channels):
        for j in range(arch.layers_per_block):
            resnet(f"down_blocks.{level}.resnets.{j}", channels, out_ch)
            channels = out_ch
            if arch.cross_attention_blocks[level]:
                spatial(f"down_blocks.{level}.attentions.{j}", out_ch, arch.depth_at(level))
            skips.append(channels)
        if level < levels - 1:
            conv(f"down_blocks.{level}.downsamplers.0.conv", out_ch, out_ch, 3)
            skips.append(channels)
    mid = arch.block_out_channels[-1]
    resnet("mid_block.resnets.0", channels, mid)
    spatial("mid_block.attentions.0", mid, arch.depth_at(levels - 1))
    resnet("mid_block.resnets.1", mid, mid)
    channels = mid
    for u in range(levels):
        level = levels - 1 - u
        out_ch = arch.block_out_channels[level]
        for j in range(arch.layers_per_block + 1):
            resnet(f"up_blocks.{u}.resnets.{j}", channels + skips.pop(), out_ch)
            channels = out_ch
            if arch.cross_attention_blocks[level]:
                spatial(f"up_blocks.{u}.attentions.{j}", out_ch, arch.depth_at(level))
        if level > 0:
            conv(f"up_blocks.{u}.upsamplers.0.conv", out_ch, out_ch, 3)
    norm("conv_norm_out", channels)
    conv("conv_out", arch.out_channels, channels, 3)
    return shapes


def pixart_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers ``PixArtTransformer2DModel``
    of ``arch`` (``models/pixart/transformer.py::PixartConfig``) as
    ``pixart_params_from_diffusers`` reads it: the patchify conv, the caption
    projection, adaLN-single, the per-block and final scale-shift tables;
    every linear has a bias."""
    dim, p, inner = arch.hidden_size, arch.patch_size, arch.num_heads * arch.head_dim
    ffn = int(dim * arch.ffn_ratio)
    shapes: Dict[str, tuple] = {"pos_embed.proj.weight": (dim, arch.in_channels, p, p), "pos_embed.proj.bias": (dim,)}

    def linear(name, out_features, in_features):
        shapes[f"{name}.weight"] = (out_features, in_features)
        shapes[f"{name}.bias"] = (out_features,)

    linear("caption_projection.linear_1", dim, arch.text_dim)
    linear("caption_projection.linear_2", dim, dim)
    linear("adaln_single.emb.timestep_embedder.linear_1", dim, 256)
    linear("adaln_single.emb.timestep_embedder.linear_2", dim, dim)
    linear("adaln_single.linear", 6 * dim, dim)
    for i in range(arch.depth):
        block = f"transformer_blocks.{i}"
        shapes[f"{block}.scale_shift_table"] = (6, dim)
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                linear(f"{block}.{attn}.{proj}", inner, dim)
            linear(f"{block}.{attn}.to_out.0", dim, inner)
        linear(f"{block}.ff.net.0.proj", ffn, dim)
        linear(f"{block}.ff.net.2", dim, ffn)
    shapes["scale_shift_table"] = (2, dim)
    linear("proj_out", p * p * arch.effective_out_channels, dim)
    return shapes


def auraflow_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers ``AuraFlowTransformer2DModel``
    of ``arch`` (``models/auraflow/transformer.py::AuraFlowConfig``) as
    ``auraflow_params_from_diffusers`` reads it and the JAX
    ``export_auraflow_to_diffusers`` writes it: the patch linear and the time
    MLP with biases, every other linear bias-free, the position table and the
    register tokens with a leading batch axis."""
    dim, p, ffn = arch.hidden_size, arch.patch_size, arch.ffn_hidden
    shapes: Dict[str, tuple] = {
        "pos_embed.proj.weight": (dim, p * p * arch.in_channels), "pos_embed.proj.bias": (dim,),
        "pos_embed.pos_embed": (1, arch.pos_embed_max_size, dim),
        "context_embedder.weight": (dim, arch.text_dim),
        "register_tokens": (1, arch.num_register_tokens, dim),
        "time_step_proj.linear_1.weight": (dim, 256), "time_step_proj.linear_1.bias": (dim,),
        "time_step_proj.linear_2.weight": (dim, dim), "time_step_proj.linear_2.bias": (dim,),
    }

    def ff(prefix):
        shapes[f"{prefix}.linear_1.weight"] = (ffn, dim)
        shapes[f"{prefix}.linear_2.weight"] = (ffn, dim)
        shapes[f"{prefix}.out_projection.weight"] = (dim, ffn)

    for i in range(arch.depth_double):
        block = f"joint_transformer_blocks.{i}"
        shapes[f"{block}.norm1.linear.weight"] = (6 * dim, dim)
        shapes[f"{block}.norm1_context.linear.weight"] = (6 * dim, dim)
        for proj in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0", "to_add_out"):
            shapes[f"{block}.attn.{proj}.weight"] = (dim, dim)
        ff(f"{block}.ff")
        ff(f"{block}.ff_context")
    for i in range(arch.depth_single):
        block = f"single_transformer_blocks.{i}"
        shapes[f"{block}.norm1.linear.weight"] = (6 * dim, dim)
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            shapes[f"{block}.attn.{proj}.weight"] = (dim, dim)
        ff(f"{block}.ff")
    shapes["norm_out.linear.weight"] = (2 * dim, dim)
    shapes["proj_out.weight"] = (p * p * arch.in_channels, dim)
    return shapes


def clip_checkpoint_shapes(config, projection: bool = False) -> Dict[str, tuple]:
    """Tensor names and torch shapes of an HF ``CLIPTextModel`` of ``config``
    (``models/clip.py::CLIPTextConfig``); ``projection`` adds the
    ``text_projection`` of a ``CLIPTextModelWithProjection`` (SD3's
    ``text_encoder_2``), which the importer leaves out."""
    h, f = config.hidden_size, config.intermediate_size
    shapes: Dict[str, tuple] = {
        "text_model.embeddings.token_embedding.weight": (config.vocab_size, h),
        "text_model.embeddings.position_embedding.weight": (config.max_position_embeddings, h),
        "text_model.final_layer_norm.weight": (h,),
        "text_model.final_layer_norm.bias": (h,),
    }
    for i in range(config.num_hidden_layers):
        layer = f"text_model.encoder.layers.{i}"
        for name, out_features, in_features in (("self_attn.q_proj", h, h), ("self_attn.k_proj", h, h),
                                                ("self_attn.v_proj", h, h), ("self_attn.out_proj", h, h),
                                                ("mlp.fc1", f, h), ("mlp.fc2", h, f)):
            shapes[f"{layer}.{name}.weight"] = (out_features, in_features)
            shapes[f"{layer}.{name}.bias"] = (out_features,)
        for norm in ("layer_norm1", "layer_norm2"):
            shapes[f"{layer}.{norm}.weight"] = (h,)
            shapes[f"{layer}.{norm}.bias"] = (h,)
    if projection:
        shapes["text_projection.weight"] = (h, h)
    return shapes


def flux_bfl_from_diffusers(weights: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The same Flux weights in the original BFL layout: fused q|k|v (and
    q|k|v|mlp in the single blocks), (shift, scale) order in the final
    modulation, BFL names."""
    w = dict(weights)
    out: Dict[str, torch.Tensor] = {}

    def take(theirs, ours):
        for suffix in ("weight", "bias"):
            if f"{theirs}.{suffix}" in w:
                out[f"{ours}.{suffix}"] = w.pop(f"{theirs}.{suffix}")

    def fuse(parts, ours):
        for suffix in ("weight", "bias"):
            out[f"{ours}.{suffix}"] = torch.cat([w.pop(f"{part}.{suffix}") for part in parts])

    take("x_embedder", "img_in")
    take("context_embedder", "txt_in")
    for theirs, ours in (("timestep_embedder", "time_in"), ("text_embedder", "vector_in"),
                         ("guidance_embedder", "guidance_in")):
        take(f"time_text_embed.{theirs}.linear_1", f"{ours}.in_layer")
        take(f"time_text_embed.{theirs}.linear_2", f"{ours}.out_layer")
    for suffix in ("weight", "bias"):
        scale, shift = w.pop(f"norm_out.linear.{suffix}").chunk(2)
        out[f"final_layer.adaLN_modulation.1.{suffix}"] = torch.cat([shift, scale])
    take("proj_out", "final_layer.linear")
    blocks = {int(k.split(".")[1]) for k in w if k.startswith("transformer_blocks.")}
    for i in sorted(blocks):
        p, q = f"transformer_blocks.{i}", f"double_blocks.{i}"
        for stream, mod, projs, norms, out_proj, ff in (
            ("img", "norm1", ("to_q", "to_k", "to_v"), ("norm_q", "norm_k"), "to_out.0", "ff"),
            ("txt", "norm1_context", ("add_q_proj", "add_k_proj", "add_v_proj"), ("norm_added_q", "norm_added_k"),
             "to_add_out", "ff_context"),
        ):
            take(f"{p}.{mod}.linear", f"{q}.{stream}_mod.lin")
            fuse([f"{p}.attn.{proj}" for proj in projs], f"{q}.{stream}_attn.qkv")
            out[f"{q}.{stream}_attn.norm.query_norm.scale"] = w.pop(f"{p}.attn.{norms[0]}.weight")
            out[f"{q}.{stream}_attn.norm.key_norm.scale"] = w.pop(f"{p}.attn.{norms[1]}.weight")
            take(f"{p}.attn.{out_proj}", f"{q}.{stream}_attn.proj")
            take(f"{p}.{ff}.net.0.proj", f"{q}.{stream}_mlp.0")
            take(f"{p}.{ff}.net.2", f"{q}.{stream}_mlp.2")
    blocks = {int(k.split(".")[1]) for k in w if k.startswith("single_transformer_blocks.")}
    for i in sorted(blocks):
        p, q = f"single_transformer_blocks.{i}", f"single_blocks.{i}"
        fuse([f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v", f"{p}.proj_mlp"], f"{q}.linear1")
        take(f"{p}.proj_out", f"{q}.linear2")
        take(f"{p}.norm.linear", f"{q}.modulation.lin")
        out[f"{q}.norm.query_norm.scale"] = w.pop(f"{p}.attn.norm_q.weight")
        out[f"{q}.norm.key_norm.scale"] = w.pop(f"{p}.attn.norm_k.weight")
    if w:
        raise KeyError(f"diffusers keys without a BFL counterpart: {sorted(w)[:8]}")
    return out


def wan_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers ``WanTransformer3DModel``
    of ``arch`` (``models/wan/transformer.py::WanConfig``) as
    ``wan_params_from_diffusers`` reads it and the JAX
    ``export_wan_to_diffusers`` writes it: the Conv3d patch embed, the
    tables with a leading batch axis, every linear with a bias, the affine
    ``norm2`` and, with ``qk_norm``, the q and k RMSNorm scales."""
    dim, inner, ffn = arch.hidden_size, arch.num_heads * arch.head_dim, arch.ffn_hidden
    pt, ph, pw = arch.patch
    out_channels = arch.out_channels or arch.in_channels
    shapes: Dict[str, tuple] = {
        "patch_embedding.weight": (dim, arch.in_channels, pt, ph, pw), "patch_embedding.bias": (dim,),
        "scale_shift_table": (1, 2, dim),
    }

    def linear(name, out_features, in_features):
        shapes[f"{name}.weight"] = (out_features, in_features)
        shapes[f"{name}.bias"] = (out_features,)

    linear("condition_embedder.text_embedder.linear_1", dim, arch.text_dim)
    linear("condition_embedder.text_embedder.linear_2", dim, dim)
    linear("condition_embedder.time_embedder.linear_1", dim, 256)
    linear("condition_embedder.time_embedder.linear_2", dim, dim)
    linear("condition_embedder.time_proj", 6 * dim, dim)
    for i in range(arch.depth):
        block = f"blocks.{i}"
        shapes[f"{block}.scale_shift_table"] = (1, 6, dim)
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                linear(f"{block}.{attn}.{proj}", inner, dim)
            linear(f"{block}.{attn}.to_out.0", dim, inner)
            if arch.qk_norm:
                shapes[f"{block}.{attn}.norm_q.weight"] = (inner,)
                shapes[f"{block}.{attn}.norm_k.weight"] = (inner,)
        shapes[f"{block}.norm2.weight"] = (dim,)
        shapes[f"{block}.norm2.bias"] = (dim,)
        linear(f"{block}.ffn.net.0.proj", ffn, dim)
        linear(f"{block}.ffn.net.2", dim, ffn)
    linear("proj_out", pt * ph * pw * out_channels, dim)
    return shapes


def ltx_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers
    ``LTXVideoTransformer3DModel`` of ``arch``
    (``models/ltxvideo/transformer.py::LTXConfig``) as
    ``ltx_params_from_diffusers`` reads it and the JAX
    ``export_ltx_to_diffusers`` writes it: every linear with a bias, the
    (2, dim) and (6, dim) tables, and the q and k RMSNorm scales of both
    attentions."""
    dim, inner, ffn = arch.hidden_size, arch.num_heads * arch.head_dim, arch.ffn_hidden
    shapes: Dict[str, tuple] = {"scale_shift_table": (2, dim)}

    def linear(name, out_features, in_features):
        shapes[f"{name}.weight"] = (out_features, in_features)
        shapes[f"{name}.bias"] = (out_features,)

    linear("proj_in", dim, arch.in_channels)
    linear("caption_projection.linear_1", dim, arch.text_dim)
    linear("caption_projection.linear_2", dim, dim)
    linear("time_embed.emb.timestep_embedder.linear_1", dim, 256)
    linear("time_embed.emb.timestep_embedder.linear_2", dim, dim)
    linear("time_embed.linear", 6 * dim, dim)
    for i in range(arch.depth):
        block = f"transformer_blocks.{i}"
        shapes[f"{block}.scale_shift_table"] = (6, dim)
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                linear(f"{block}.{attn}.{proj}", inner, dim)
            linear(f"{block}.{attn}.to_out.0", dim, inner)
            shapes[f"{block}.{attn}.norm_q.weight"] = (inner,)
            shapes[f"{block}.{attn}.norm_k.weight"] = (inner,)
        linear(f"{block}.ff.net.0.proj", ffn, dim)
        linear(f"{block}.ff.net.2", dim, ffn)
    linear("proj_out", arch.out_channels, dim)
    return shapes


def chroma_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers ``ChromaTransformer2DModel``
    of ``arch`` (``models/chroma/transformer.py::ChromaConfig``) as
    ``chroma_params_from_diffusers`` reads it: Flux's diffusers blocks
    without their modulation linears, the ``distilled_guidance_layer``
    approximator, no time, text or guidance embedders and no ``norm_out``."""
    h, hd, mlp, hidden = arch.hidden_size, arch.head_dim, int(arch.hidden_size * arch.mlp_ratio), \
        arch.approximator_hidden
    shapes: Dict[str, tuple] = {}

    def linear(name, out_features, in_features):
        shapes[f"{name}.weight"] = (out_features, in_features)
        shapes[f"{name}.bias"] = (out_features,)

    linear("x_embedder", h, arch.in_channels)
    linear("context_embedder", h, arch.txt_in_features)
    linear("proj_out", arch.in_channels, h)
    linear("distilled_guidance_layer.in_proj", hidden, arch.approximator_channels)
    linear("distilled_guidance_layer.out_proj", h, hidden)
    for i in range(arch.approximator_layers):
        linear(f"distilled_guidance_layer.layers.{i}.linear_1", hidden, hidden)
        linear(f"distilled_guidance_layer.layers.{i}.linear_2", hidden, hidden)
        shapes[f"distilled_guidance_layer.norms.{i}.weight"] = (hidden,)
    for i in range(arch.depth_double):
        p = f"transformer_blocks.{i}"
        for proj in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0", "to_add_out"):
            linear(f"{p}.attn.{proj}", h, h)
        for norm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            shapes[f"{p}.attn.{norm}.weight"] = (hd,)
        for ff in ("ff", "ff_context"):
            linear(f"{p}.{ff}.net.0.proj", mlp, h)
            linear(f"{p}.{ff}.net.2", h, mlp)
    for i in range(arch.depth_single):
        p = f"single_transformer_blocks.{i}"
        for proj in ("to_q", "to_k", "to_v"):
            linear(f"{p}.attn.{proj}", h, h)
        shapes[f"{p}.attn.norm_q.weight"] = (hd,)
        shapes[f"{p}.attn.norm_k.weight"] = (hd,)
        linear(f"{p}.proj_mlp", mlp, h)
        linear(f"{p}.proj_out", h, h + mlp)
    return shapes


def lumina2_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers ``Lumina2Transformer2DModel``
    of ``arch`` (``models/lumina2/transformer.py::Lumina2Config``) as
    ``lumina2_params_from_diffusers`` reads it: bias-free attention and
    SwiGLU, the RMSNorm scales, the time MLP, caption embedder, modulation
    and final linears with biases."""
    dim, dh, inner, p = arch.hidden_size, arch.head_dim, arch.ffn_inner, arch.patch_size
    shapes: Dict[str, tuple] = {}

    def linear(name, out_features, in_features, bias=True):
        shapes[f"{name}.weight"] = (out_features, in_features)
        if bias:
            shapes[f"{name}.bias"] = (out_features,)

    linear("x_embedder", dim, p * p * arch.in_channels)
    linear("time_caption_embed.timestep_embedder.linear_1", arch.time_dim, 256)
    linear("time_caption_embed.timestep_embedder.linear_2", arch.time_dim, arch.time_dim)
    shapes["time_caption_embed.caption_embedder.0.weight"] = (arch.cap_feat_dim,)
    linear("time_caption_embed.caption_embedder.1", dim, arch.cap_feat_dim)
    linear("norm_out.linear_1", dim, arch.time_dim)
    linear("norm_out.linear_2", p * p * arch.in_channels, dim)
    blocks = [(f"context_refiner.{i}", False) for i in range(arch.refiner_depth)]
    blocks += [(f"noise_refiner.{i}", True) for i in range(arch.refiner_depth)]
    blocks += [(f"layers.{i}", True) for i in range(arch.depth)]
    for src, modulated in blocks:
        linear(f"{src}.attn.to_q", arch.num_heads * dh, dim, bias=False)
        linear(f"{src}.attn.to_k", arch.num_kv_heads * dh, dim, bias=False)
        linear(f"{src}.attn.to_v", arch.num_kv_heads * dh, dim, bias=False)
        linear(f"{src}.attn.to_out.0", dim, arch.num_heads * dh, bias=False)
        shapes[f"{src}.attn.norm_q.weight"] = (dh,)
        shapes[f"{src}.attn.norm_k.weight"] = (dh,)
        linear(f"{src}.feed_forward.linear_1", inner, dim, bias=False)
        linear(f"{src}.feed_forward.linear_3", inner, dim, bias=False)
        linear(f"{src}.feed_forward.linear_2", dim, inner, bias=False)
        for norm in ("norm2", "ffn_norm1", "ffn_norm2"):
            shapes[f"{src}.{norm}.weight"] = (dim,)
        if modulated:
            linear(f"{src}.norm1.linear", 4 * dim, arch.time_dim)
            shapes[f"{src}.norm1.norm.weight"] = (dim,)
        else:
            shapes[f"{src}.norm1.weight"] = (dim,)
    return shapes


def kandinsky5_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a ``Kandinsky5Transformer3DModel`` of
    ``arch`` (``models/kandinsky5/transformer.py::Kandinsky5Config``) as
    ``kandinsky5_params_from_checkpoint`` reads it: biased attention
    projections with per-head q / k norm scales, the bias-free feed-forward,
    the biased modulation heads and embeddings, the affine text and pooled
    norms."""
    dim, td, hd = arch.model_dim, arch.time_dim, arch.head_dim
    patch = arch.patch_size[0] * arch.patch_size[1] * arch.patch_size[2]
    shapes: Dict[str, tuple] = {}

    def linear(name, out_features, in_features, bias=True):
        shapes[f"{name}.weight"] = (out_features, in_features)
        if bias:
            shapes[f"{name}.bias"] = (out_features,)

    def attention(src):
        for proj in ("to_query", "to_key", "to_value", "out_layer"):
            linear(f"{src}.{proj}", dim, dim)
        shapes[f"{src}.query_norm.weight"] = (hd,)
        shapes[f"{src}.key_norm.weight"] = (hd,)

    linear("time_embeddings.in_layer", td, dim)
    linear("time_embeddings.out_layer", td, td)
    linear("text_embeddings.in_layer", dim, arch.in_text_dim)
    for name, features in (("text_embeddings.norm", dim), ("pooled_text_embeddings.norm", td)):
        shapes[f"{name}.weight"] = (features,)
        shapes[f"{name}.bias"] = (features,)
    linear("pooled_text_embeddings.in_layer", td, arch.in_text_dim2)
    linear("visual_embeddings.in_layer", dim, patch * arch.visual_embed_dim)
    linear("out_layer.modulation.out_layer", 2 * dim, td)
    linear("out_layer.out_layer", patch * arch.out_visual_dim, dim)
    for i in range(arch.num_text_blocks):
        src = f"text_transformer_blocks.{i}"
        linear(f"{src}.text_modulation.out_layer", 6 * dim, td)
        attention(f"{src}.self_attention")
        linear(f"{src}.feed_forward.in_layer", arch.ff_dim, dim, bias=False)
        linear(f"{src}.feed_forward.out_layer", dim, arch.ff_dim, bias=False)
    for i in range(arch.num_visual_blocks):
        src = f"visual_transformer_blocks.{i}"
        linear(f"{src}.visual_modulation.out_layer", 9 * dim, td)
        attention(f"{src}.self_attention")
        attention(f"{src}.cross_attention")
        linear(f"{src}.feed_forward.in_layer", arch.ff_dim, dim, bias=False)
        linear(f"{src}.feed_forward.out_layer", dim, arch.ff_dim, bias=False)
    return shapes


def hunyuanvideo_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers
    ``HunyuanVideo15Transformer3DModel`` of ``arch``
    (``models/hunyuanvideo/transformer.py::HunyuanVideo15Config``) as
    ``hunyuanvideo_params_from_diffusers`` reads it: the Conv3d patch embed,
    the time embedder, ``cond_type_embed``, the ByT5 and image projections,
    the token refiner, the dual-stream blocks and the output head."""
    dim, hd, mlp = arch.hidden_size, arch.head_dim, int(arch.hidden_size * arch.mlp_ratio)
    shapes: Dict[str, tuple] = {}

    def linear(name, out_features, in_features):
        shapes[f"{name}.weight"] = (out_features, in_features)
        shapes[f"{name}.bias"] = (out_features,)

    def norm(name, features):
        shapes[f"{name}.weight"] = (features,)
        shapes[f"{name}.bias"] = (features,)

    shapes["x_embedder.proj.weight"] = (dim, arch.in_channels, *arch.patch)
    shapes["x_embedder.proj.bias"] = (dim,)
    linear("time_embed.timestep_embedder.linear_1", dim, 256)
    linear("time_embed.timestep_embedder.linear_2", dim, dim)
    shapes["cond_type_embed.weight"] = (3, dim)
    norm("context_embedder_2.norm", arch.text2_dim)
    linear("context_embedder_2.linear_1", 2048, arch.text2_dim)
    linear("context_embedder_2.linear_2", 2048, 2048)
    linear("context_embedder_2.linear_3", dim, 2048)
    norm("image_embedder.norm_in", arch.image_embed_dim)
    linear("image_embedder.linear_1", arch.image_embed_dim, arch.image_embed_dim)
    linear("image_embedder.linear_2", dim, arch.image_embed_dim)
    norm("image_embedder.norm_out", dim)
    linear("norm_out.linear", 2 * dim, dim)
    linear("proj_out", arch.out_channels, dim)
    prefix = "context_embedder.time_text_embed"
    linear(f"{prefix}.timestep_embedder.linear_1", dim, 256)
    linear(f"{prefix}.timestep_embedder.linear_2", dim, dim)
    linear(f"{prefix}.text_embedder.linear_1", dim, arch.text_dim)
    linear(f"{prefix}.text_embedder.linear_2", dim, dim)
    linear("context_embedder.proj_in", dim, arch.text_dim)
    for i in range(arch.refiner_depth):
        src = f"context_embedder.token_refiner.refiner_blocks.{i}"
        norm(f"{src}.norm1", dim)
        norm(f"{src}.norm2", dim)
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            linear(f"{src}.attn.{proj}", dim, dim)
        linear(f"{src}.ff.net.0.proj", mlp, dim)
        linear(f"{src}.ff.net.2", dim, mlp)
        linear(f"{src}.norm_out.linear", 2 * dim, dim)
    for i in range(arch.depth):
        src = f"transformer_blocks.{i}"
        linear(f"{src}.norm1.linear", 6 * dim, dim)
        linear(f"{src}.norm1_context.linear", 6 * dim, dim)
        for proj in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0", "to_add_out"):
            linear(f"{src}.attn.{proj}", dim, dim)
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            shapes[f"{src}.attn.{name}.weight"] = (hd,)
        for ff in ("ff", "ff_context"):
            linear(f"{src}.{ff}.net.0.proj", mlp, dim)
            linear(f"{src}.{ff}.net.2", dim, mlp)
    return shapes


def qwen_image_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers
    ``QwenImageTransformer2DModel`` of ``arch``
    (``models/qwen_image/transformer.py::QwenImageConfig``; MageFlow and
    Z-Image share the layout) as ``qwen_image_params_from_diffusers`` reads it."""
    dim, hd = arch.hidden_size, arch.head_dim
    inner, mlp = arch.num_heads * hd, int(dim * arch.mlp_ratio)
    shapes: Dict[str, tuple] = {}

    def linear(name, out_features, in_features):
        shapes[f"{name}.weight"] = (out_features, in_features)
        shapes[f"{name}.bias"] = (out_features,)

    linear("img_in", dim, arch.in_channels)
    shapes["txt_norm.weight"] = (arch.txt_in_features,)
    linear("txt_in", dim, arch.txt_in_features)
    linear("time_text_embed.timestep_embedder.linear_1", dim, 256)
    linear("time_text_embed.timestep_embedder.linear_2", dim, dim)
    linear("norm_out.linear", 2 * dim, dim)
    linear("proj_out", arch.in_channels, dim)
    for i in range(arch.depth):
        src = f"transformer_blocks.{i}"
        linear(f"{src}.img_mod.1", 6 * dim, dim)
        linear(f"{src}.txt_mod.1", 6 * dim, dim)
        for proj in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            linear(f"{src}.attn.{proj}", inner, dim)
        linear(f"{src}.attn.to_out.0", dim, inner)
        linear(f"{src}.attn.to_add_out", dim, inner)
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            shapes[f"{src}.attn.{name}.weight"] = (hd,)
        for mlp_name in ("img_mlp", "txt_mlp"):
            linear(f"{src}.{mlp_name}.net.0.proj", mlp, dim)
            linear(f"{src}.{mlp_name}.net.2", dim, mlp)
    return shapes


def hidream_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers
    ``HiDreamImageTransformer2DModel`` of ``arch``
    (``models/hidream/transformer.py::HiDreamConfig``) as
    ``hidream_params_from_diffusers`` reads it: biased projections and
    embedders, bias-free caption projections and SwiGLU weights, per-expert
    ``experts.{e}.w1..w3`` and the bias-free ``gate``."""
    dim, p, e = arch.hidden_size, arch.patch_size, arch.num_experts
    n_blocks = arch.depth_double + arch.depth_single
    shapes: Dict[str, tuple] = {}

    def linear(name, out_features, in_features, bias=True):
        shapes[f"{name}.weight"] = (out_features, in_features)
        if bias:
            shapes[f"{name}.bias"] = (out_features,)

    def ffn(src, inner):
        linear(f"{src}.w1", inner, dim, bias=False)
        linear(f"{src}.w2", dim, inner, bias=False)
        linear(f"{src}.w3", inner, dim, bias=False)

    def attention(src, suffixes):
        for suffix in suffixes:
            for proj in ("to_q", "to_k", "to_v", "to_out"):
                linear(f"{src}.{proj}{suffix}", dim, dim)
            shapes[f"{src}.q_rms_norm{suffix}.weight"] = (dim,)
            shapes[f"{src}.k_rms_norm{suffix}.weight"] = (dim,)

    def moe(src):
        shapes[f"{src}.gate.weight"] = (e, dim)
        for j in range(e):
            ffn(f"{src}.experts.{j}", arch.ffn_inner)
        ffn(f"{src}.shared_experts", arch.shared_ffn_inner)

    linear("x_embedder.proj", dim, p * p * arch.in_channels)
    linear("t_embedder.timestep_embedder.linear_1", dim, 256)
    linear("t_embedder.timestep_embedder.linear_2", dim, dim)
    linear("p_embedder.pooled_embedder.linear_1", dim, arch.pooled_dim)
    linear("p_embedder.pooled_embedder.linear_2", dim, dim)
    for i in range(n_blocks):
        linear(f"caption_projection.{i}.linear", dim, arch.llama_dim, bias=False)
    linear(f"caption_projection.{n_blocks}.linear", dim, arch.t5_dim, bias=False)
    linear("final_layer.adaLN_modulation.1", 2 * dim, dim)
    linear("final_layer.linear", p * p * arch.in_channels, dim)
    for i in range(arch.depth_double):
        src = f"double_stream_blocks.{i}.block"
        linear(f"{src}.adaLN_modulation.1", 12 * dim, dim)
        attention(f"{src}.attn1", ("", "_t"))
        moe(f"{src}.ff_i")
        ffn(f"{src}.ff_t", arch.ffn_inner)
    for i in range(arch.depth_single):
        src = f"single_stream_blocks.{i}.block"
        linear(f"{src}.adaLN_modulation.1", 6 * dim, dim)
        attention(f"{src}.attn1", ("",))
        moe(f"{src}.ff_i")
    return shapes


def flux2_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers ``Flux2Transformer2DModel``
    of ``arch`` (``models/flux2/transformer.py::Flux2Config``) as
    ``flux2_params_from_diffusers`` reads it: bias-free linears, the three
    shared modulations and the guidance embedder where the arch embeds guidance."""
    dim, hd, mlp = arch.hidden_size, arch.head_dim, arch.mlp_hidden
    inner, packed = arch.num_heads * hd, arch.patch_size ** 2 * arch.in_channels
    shapes: Dict[str, tuple] = {"x_embedder.weight": (dim, packed),
                                "context_embedder.weight": (dim, arch.txt_in_features)}
    embedders = ("timestep_embedder", "guidance_embedder") if arch.guidance_embed else ("timestep_embedder",)
    for name in embedders:
        shapes[f"time_guidance_embed.{name}.linear_1.weight"] = (dim, 256)
        shapes[f"time_guidance_embed.{name}.linear_2.weight"] = (dim, dim)
    shapes["double_stream_modulation_img.linear.weight"] = (6 * dim, dim)
    shapes["double_stream_modulation_txt.linear.weight"] = (6 * dim, dim)
    shapes["single_stream_modulation.linear.weight"] = (3 * dim, dim)
    shapes["norm_out.linear.weight"] = (2 * dim, dim)
    shapes["proj_out.weight"] = (packed, dim)
    for i in range(arch.depth_double):
        src = f"transformer_blocks.{i}"
        for proj in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            shapes[f"{src}.attn.{proj}.weight"] = (inner, dim)
        shapes[f"{src}.attn.to_out.0.weight"] = (dim, inner)
        shapes[f"{src}.attn.to_add_out.weight"] = (dim, inner)
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            shapes[f"{src}.attn.{name}.weight"] = (hd,)
        for ff in ("ff", "ff_context"):
            shapes[f"{src}.{ff}.linear_in.weight"] = (2 * mlp, dim)
            shapes[f"{src}.{ff}.linear_out.weight"] = (dim, mlp)
    for i in range(arch.depth_single):
        src = f"single_transformer_blocks.{i}.attn"
        shapes[f"{src}.to_qkv_mlp_proj.weight"] = (3 * inner + 2 * mlp, dim)
        shapes[f"{src}.to_out.weight"] = (dim, inner + mlp)
        shapes[f"{src}.norm_q.weight"] = (hd,)
        shapes[f"{src}.norm_k.weight"] = (hd,)
    return shapes


def longcat_image_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a LongCat-Image transformer of
    ``arch`` as ``load_longcat_image_params`` reads it: the diffusers Flux
    layout (no pooled-text or guidance embedder) with the timestep embedder
    under ``time_embed.``."""
    return {("time_embed." + k[len("time_text_embed."):] if k.startswith("time_text_embed.") else k): v
            for k, v in flux_checkpoint_shapes(arch).items()}


def z_image_omni_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a ``ZImageOmniTransformer2DModel`` of
    ``arch`` (``models/z_image_omni/transformer.py::ZImageOmniConfig``) as
    ``z_image_omni_params_from_diffusers`` reads it, SigLIP modules included:
    bias-free attention and SwiGLU, biased embedders, time MLP, modulation and
    final linears."""
    dim, dh, inner, p = arch.hidden_size, arch.head_dim, arch.ffn_inner, arch.patch_size
    patch_key = f"{p}-1"
    shapes: Dict[str, tuple] = {"cap_pad_token": (1, dim)}

    def linear(name, out_features, in_features, bias=True):
        shapes[f"{name}.weight"] = (out_features, in_features)
        if bias:
            shapes[f"{name}.bias"] = (out_features,)

    linear("t_embedder.mlp.0", arch.t_mid_size, 256)
    linear("t_embedder.mlp.2", arch.adaln_dim, arch.t_mid_size)
    linear(f"all_x_embedder.{patch_key}", dim, p * p * arch.in_channels)
    shapes["cap_embedder.0.weight"] = (arch.cap_feat_dim,)
    linear("cap_embedder.1", dim, arch.cap_feat_dim)
    shapes["siglip_embedder.0.weight"] = (arch.siglip_feat_dim,)
    linear("siglip_embedder.1", dim, arch.siglip_feat_dim)
    linear(f"all_final_layer.{patch_key}.adaLN_modulation.1", dim, arch.adaln_dim)
    linear(f"all_final_layer.{patch_key}.linear", p * p * arch.in_channels, dim)
    blocks = [(f"{prefix}.{i}", prefix == "noise_refiner") for prefix in
              ("noise_refiner", "context_refiner", "siglip_refiner") for i in range(arch.refiner_depth)]
    blocks += [(f"layers.{i}", True) for i in range(arch.depth)]
    for src, modulated in blocks:
        linear(f"{src}.attention.to_q", arch.num_heads * dh, dim, bias=False)
        linear(f"{src}.attention.to_k", arch.num_kv_heads * dh, dim, bias=False)
        linear(f"{src}.attention.to_v", arch.num_kv_heads * dh, dim, bias=False)
        linear(f"{src}.attention.to_out.0", dim, arch.num_heads * dh, bias=False)
        shapes[f"{src}.attention.norm_q.weight"] = (dh,)
        shapes[f"{src}.attention.norm_k.weight"] = (dh,)
        linear(f"{src}.feed_forward.w1", inner, dim, bias=False)
        linear(f"{src}.feed_forward.w3", inner, dim, bias=False)
        linear(f"{src}.feed_forward.w2", dim, inner, bias=False)
        for norm in ("attention_norm1", "attention_norm2", "ffn_norm1", "ffn_norm2"):
            shapes[f"{src}.{norm}.weight"] = (dim,)
        if modulated:
            linear(f"{src}.adaLN_modulation.0", 4 * dim, arch.adaln_dim)
    return shapes


def zlab_i1_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a ``ZlabI1Transformer2DModel`` of
    ``arch`` (``models/zlab_i1/transformer.py::ZlabI1Config``) as
    ``zlab_i1_params_from_checkpoint`` reads it: the patch conv, the native
    position table, the text connector with its null caption, the in / mid /
    out blocks (biased linears, RMSNorm ``scale`` leaves) and the head."""
    dim, p, inner = arch.hidden_size, arch.patch_size, arch.ffn_inner
    hw = arch.input_size // p
    adapter = "text_encoder_adapter"
    shapes: Dict[str, tuple] = {"x_embedder.proj.weight": (dim, arch.in_channels, p, p),
                                "x_embedder.proj.bias": (dim,), "pos_embed": (1, hw * hw, dim),
                                f"{adapter}.learnable_null_caption": (1, arch.text_num_tokens, arch.text_embed_dim)}

    def linear(name, out_features, in_features):
        shapes[f"{name}.weight"] = (out_features, in_features)
        shapes[f"{name}.bias"] = (out_features,)

    def swiglu(src):
        linear(f"{src}.w12", 2 * inner, dim)
        linear(f"{src}.w3", dim, inner)

    linear(f"{adapter}.connector_in", dim, arch.text_embed_dim)
    for i in range(1, 5):
        shapes[f"{adapter}.connector_norm{i}.scale"] = (dim,)
    for name in ("connector_attn", "connector_attn2"):
        linear(f"{adapter}.{name}.qkv", 3 * dim, dim)
        linear(f"{adapter}.{name}.proj", dim, dim)
        shapes[f"{adapter}.{name}.q_norm.scale"] = (arch.head_dim,)
        shapes[f"{adapter}.{name}.k_norm.scale"] = (arch.head_dim,)
    swiglu(f"{adapter}.connector_mlp")
    swiglu(f"{adapter}.connector_mlp2")
    blocks = [("mid_block", False)] + [(f"in_blocks.{i}", False) for i in range(arch.num_in_blocks)]
    blocks += [(f"out_blocks.{i}", True) for i in range(arch.num_in_blocks)]
    for src, use_skip in blocks:
        for norm in ("norm1", "norm2", "norm3", "norm4"):
            shapes[f"{src}.{norm}.scale"] = (dim,)
        linear(f"{src}.attn.qkv_image", 3 * dim, dim)
        linear(f"{src}.attn.qkv_text", 3 * dim, dim)
        shapes[f"{src}.attn.q_norm.scale"] = (arch.head_dim,)
        shapes[f"{src}.attn.k_norm.scale"] = (arch.head_dim,)
        linear(f"{src}.attn.proj_image", dim, dim)
        linear(f"{src}.attn.proj_text", dim, dim)
        swiglu(f"{src}.mlp_image")
        swiglu(f"{src}.mlp_text")
        if use_skip:
            linear(f"{src}.skip_linear_image", dim, 2 * dim)
            linear(f"{src}.skip_linear_text", dim, 2 * dim)
    shapes["final_layer.norm_final.scale"] = (dim,)
    linear("final_layer.linear", p * p * arch.in_channels, dim)
    return shapes


def krea2_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a ``Krea2Transformer2DModel`` of
    ``arch`` (``models/krea2/transformer.py::Krea2Config``) as
    ``krea2_params_from_checkpoint`` reads it: biased embedders and heads,
    bias-free attention and SwiGLU, the zero-centred norms' ``weight``
    leaves, the (1, L) projector and the per-block tables."""
    h, hd, dt = arch.hidden_size, arch.attention_head_dim, arch.text_hidden_dim
    shapes: Dict[str, tuple] = {"text_fusion.projector.weight": (1, arch.num_text_layers),
                                "txt_in.norm.weight": (dt,), "final_layer.scale_shift_table": (2, h),
                                "final_layer.norm.weight": (h,)}

    def linear(name, out_features, in_features, bias=True):
        shapes[f"{name}.weight"] = (out_features, in_features)
        if bias:
            shapes[f"{name}.bias"] = (out_features,)

    def block(src, dim, heads, kv_heads, head_dim, inner):
        shapes[f"{src}.norm1.weight"] = (dim,)
        shapes[f"{src}.norm2.weight"] = (dim,)
        for name, out_features in (("to_q", heads), ("to_k", kv_heads), ("to_v", kv_heads), ("to_gate", heads)):
            linear(f"{src}.attn.{name}", out_features * head_dim, dim, bias=False)
        linear(f"{src}.attn.to_out.0", heads * head_dim, heads * head_dim, bias=False)
        shapes[f"{src}.attn.norm_q.weight"] = (head_dim,)
        shapes[f"{src}.attn.norm_k.weight"] = (head_dim,)
        linear(f"{src}.ff.gate", inner, dim, bias=False)
        linear(f"{src}.ff.up", inner, dim, bias=False)
        linear(f"{src}.ff.down", dim, inner, bias=False)

    linear("img_in", h, arch.in_channels)
    linear("time_embed.linear_1", h, arch.timestep_embed_dim)
    linear("time_embed.linear_2", h, h)
    linear("time_mod_proj", 6 * h, h)
    linear("txt_in.linear_1", h, dt)
    linear("txt_in.linear_2", h, h)
    linear("final_layer.linear", arch.in_channels, h)
    text_heads = (arch.text_num_attention_heads, arch.text_num_key_value_heads, dt // arch.text_num_attention_heads)
    for kind, count in (("layerwise", arch.num_layerwise_text_blocks), ("refiner", arch.num_refiner_text_blocks)):
        for i in range(count):
            block(f"text_fusion.{kind}_blocks.{i}", dt, *text_heads, arch.text_intermediate_size)
    for i in range(arch.num_layers):
        shapes[f"transformer_blocks.{i}.scale_shift_table"] = (6, h)
        block(f"transformer_blocks.{i}", h, arch.num_attention_heads, arch.num_key_value_heads, hd,
              arch.intermediate_size)
    return shapes


def cosmos1_checkpoint_shapes(arch, prefix: str = "") -> Dict[str, tuple]:
    """Tensor names and torch shapes of a ``CosmosTransformer3DModel`` of
    ``arch`` (``models/cosmos1/transformer.py::Cosmos1Config``) as
    ``cosmos1_params_from_checkpoint`` reads it, every name after
    ``prefix``: all linears bias-free, the patch embed over the latent
    channels and the padding-mask plane."""
    h, hd = arch.hidden_size, arch.head_dim
    pt, ph, pw = arch.patch_size
    mlp, lora = int(h * arch.mlp_ratio), arch.adaln_lora_dim
    c_in = arch.in_channels + (1 if arch.concat_padding_mask else 0)
    shapes: Dict[str, tuple] = {}

    def linear(name, out_features, in_features):
        shapes[f"{prefix}{name}.weight"] = (out_features, in_features)

    linear("patch_embed.proj", h, c_in * pt * ph * pw)
    linear("time_embed.t_embedder.linear_1", h, h)
    linear("time_embed.t_embedder.linear_2", 3 * h, h)
    shapes[f"{prefix}time_embed.norm.weight"] = (h,)
    linear("norm_out.linear_1", lora, h)
    linear("norm_out.linear_2", 2 * h, lora)
    linear("proj_out", pt * ph * pw * arch.out_channels, h)
    if arch.learnable_pos_embed:
        for axis, size, patch in zip("thw", arch.max_size, arch.patch_size):
            shapes[f"{prefix}learnable_pos_embed.pos_emb_{axis}"] = (size // patch, h)
    for i in range(arch.num_layers):
        src = f"transformer_blocks.{i}"
        for norm in ("norm1", "norm2", "norm3"):
            linear(f"{src}.{norm}.linear_1", lora, h)
            linear(f"{src}.{norm}.linear_2", 3 * h, lora)
        for attn, kv_in in (("attn1", h), ("attn2", arch.text_embed_dim)):
            linear(f"{src}.{attn}.to_q", h, h)
            linear(f"{src}.{attn}.to_k", h, kv_in)
            linear(f"{src}.{attn}.to_v", h, kv_in)
            linear(f"{src}.{attn}.to_out.0", h, h)
            shapes[f"{prefix}{src}.{attn}.norm_q.weight"] = (hd,)
            shapes[f"{prefix}{src}.{attn}.norm_k.weight"] = (hd,)
        linear(f"{src}.ff.net.0.proj", mlp, h)
        linear(f"{src}.ff.net.2", h, mlp)
    return shapes


def anima_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of an ``AnimaTransformerModel`` of
    ``arch`` (``models/anima/transformer.py::AnimaConfig``) as
    ``anima_params_from_checkpoint`` reads it: the LLM adapter (the T5-id
    table, bias-free attention with q/k norms, biased MLPs and head) and the
    Cosmos core under ``core.``."""
    d, hd = arch.adapter_dim, arch.adapter_dim // arch.adapter_heads
    shapes: Dict[str, tuple] = {"llm_adapter.embed.weight": (arch.adapter_vocab_size, d),
                                "llm_adapter.out_proj.weight": (d, d), "llm_adapter.out_proj.bias": (d,),
                                "llm_adapter.norm.weight": (d,)}
    for i in range(arch.adapter_layers):
        src = f"llm_adapter.blocks.{i}"
        for norm in ("norm_self_attn", "norm_cross_attn", "norm_mlp"):
            shapes[f"{src}.{norm}.weight"] = (d,)
        for attn in ("self_attn", "cross_attn"):
            for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
                shapes[f"{src}.{attn}.{proj}.weight"] = (d, d)
            shapes[f"{src}.{attn}.q_norm.weight"] = (hd,)
            shapes[f"{src}.{attn}.k_norm.weight"] = (hd,)
        shapes.update({f"{src}.mlp.0.weight": (4 * d, d), f"{src}.mlp.0.bias": (4 * d,),
                       f"{src}.mlp.2.weight": (d, 4 * d), f"{src}.mlp.2.bias": (d,)})
    shapes.update(cosmos1_checkpoint_shapes(arch.core, prefix="core."))
    return shapes


def omnigen_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers ``OmniGenTransformer2DModel``
    of ``arch`` (``models/omnigen/transformer.py::OmniGenConfig``) as
    ``omnigen_params_from_diffusers`` reads it: the 2 x 2 patch conv, the
    token table, the two timestep MLPs, the bias-free Phi-3 blocks with the
    fused ``gate_up_proj``, the RMSNorm ``weight`` leaves and the biased heads
    (the published file's input-image branch, which the importer leaves
    unread, is not written)."""
    h, p, hd = arch.hidden_size, arch.patch_size, arch.hidden_size // arch.num_heads
    shapes: Dict[str, tuple] = {
        "patch_embedding.output_image_proj.weight": (h, arch.in_channels, p, p),
        "patch_embedding.output_image_proj.bias": (h,),
        "embed_tokens.weight": (arch.vocab_size, h), "norm.weight": (h,),
        "norm_out.linear.weight": (2 * h, h), "norm_out.linear.bias": (2 * h,),
        "proj_out.weight": (p * p * arch.in_channels, h), "proj_out.bias": (p * p * arch.in_channels,),
    }
    for name in ("t_embedder", "time_token"):
        shapes.update({f"{name}.linear_1.weight": (h, arch.time_step_dim), f"{name}.linear_1.bias": (h,),
                       f"{name}.linear_2.weight": (h, h), f"{name}.linear_2.bias": (h,)})
    for i in range(arch.num_layers):
        src = f"layers.{i}"
        shapes.update({
            f"{src}.input_layernorm.weight": (h,), f"{src}.post_attention_layernorm.weight": (h,),
            f"{src}.self_attn.to_q.weight": (arch.num_heads * hd, h),
            f"{src}.self_attn.to_k.weight": (arch.num_kv_heads * hd, h),
            f"{src}.self_attn.to_v.weight": (arch.num_kv_heads * hd, h),
            f"{src}.self_attn.to_out.0.weight": (h, arch.num_heads * hd),
            f"{src}.mlp.gate_up_proj.weight": (2 * arch.intermediate_size, h),
            f"{src}.mlp.down_proj.weight": (h, arch.intermediate_size),
        })
    return shapes


def ernie_checkpoint_shapes(arch, text_proj: bool = True) -> Dict[str, tuple]:
    """Tensor names and torch shapes of an ``ErnieImageTransformer2DModel`` of
    ``arch`` (``models/ernie/transformer.py::ErnieConfig``) as
    ``ernie_params_from_checkpoint`` reads it: the k = 1 conv ``x_embedder``,
    the biased time MLP, shared AdaLN and heads, the bias-free blocks with
    their norm ``weight`` leaves, and ``text_proj`` where the text width is
    not the hidden width."""
    h, hd, ffn = arch.hidden_size, arch.head_dim, arch.ffn_hidden_size
    shapes: Dict[str, tuple] = {"x_embedder.proj.weight": (h, arch.in_channels, 1, 1), "x_embedder.proj.bias": (h,)}
    for name, out_features, in_features in (("time_embedding.linear_1", h, h), ("time_embedding.linear_2", h, h),
                                            ("adaLN_modulation.1", 6 * h, h), ("final_norm.linear", 2 * h, h),
                                            ("final_linear", arch.out_channels, h)):
        shapes.update({f"{name}.weight": (out_features, in_features), f"{name}.bias": (out_features,)})
    if text_proj and arch.text_in_dim != h:
        shapes["text_proj.weight"] = (h, arch.text_in_dim)
    for i in range(arch.num_layers):
        src = f"layers.{i}"
        shapes.update({f"{src}.adaLN_sa_ln.weight": (h,), f"{src}.adaLN_mlp_ln.weight": (h,),
                       f"{src}.self_attention.norm_q.weight": (hd,), f"{src}.self_attention.norm_k.weight": (hd,),
                       f"{src}.mlp.gate_proj.weight": (ffn, h), f"{src}.mlp.up_proj.weight": (ffn, h),
                       f"{src}.mlp.linear_fc2.weight": (h, ffn)})
        for name in ("to_q", "to_k", "to_v", "to_out.0"):
            shapes[f"{src}.self_attention.{name}.weight"] = (h, h)
    return shapes


def ideogram_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of an ``Ideogram4Transformer`` of ``arch``
    (``models/ideogram/transformer.py::IdeogramConfig``) as
    ``ideogram_params_from_checkpoint`` reads it: biased input, conditioning,
    time and AdaLN projections and heads, the (2, dim) indicator table, the
    bias-free fused ``qkv`` / ``o`` / SwiGLU and the norm ``weight`` leaves."""
    d, hd, ffn, a = arch.emb_dim, arch.head_dim, arch.intermediate_size, arch.adanln_dim
    shapes: Dict[str, tuple] = {"llm_cond_norm.weight": (arch.llm_features_dim,),
                                "embed_image_indicator.weight": (2, d)}
    for name, out_features, in_features in (("input_proj", d, arch.in_channels),
                                            ("llm_cond_proj", d, arch.llm_features_dim),
                                            ("t_embedding.mlp_in", d, d), ("t_embedding.mlp_out", d, d),
                                            ("adaln_proj", a, d), ("final_layer.linear", arch.in_channels, d),
                                            ("final_layer.adaln_modulation", d, a)):
        shapes.update({f"{name}.weight": (out_features, in_features), f"{name}.bias": (out_features,)})
    for i in range(arch.num_layers):
        src = f"layers.{i}"
        shapes.update({f"{src}.attention.qkv.weight": (3 * d, d), f"{src}.attention.o.weight": (d, d),
                       f"{src}.attention.norm_q.weight": (hd,), f"{src}.attention.norm_k.weight": (hd,),
                       f"{src}.feed_forward.w1.weight": (ffn, d), f"{src}.feed_forward.w3.weight": (ffn, d),
                       f"{src}.feed_forward.w2.weight": (d, ffn),
                       f"{src}.adaln_modulation.weight": (4 * d, a), f"{src}.adaln_modulation.bias": (4 * d,)})
        for norm in ("attention_norm1", "attention_norm2", "ffn_norm1", "ffn_norm2"):
            shapes[f"{src}.{norm}.weight"] = (d,)
    return shapes


def cosmos3_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a flat ``Cosmos3OmniTransformer`` of
    ``arch`` (``models/cosmos3/transformer.py::Cosmos3Config``) as
    ``cosmos3_params_from_checkpoint`` reads it: the token table and
    ``lm_head``, the biased ``proj_in`` / ``proj_out`` and time MLP, and per
    layer both pathways' projections (biased where ``attention_bias``), the
    per-head q / k norms, the four layer norms and both SwiGLUs."""
    d, hd, ffn, v, p = (arch.hidden_size, arch.head_dim, arch.intermediate_size, arch.vocab_size,
                        arch.patch_latent_dim)
    q_out, kv_out = arch.num_heads * hd, arch.num_kv_heads * hd
    shapes: Dict[str, tuple] = {"embed_tokens.weight": (v, d), "norm.weight": (d,), "norm_moe_gen.weight": (d,),
                                "lm_head.weight": (v, d)}
    for name, out_features, in_features in (("proj_in", d, p), ("proj_out", p, d),
                                            ("time_embedder.linear_1", d, 256), ("time_embedder.linear_2", d, d)):
        shapes.update({f"{name}.weight": (out_features, in_features), f"{name}.bias": (out_features,)})
    for i in range(arch.num_layers):
        src = f"layers.{i}"
        for und, gen, out_features, in_features in (("to_q", "add_q_proj", q_out, d), ("to_k", "add_k_proj", kv_out, d),
                                                    ("to_v", "add_v_proj", kv_out, d),
                                                    ("to_out", "to_add_out", d, q_out)):
            for name in (und, gen):
                shapes[f"{src}.self_attn.{name}.weight"] = (out_features, in_features)
                if arch.attention_bias:
                    shapes[f"{src}.self_attn.{name}.bias"] = (out_features,)
        for norm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            shapes[f"{src}.self_attn.{norm}.weight"] = (hd,)
        for norm in ("input_layernorm", "post_attention_layernorm", "input_layernorm_moe_gen",
                     "post_attention_layernorm_moe_gen"):
            shapes[f"{src}.{norm}.weight"] = (d,)
        for mlp in ("mlp", "mlp_moe_gen"):
            shapes.update({f"{src}.{mlp}.gate_proj.weight": (ffn, d), f"{src}.{mlp}.up_proj.weight": (ffn, d),
                           f"{src}.{mlp}.down_proj.weight": (d, ffn)})
    return shapes


def llm_checkpoint_shapes(cfg) -> Dict[str, tuple]:
    """Tensor names and torch shapes of an HF causal LM of ``cfg``
    (``models/llm_encoder.py::LLMEncoderConfig``) as ``llm_params_from_hf``
    reads it: ``model.*`` for the llama / qwen2 / mistral / gemma2 layouts
    (Gemma-2's four norms per layer), ``transformer.*`` for ChatGLM."""
    dim, dh, ffn = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    q_out, kv_out = cfg.num_heads * dh, cfg.num_kv_heads * dh
    if cfg.arch == "chatglm":
        shapes: Dict[str, tuple] = {"transformer.embedding.word_embeddings.weight": (cfg.vocab_size, dim),
                                    "transformer.encoder.final_layernorm.weight": (dim,)}
        for i in range(cfg.num_layers):
            src = f"transformer.encoder.layers.{i}"
            shapes[f"{src}.input_layernorm.weight"] = (dim,)
            shapes[f"{src}.self_attention.query_key_value.weight"] = (q_out + 2 * kv_out, dim)
            if cfg.qkv_bias:
                shapes[f"{src}.self_attention.query_key_value.bias"] = (q_out + 2 * kv_out,)
            shapes[f"{src}.self_attention.dense.weight"] = (dim, q_out)
            shapes[f"{src}.post_attention_layernorm.weight"] = (dim,)
            shapes[f"{src}.mlp.dense_h_to_4h.weight"] = (2 * ffn, dim)
            shapes[f"{src}.mlp.dense_4h_to_h.weight"] = (dim, ffn)
        return shapes
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, dim), "model.norm.weight": (dim,)}
    norms = ("input_layernorm", "post_attention_layernorm") + (
        ("pre_feedforward_layernorm", "post_feedforward_layernorm") if cfg.sandwich_norms else ())
    for i in range(cfg.num_layers):
        src = f"model.layers.{i}"
        for norm in norms:
            shapes[f"{src}.{norm}.weight"] = (dim,)
        for proj, out_features in (("q_proj", q_out), ("k_proj", kv_out), ("v_proj", kv_out)):
            shapes[f"{src}.self_attn.{proj}.weight"] = (out_features, dim)
            if cfg.qkv_bias:
                shapes[f"{src}.self_attn.{proj}.bias"] = (out_features,)
        shapes[f"{src}.self_attn.o_proj.weight"] = (dim, q_out)
        shapes[f"{src}.mlp.gate_proj.weight"] = (ffn, dim)
        shapes[f"{src}.mlp.up_proj.weight"] = (ffn, dim)
        shapes[f"{src}.mlp.down_proj.weight"] = (dim, ffn)
    return shapes



def _linears(shapes: Dict[str, tuple], table, bias: bool = True) -> None:
    """``(name, out, in)`` rows as ``weight`` (and ``bias``) shapes."""
    for name, out_features, in_features in table:
        shapes[f"{name}.weight"] = (out_features, in_features)
        if bias:
            shapes[f"{name}.bias"] = (out_features,)


def longcat_video_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a ``LongCatVideoTransformer3DModel`` of
    ``arch`` (``models/longcat_video/transformer.py::LongCatVideoConfig``) as
    ``longcat_video_params_from_checkpoint`` reads it: the Conv3d
    ``x_embedder``, the biased time, caption and AdaLN MLPs, the fused
    ``qkv``, the cross-attention's ``q_linear`` / ``kv_linear``, the bias-free
    SwiGLU and the norm leaves."""
    d, hd, ffn, temb = arch.hidden_size, arch.head_dim, arch.ffn_hidden, arch.adaln_tembed_dim
    pt, ph, pw = arch.patch_size
    shapes: Dict[str, tuple] = {"x_embedder.proj.weight": (d, arch.in_channels, pt, ph, pw),
                                "x_embedder.proj.bias": (d,)}
    _linears(shapes, (("t_embedder.mlp.0", temb, arch.frequency_embedding_size), ("t_embedder.mlp.2", temb, temb),
                      ("y_embedder.y_proj.0", d, arch.caption_channels), ("y_embedder.y_proj.2", d, d),
                      ("final_layer.adaLN_modulation.1", 2 * d, temb),
                      ("final_layer.linear", pt * ph * pw * arch.out_channels, d)))
    for i in range(arch.depth):
        src = f"blocks.{i}"
        _linears(shapes, ((f"{src}.adaLN_modulation.1", 6 * d, temb), (f"{src}.attn.qkv", 3 * d, d),
                          (f"{src}.attn.proj", d, d), (f"{src}.cross_attn.q_linear", d, d),
                          (f"{src}.cross_attn.kv_linear", 2 * d, d), (f"{src}.cross_attn.proj", d, d)))
        _linears(shapes, ((f"{src}.ffn.w1", ffn, d), (f"{src}.ffn.w3", ffn, d), (f"{src}.ffn.w2", d, ffn)), bias=False)
        shapes.update({f"{src}.attn.q_norm.weight": (hd,), f"{src}.attn.k_norm.weight": (hd,),
                       f"{src}.cross_attn.q_norm.weight": (hd,), f"{src}.cross_attn.k_norm.weight": (hd,),
                       f"{src}.pre_crs_attn_norm.weight": (d,), f"{src}.pre_crs_attn_norm.bias": (d,)})
    return shapes


def sana_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers ``SanaTransformer2DModel``
    of ``arch`` (``models/sana/transformer.py::SanaConfig``) as
    ``sana_params_from_diffusers`` reads it: the patch conv, the caption MLP
    and norm, the time MLP and 6-way projection, the (2, dim) table and
    ``proj_out``, and per block the (6, dim) table, the biased attention
    projections and the Mix-FFN's three convs."""
    d, p, hidden = arch.hidden_size, arch.patch_size, int(arch.hidden_size * arch.ffn_ratio)
    inner_self, inner_cross = arch.self_heads * arch.self_head_dim, arch.cross_heads * arch.cross_head_dim
    shapes: Dict[str, tuple] = {"patch_embed.proj.weight": (d, arch.in_channels, p, p), "patch_embed.proj.bias": (d,),
                                "caption_norm.weight": (d,), "scale_shift_table": (2, d)}
    _linears(shapes, (("caption_projection.linear_1", d, arch.text_dim), ("caption_projection.linear_2", d, d),
                      ("time_embed.emb.timestep_embedder.linear_1", d, 256),
                      ("time_embed.emb.timestep_embedder.linear_2", d, d), ("time_embed.linear", 6 * d, d),
                      ("proj_out", p * p * arch.in_channels, d)))
    for i in range(arch.depth):
        src = f"transformer_blocks.{i}"
        shapes[f"{src}.scale_shift_table"] = (6, d)
        _linears(shapes, [(f"{src}.attn1.{name}", inner_self, d) for name in ("to_q", "to_k", "to_v")] +
                 [(f"{src}.attn1.to_out.0", d, inner_self)] +
                 [(f"{src}.attn2.{name}", inner_cross, d) for name in ("to_q", "to_k", "to_v")] +
                 [(f"{src}.attn2.to_out.0", d, inner_cross)])
        shapes.update({f"{src}.ff.conv_inverted.weight": (2 * hidden, d, 1, 1),
                       f"{src}.ff.conv_inverted.bias": (2 * hidden,),
                       f"{src}.ff.conv_depth.weight": (2 * hidden, 1, 3, 3), f"{src}.ff.conv_depth.bias": (2 * hidden,),
                       f"{src}.ff.conv_point.weight": (d, hidden, 1, 1)})
    return shapes


def sanavideo_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a ``SanaVideoTransformer3DModel`` of
    ``arch`` (``models/sanavideo/transformer.py::SanaVideoConfig``) as
    ``sanavideo_params_from_checkpoint`` reads it: the Conv3d patch embed,
    the AdaLayerNormSingle and caption MLPs, the caption norm, the (2, dim)
    table and ``proj_out``, and per block the (6, dim) table, the bias-free
    self-attention projections, the biased cross-attention ones, the
    across-heads norms and the four GLUMBTempConv convs."""
    d, hidden = arch.hidden_size, int(arch.mlp_ratio * arch.hidden_size)
    inner_cross = arch.cross_heads * arch.cross_head_dim
    pt, ph, pw = arch.patch_size
    shapes: Dict[str, tuple] = {"patch_embedding.weight": (d, arch.in_channels, pt, ph, pw),
                                "patch_embedding.bias": (d,), "caption_norm.weight": (d,), "scale_shift_table": (2, d)}
    _linears(shapes, (("time_embed.emb.timestep_embedder.linear_1", d, 256),
                      ("time_embed.emb.timestep_embedder.linear_2", d, d), ("time_embed.linear", 6 * d, d),
                      ("caption_projection.linear_1", d, arch.caption_channels), ("caption_projection.linear_2", d, d),
                      ("proj_out", pt * ph * pw * arch.out_channels, d)))
    for i in range(arch.num_layers):
        src = f"transformer_blocks.{i}"
        shapes[f"{src}.scale_shift_table"] = (6, d)
        _linears(shapes, [(f"{src}.attn1.{name}", d, d) for name in ("to_q", "to_k", "to_v")], bias=False)
        _linears(shapes, [(f"{src}.attn1.to_out.0", d, d)] +
                 [(f"{src}.attn2.{name}", inner_cross, d) for name in ("to_q", "to_k", "to_v")] +
                 [(f"{src}.attn2.to_out.0", d, inner_cross)])
        shapes.update({f"{src}.attn1.norm_q.weight": (d,), f"{src}.attn1.norm_k.weight": (d,),
                       f"{src}.attn2.norm_q.weight": (inner_cross,), f"{src}.attn2.norm_k.weight": (inner_cross,),
                       f"{src}.ff.conv_inverted.weight": (2 * hidden, d, 1, 1),
                       f"{src}.ff.conv_inverted.bias": (2 * hidden,),
                       f"{src}.ff.conv_depth.weight": (2 * hidden, 1, 3, 3), f"{src}.ff.conv_depth.bias": (2 * hidden,),
                       f"{src}.ff.conv_point.weight": (d, hidden, 1, 1), f"{src}.ff.conv_temp.weight": (d, d, 3, 1)})
    return shapes


def ltx2_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of an ``LTX2VideoTransformer3DModel`` of
    ``arch`` (``models/ltxvideo2/transformer.py::LTX2Config``) as
    ``ltx2_params_from_diffusers`` reads it: the projections in and out of
    both streams, the two caption MLPs, the six adaLN heads, the (2, dim)
    tables, and per block the four modulation tables, the six attentions
    (biased q / k / v / out, the across-heads norms, the gate logits of a
    gated stream) and the two FFNs."""
    d, a = arch.inner_dim, arch.audio_inner_dim
    a_inner = arch.audio_num_heads * arch.audio_head_dim
    shapes: Dict[str, tuple] = {"scale_shift_table": (2, d), "audio_scale_shift_table": (2, a)}
    table = [("proj_in", d, arch.in_channels), ("audio_proj_in", a, arch.audio_in_channels),
             ("caption_projection.linear_1", d, arch.caption_channels), ("caption_projection.linear_2", d, d),
             ("audio_caption_projection.linear_1", a, arch.caption_channels),
             ("audio_caption_projection.linear_2", a, a),
             ("proj_out", arch.in_channels, d), ("audio_proj_out", arch.audio_in_channels, a)]
    for name, width, n in (("time_embed", d, 6), ("audio_time_embed", a, 6), ("av_cross_attn_video_scale_shift", d, 4),
                           ("av_cross_attn_video_a2v_gate", d, 1), ("av_cross_attn_audio_scale_shift", a, 4),
                           ("av_cross_attn_audio_v2a_gate", a, 1)):
        table += [(f"{name}.emb.timestep_embedder.linear_1", width, 256),
                  (f"{name}.emb.timestep_embedder.linear_2", width, width), (f"{name}.linear", n * width, width)]
    for i in range(arch.num_layers):
        src = f"transformer_blocks.{i}"
        shapes.update({f"{src}.scale_shift_table": (6, d), f"{src}.audio_scale_shift_table": (6, a),
                       f"{src}.video_a2v_cross_attn_scale_shift_table": (5, d),
                       f"{src}.audio_a2v_cross_attn_scale_shift_table": (5, a)})
        for attn, query, kv, inner, heads, gated in (
                ("attn1", d, d, d, arch.num_heads, arch.gated_attn),
                ("audio_attn1", a, a, a_inner, arch.audio_num_heads, arch.audio_gated_attn),
                ("attn2", d, d, d, arch.num_heads, arch.gated_attn),
                ("audio_attn2", a, a, a_inner, arch.audio_num_heads, arch.audio_gated_attn),
                ("audio_to_video_attn", d, a, a_inner, arch.audio_num_heads, arch.gated_attn),
                ("video_to_audio_attn", a, d, a_inner, arch.audio_num_heads, arch.audio_gated_attn)):
            table += [(f"{src}.{attn}.to_q", inner, query), (f"{src}.{attn}.to_k", inner, kv),
                      (f"{src}.{attn}.to_v", inner, kv), (f"{src}.{attn}.to_out.0", query, inner)]
            if gated:
                table.append((f"{src}.{attn}.to_gate_logits", heads, query))
            shapes.update({f"{src}.{attn}.norm_q.weight": (inner,), f"{src}.{attn}.norm_k.weight": (inner,)})
        for ff, width in (("ff", d), ("audio_ff", a)):
            table += [(f"{src}.{ff}.net.0.proj", 4 * width, width), (f"{src}.{ff}.net.2", width, 4 * width)]
    _linears(shapes, table)
    return shapes


def ltx2_upsampler_checkpoint_shapes(config) -> Dict[str, tuple]:
    """Tensor names and torch shapes of an LTX-2 latent upsampler of
    ``config`` (``models/ltxvideo2/latent_upsampler.py::LTX2UpsamplerConfig``)
    as ``ltx2_upsampler_params`` reads it."""
    mid, shapes = config.mid_channels, {}

    def conv(name, out_channels, in_channels, kernel=(3, 3, 3)):
        shapes[f"{name}.weight"] = (out_channels, in_channels, *kernel)
        shapes[f"{name}.bias"] = (out_channels,)

    def norm(name):
        shapes[f"{name}.weight"] = shapes[f"{name}.bias"] = (mid,)

    conv("initial_conv", mid, config.in_channels)
    norm("initial_norm")
    for prefix in ("res_blocks", "post_upsample_res_blocks"):
        for i in range(config.num_blocks_per_stage):
            for j in (1, 2):
                conv(f"{prefix}.{i}.conv{j}", mid, mid)
                norm(f"{prefix}.{i}.norm{j}")
    if config.spatial_upsample and config.temporal_upsample:
        conv("upsampler.0", 8 * mid, mid)
    elif config.spatial_upsample and config.rational_resampler:
        num = {0.75: 3, 1.5: 3, 2.0: 2, 4.0: 4}[float(config.spatial_scale)]
        conv("upsampler.conv", num * num * mid, mid, (3, 3))
    elif config.spatial_upsample:
        conv("upsampler.0", 4 * mid, mid, (3, 3))
    else:
        conv("upsampler.0", 2 * mid, mid)
    conv("final_conv", config.in_channels, mid)
    return shapes


def ltx2_connector_checkpoint_shapes(config) -> Dict[str, tuple]:
    """Tensor names and torch shapes of ``LTX2TextConnectors`` of ``config``
    (``models/ltxvideo2/connectors.py::LTX2ConnectorConfig``) as
    ``ltx2_connector_params`` reads it."""
    dim = config.inner_dim
    shapes: Dict[str, tuple] = {"text_proj_in.weight": (config.caption_channels,
                                                        config.caption_channels * config.text_proj_in_factor)}
    for prefix in ("video_connector", "audio_connector"):
        shapes[f"{prefix}.learnable_registers"] = (config.num_registers, dim)
        table = []
        for i in range(config.num_layers):
            src = f"{prefix}.transformer_blocks.{i}"
            table += [(f"{src}.attn1.{name}", dim, dim) for name in ("to_q", "to_k", "to_v", "to_out.0")]
            table += [(f"{src}.ff.net.0.proj", 4 * dim, dim), (f"{src}.ff.net.2", dim, 4 * dim)]
            shapes.update({f"{src}.attn1.norm_q.weight": (dim,), f"{src}.attn1.norm_k.weight": (dim,)})
        _linears(shapes, table)
    return shapes


def vae_checkpoint_shapes(vae: nn.Module, legacy_attention: bool = False) -> Dict[str, tuple]:
    """Tensor names and torch shapes of a diffusers ``AutoencoderKL``
    checkpoint for the port's ``vae`` module, ``quant_conv`` and
    ``post_quant_conv`` included (FLUX.1-dev's published VAE has neither,
    and ``load_vae_params`` refuses it); ``legacy_attention`` names the mid
    attention as the old 1x1 convs (``q``/``k``/``v``/``proj_out``)."""
    attn = ({"norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v", "to_out": "proj_out"} if legacy_attention else
            {"norm": "group_norm", "to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out.0"})
    shapes: Dict[str, tuple] = {}
    for name, tensor in vae.state_dict().items():
        shape = tuple(tensor.shape)
        name = re.sub(r"^(encoder|decoder)\.(down|up)_(\d+)_block_(\d+)\.", r"\1.\2_blocks.\3.resnets.\4.", name)
        name = re.sub(r"^encoder\.down_(\d+)_downsample\.", r"encoder.down_blocks.\1.downsamplers.0.conv.", name)
        name = re.sub(r"^decoder\.up_(\d+)_upsample\.", r"decoder.up_blocks.\1.upsamplers.0.conv.", name)
        name = re.sub(r"\.mid_block_(\d)\.", lambda m: f".mid_block.resnets.{int(m.group(1)) - 1}.", name)
        name = name.replace(".norm_out.", ".conv_norm_out.")
        match = re.match(r"^(encoder|decoder)\.mid_attn\.(\w+)\.(weight|bias)$", name)
        if match:
            part, leaf = match.group(2), match.group(3)
            if legacy_attention and part != "norm" and leaf == "weight":
                shape = shape + (1, 1)
            name = f"{match.group(1)}.mid_block.attentions.0.{attn[part]}.{leaf}"
        shapes[name] = shape
    return shapes


def acestep_checkpoint_shapes(arch) -> Dict[str, tuple]:
    """Tensor names and torch shapes of an ``ACEStepTransformer2DModel`` of
    ``arch`` (``models/ace_step/transformer.py::ACEStepConfig``) as
    ``acestep_params_from_diffusers`` reads it: the patch embed's (H_mel, 1)
    conv, GroupNorm and 1 x 1 conv, the time MLP and ``t_block``, the
    conditioning embedders, the conformer lyric encoder (the lyric table, the
    linear embed and its LayerNorm, per layer the norms, the biased q / k / v /
    out, the bias-free ``linear_pos``, ``pos_bias_u`` / ``pos_bias_v`` and the
    FFN; the after-norm) and ``lyric_proj``, per block the (6, dim) table, the
    biased Lite-LA and cross-attention projections and GLUMBConv's 1-D convs,
    the SSL projector heads and the final layer."""
    dim, channels = arch.inner_dim, arch.in_channels
    patch, hidden, d = channels * arch.patch_mult, int(arch.inner_dim * arch.mlp_ratio), arch.lyric_hidden
    shapes: Dict[str, tuple] = {
        "proj_in.early_conv_layers.0.weight": (patch, channels, arch.latent_height, 1),
        "proj_in.early_conv_layers.0.bias": (patch,),
        "proj_in.early_conv_layers.1.weight": (patch,), "proj_in.early_conv_layers.1.bias": (patch,),
        "proj_in.early_conv_layers.2.weight": (dim, patch, 1, 1), "proj_in.early_conv_layers.2.bias": (dim,),
        "final_layer.scale_shift_table": (2, dim), "lyric_embs.weight": (arch.lyric_vocab, d),
    }
    _linears(shapes, (("timestep_embedder.linear_1", dim, 256), ("timestep_embedder.linear_2", dim, dim),
                      ("t_block.1", 6 * dim, dim), ("speaker_embedder", dim, arch.speaker_dim),
                      ("genre_embedder", dim, arch.text_dim), ("lyric_proj", dim, d),
                      ("lyric_encoder.embed.out.0", d, d), ("final_layer.linear", arch.latent_height * channels, dim)))
    for norm in ("lyric_encoder.embed.out.1", "lyric_encoder.after_norm"):
        shapes.update({f"{norm}.weight": (d,), f"{norm}.bias": (d,)})
    for i in range(arch.lyric_depth):
        src = f"lyric_encoder.encoders.{i}"
        _linears(shapes, [(f"{src}.self_attn.{name}", d, d) for name in ("linear_q", "linear_k", "linear_v",
                                                                          "linear_out")] +
                 [(f"{src}.feed_forward.w_1", arch.lyric_ffn, d), (f"{src}.feed_forward.w_2", d, arch.lyric_ffn)])
        shapes[f"{src}.self_attn.linear_pos.weight"] = (d, d)
        for bias in ("pos_bias_u", "pos_bias_v"):
            shapes[f"{src}.self_attn.{bias}"] = (arch.lyric_heads, d // arch.lyric_heads)
        for norm in ("norm_mha", "norm_ff"):
            shapes.update({f"{src}.{norm}.weight": (d,), f"{src}.{norm}.bias": (d,)})
    for i in range(arch.num_layers):
        src = f"transformer_blocks.{i}"
        shapes[f"{src}.scale_shift_table"] = (6, dim)
        _linears(shapes, [(f"{src}.{attn}.{name}", dim, dim) for attn in ("attn", "cross_attn")
                          for name in ("to_q", "to_k", "to_v", "to_out.0")])
        shapes.update({f"{src}.ff.inverted_conv.conv.weight": (2 * hidden, dim, 1),
                       f"{src}.ff.inverted_conv.conv.bias": (2 * hidden,),
                       f"{src}.ff.depth_conv.conv.weight": (2 * hidden, 1, 3),
                       f"{src}.ff.depth_conv.conv.bias": (2 * hidden,),
                       f"{src}.ff.point_conv.conv.weight": (dim, hidden, 1)})
    for head, ssl_dim in enumerate(arch.ssl_dims):
        _linears(shapes, ((f"projectors.{head}.0", 2 * dim, dim), (f"projectors.{head}.2", 2 * dim, 2 * dim),
                          (f"projectors.{head}.4", ssl_dim, 2 * dim)))
    return shapes
