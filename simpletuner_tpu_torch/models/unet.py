"""Conditional 2-D UNet (the SDXL arch; SD 1.x / 2.x / Kolors share it).

Counterpart of ``simpletuner_tpu/models/unet.py``: ``UNetConfig`` with its
presets, ``ResnetBlock``, ``CrossAttention``, ``TransformerBlock`` (GEGLU
feed-forward), ``SpatialTransformer``, ``Downsample``, ``Upsample``,
``UNet2DCondition`` and ``make_sdxl_added_cond``.  Submodule names follow the
Flax modules (``down_{level}_res_{j}``, ``GroupNorm_0``, ``blocks_{i}``,
``attn1/to_q``, ...), so a Flax tree maps onto the ``state_dict`` by name
(``models/weight_bridge.py``).  The public interface keeps the JAX NHWC
layout; inside, activations are NCHW tensors in ``channels_last`` memory,
which is the same bytes, so the convolutions (XLA convs in the JAX package,
``F.conv2d`` here) and the per-token projections read them without copies.

Mirrored exactly as the JAX module computes them:

* GroupNorm statistics and affine in f32; ``ResnetBlock`` and
  ``conv_norm_out`` use eps 1e-5, ``SpatialTransformer``'s GroupNorm Flax's
  default 1e-6;
* LayerNorms (eps 1e-5) with f32 scale and bias, output in the compute dtype;
* GEGLU is ``a * gelu_tanh(b)`` with the first half of ``ff_proj`` as the
  hidden (not diffusers' exact gelu on the second half's gate);
* nearest x2 upsampling; attention in every level that
  ``cross_attention_blocks`` marks (the JAX sdxl preset marks all three);
* the added conditioning is pooled text first, then fourier(time ids).

Attention runs through ``ops.dot_product_attention`` (the Hopper flash kernel
on the card): self-attention over the H x W tokens and cross-attention
against the text context.  ``remat`` checkpoints every ``ResnetBlock`` and
``SpatialTransformer`` (non-reentrant, no RNG state), as the JAX module wraps
both in ``nn.remat``.  Refused by name: GLIGEN grounding tokens (ROADMAP
Queue 1 item 7), ControlNet residuals (item 7), ``class_embed_timestep``
(deepfloyd, item 6) and the mid-block ``intermediates`` tap (item 4h).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import dot_product_attention
from .layers import LoRADense, timestep_embedding


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # transformer depth per cross-attn block (SDXL uses (1, 2, 10))
    transformer_layers: Tuple[int, ...] = (1, 1, 1)
    # which down blocks carry cross-attention (mirrored for up blocks)
    cross_attention_blocks: Tuple[bool, ...] = (True, True, True, False)
    cross_attention_dim: int = 768
    attention_head_dim: int = 64
    norm_groups: int = 32
    # SDXL micro-conditioning: 6 time ids x fourier 256 + pooled 1280
    addition_embed_dim: int = 0  # 0 = disabled; SDXL: 2816
    addition_time_embed_dim: int = 256
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    # diffusers class_embed_type="timestep" (DeepFloyd IF-II); not ported
    class_embed_timestep: bool = False

    @classmethod
    def sd15(cls) -> "UNetConfig":
        return cls()

    @classmethod
    def sd21(cls) -> "UNetConfig":
        return cls(cross_attention_dim=1024)

    @classmethod
    def sdxl(cls) -> "UNetConfig":
        return cls(
            block_out_channels=(320, 640, 1280),
            transformer_layers=(1, 2, 10),
            cross_attention_blocks=(True, True, True),
            cross_attention_dim=2048,
            addition_embed_dim=6 * 256 + 1280,
        )

    @classmethod
    def tiny(cls) -> "UNetConfig":
        return cls(
            block_out_channels=(32, 64),
            layers_per_block=1,
            transformer_layers=(1, 1),
            cross_attention_blocks=(True, True),
            cross_attention_dim=32,
            attention_head_dim=16,
            norm_groups=8,
        )

    @classmethod
    def tiny_xl(cls) -> "UNetConfig":
        # dims match the tiny text encoders: CLIP-L 32 + CLIP-G 64 -> context 96
        return cls(
            block_out_channels=(32, 64),
            layers_per_block=1,
            transformer_layers=(1, 1),
            cross_attention_blocks=(True, True),
            cross_attention_dim=96,
            attention_head_dim=16,
            norm_groups=8,
            addition_embed_dim=6 * 8 + 64,
            addition_time_embed_dim=8,
        )

    def depth_at(self, level: int) -> int:
        return self.transformer_layers[min(level, len(self.transformer_layers) - 1)]


def _gn(groups: int, channels: int) -> int:
    return groups if channels % groups == 0 else 1


def _group_norm(groups: int, channels: int, eps: float) -> nn.GroupNorm:
    return nn.GroupNorm(_gn(groups, channels), channels, eps=eps, dtype=torch.float32)


def _norm_f32(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``GroupNorm(dtype=float32)`` on an f32 cast of ``x``: f32 out."""
    return F.group_norm(x.to(torch.float32), norm.num_groups, norm.weight, norm.bias, norm.eps)


def _conv(in_channels: int, out_channels: int, kernel: int, dtype: torch.dtype, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_channels, out_channels, kernel, stride=stride, padding=kernel // 2, dtype=dtype)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int, norm_groups: int = 32,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dtype = dtype
        self.GroupNorm_0 = _group_norm(norm_groups, in_channels, 1e-5)
        self.conv1 = _conv(in_channels, out_channels, 3, dtype)
        self.time_emb_proj = LoRADense(temb_dim, out_channels, dtype=dtype)
        self.GroupNorm_1 = _group_norm(norm_groups, out_channels, 1e-5)
        self.conv2 = _conv(out_channels, out_channels, 3, dtype)
        self.conv_shortcut = _conv(in_channels, out_channels, 1, dtype) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(_norm_f32(self.GroupNorm_0, x)).to(self.dtype))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(_norm_f32(self.GroupNorm_1, h)).to(self.dtype))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return residual + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0, lora_alpha: Optional[float] = None,
                 lora_algo: str = "lora") -> None:
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        inner = num_heads * head_dim
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.to_q = LoRADense(query_dim, inner, use_bias=False, **lora)
        self.to_k = LoRADense(context_dim, inner, use_bias=False, **lora)
        self.to_v = LoRADense(context_dim, inner, use_bias=False, **lora)
        self.to_out = LoRADense(inner, inner, **lora)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        batch, q_len = x.shape[0], x.shape[1]
        q = self.to_q(x).view(batch, q_len, self.num_heads, self.head_dim)
        k = self.to_k(context).view(batch, context.shape[1], self.num_heads, self.head_dim)
        v = self.to_v(context).view(batch, context.shape[1], self.num_heads, self.head_dim)
        out = dot_product_attention(q, k, v)
        return self.to_out(out.reshape(batch, q_len, self.num_heads * self.head_dim))


class TransformerBlock(nn.Module):
    """Self-attention, cross-attention and the GEGLU feed-forward, each pre-LayerNorm."""

    def __init__(self, dim: int, context_dim: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0, lora_alpha: Optional[float] = None,
                 lora_algo: str = "lora") -> None:
        super().__init__()
        self.dtype = dtype
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, dtype=torch.float32)
        self.attn1 = CrossAttention(dim, dim, num_heads, head_dim, **lora)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, dtype=torch.float32)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim, **lora)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5, dtype=torch.float32)
        # GEGLU (diffusers ff.net.0.proj / ff.net.2)
        self.ff_proj = LoRADense(dim, dim * 8, **lora)
        self.ff_out = LoRADense(dim * 4, dim, **lora)

    def _ln(self, norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(torch.float32), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(self.dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self._ln(self.norm1, x))
        x = x + self.attn2(self._ln(self.norm2, x), context)
        a, b = self.ff_proj(self._ln(self.norm3, x)).chunk(2, dim=-1)
        return x + self.ff_out(a * F.gelu(b, approximate="tanh"))


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, context_dim: int, depth: int, num_heads: int, head_dim: int,
                 norm_groups: int = 32, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.dtype = dtype
        # no epsilon given in the JAX module: flax's default 1e-6
        self.GroupNorm_0 = _group_norm(norm_groups, channels, 1e-6)
        self.proj_in = LoRADense(channels, channels, dtype=dtype)
        for i in range(depth):
            self.add_module(f"blocks_{i}", TransformerBlock(
                channels, context_dim, num_heads, head_dim, dtype=dtype, lora_rank=lora_rank,
                lora_alpha=lora_alpha, lora_algo=lora_algo))
        self.depth = depth
        self.proj_out = LoRADense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        batch, channels, height, width = x.shape
        h = _norm_f32(self.GroupNorm_0, x).to(self.dtype)
        h = self.proj_in(h.permute(0, 2, 3, 1).reshape(batch, height * width, channels))
        for i in range(self.depth):
            h = getattr(self, f"blocks_{i}")(h, context)
        h = self.proj_out(h).reshape(batch, height, width, channels).permute(0, 3, 1, 2)
        return x + h


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.conv = _conv(channels, channels, 3, dtype, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.conv = _conv(channels, channels, 3, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UNet2DCondition(nn.Module):
    """The UNet over (B, H, W, C) latents; returns the f32 prediction in that layout."""

    def __init__(self, config: UNetConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora", remat: bool = False) -> None:
        super().__init__()
        if config.class_embed_timestep:
            raise NotImplementedError("class_embed_timestep (deepfloyd's class-label embedding) is not ported "
                                      "(ROADMAP Queue 1 item 6)")
        self.config, self.dtype, self.remat = config, dtype, remat
        cfg = config
        c0 = cfg.block_out_channels[0]
        time_dim = c0 * 4
        self.time_embed_0 = LoRADense(c0, time_dim, dtype=dtype)
        self.time_embed_2 = LoRADense(time_dim, time_dim, dtype=dtype)
        if cfg.addition_embed_dim:
            self.add_embed_0 = LoRADense(cfg.addition_embed_dim, time_dim, dtype=dtype)
            self.add_embed_2 = LoRADense(time_dim, time_dim, dtype=dtype)
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)

        def spatial(channels: int, level: int) -> SpatialTransformer:
            return SpatialTransformer(channels, cfg.cross_attention_dim, cfg.depth_at(level),
                                      channels // cfg.attention_head_dim, cfg.attention_head_dim,
                                      cfg.norm_groups, **lora)

        self.conv_in = _conv(cfg.in_channels, c0, 3, dtype)
        # the skip stack's channel counts, to size the up path's resnets
        skips = [c0]
        channels = c0
        levels = len(cfg.block_out_channels)
        for level, out_ch in enumerate(cfg.block_out_channels):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{level}_res_{j}",
                                ResnetBlock(channels, out_ch, time_dim, cfg.norm_groups, dtype))
                channels = out_ch
                if cfg.cross_attention_blocks[level]:
                    self.add_module(f"down_{level}_attn_{j}", spatial(out_ch, level))
                skips.append(channels)
            if level < levels - 1:
                self.add_module(f"down_{level}_downsample", Downsample(out_ch, dtype))
                skips.append(channels)
        mid_ch = cfg.block_out_channels[-1]
        self.mid_res_0 = ResnetBlock(channels, mid_ch, time_dim, cfg.norm_groups, dtype)
        self.mid_attn = spatial(mid_ch, levels - 1)
        self.mid_res_1 = ResnetBlock(mid_ch, mid_ch, time_dim, cfg.norm_groups, dtype)
        channels = mid_ch
        for level, out_ch in reversed(list(enumerate(cfg.block_out_channels))):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{level}_res_{j}",
                                ResnetBlock(channels + skips.pop(), out_ch, time_dim, cfg.norm_groups, dtype))
                channels = out_ch
                if cfg.cross_attention_blocks[level]:
                    self.add_module(f"up_{level}_attn_{j}", spatial(out_ch, level))
            if level > 0:
                self.add_module(f"up_{level}_upsample", Upsample(out_ch, dtype))
        self.conv_norm_out = _group_norm(cfg.norm_groups, channels, 1e-5)
        self.conv_out = _conv(channels, cfg.out_channels, 3, dtype)
        self.to(memory_format=torch.channels_last)

    def _run(self, block: nn.Module, *args) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(
        self,
        sample: torch.Tensor,
        timesteps: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        added_cond: Optional[torch.Tensor] = None,
        controlnet_skip_residuals=None,
        controlnet_mid_residual=None,
        grounding_boxes=None,
        grounding_phrases=None,
        grounding_masks=None,
        class_labels=None,
        intermediates: bool = False,
    ) -> torch.Tensor:
        if controlnet_skip_residuals is not None or controlnet_mid_residual is not None:
            raise NotImplementedError("UNet ControlNet residuals are not ported (ROADMAP Queue 1 item 7)")
        if grounding_boxes is not None or grounding_phrases is not None or grounding_masks is not None:
            raise NotImplementedError("GLIGEN grounding (PositionNet) is not ported (ROADMAP Queue 1 item 7)")
        if class_labels is not None:
            raise NotImplementedError("class_labels (class_embed_timestep) are not ported (ROADMAP Queue 1 item 6)")
        if intermediates:
            raise NotImplementedError("the mid-block intermediates tap (U-REPA) is not ported (ROADMAP Queue 1 item 4h)")
        cfg, dtype = self.config, self.dtype
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0], time_factor=1.0)
        temb = self.time_embed_2(F.silu(self.time_embed_0(temb.to(dtype))))
        if cfg.addition_embed_dim:
            if added_cond is None:
                raise ValueError("SDXL-style config requires added_cond")
            temb = temb + self.add_embed_2(F.silu(self.add_embed_0(added_cond.to(dtype))))
        context = encoder_hidden_states.to(dtype)

        x = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))  # NHWC bytes as channels_last NCHW
        skips = [x]
        levels = len(cfg.block_out_channels)
        for level in range(levels):
            for j in range(cfg.layers_per_block):
                x = self._run(getattr(self, f"down_{level}_res_{j}"), x, temb)
                if cfg.cross_attention_blocks[level]:
                    x = self._run(getattr(self, f"down_{level}_attn_{j}"), x, context)
                skips.append(x)
            if level < levels - 1:
                x = getattr(self, f"down_{level}_downsample")(x)
                skips.append(x)
        x = self._run(self.mid_res_0, x, temb)
        x = self._run(self.mid_attn, x, context)
        x = self._run(self.mid_res_1, x, temb)
        for level in reversed(range(levels)):
            for j in range(cfg.layers_per_block + 1):
                x = torch.cat([x, skips.pop()], dim=1)
                x = self._run(getattr(self, f"up_{level}_res_{j}"), x, temb)
                if cfg.cross_attention_blocks[level]:
                    x = self._run(getattr(self, f"up_{level}_attn_{j}"), x, context)
            if level > 0:
                x = getattr(self, f"up_{level}_upsample")(x)
        x = F.silu(_norm_f32(self.conv_norm_out, x)).to(dtype)
        return self.conv_out(x).permute(0, 2, 3, 1).to(torch.float32)


def make_sdxl_added_cond(time_ids: torch.Tensor, pooled: torch.Tensor, fourier_dim: int = 256) -> torch.Tensor:
    """SDXL micro-conditioning: pooled text ++ fourier(time ids) flattened,
    in diffusers' ``get_aug_embed`` order (pooled first).  ``time_ids``
    (B, 6): original H/W, crop top/left, target H/W (the refiner: 5 ids
    ending in the aesthetic score)."""
    batch = time_ids.shape[0]
    emb = timestep_embedding(time_ids.reshape(-1), fourier_dim, time_factor=1.0).reshape(batch, -1)
    return torch.cat([pooled.to(emb.dtype), emb], dim=-1)
