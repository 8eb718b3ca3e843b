"""Sana DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/sana/transformer.py`` (the vendored
``SanaTransformer2DModel``): the patch dense ``patch_in`` with no position
embedding (the Mix-FFN's depthwise 3 x 3 conv carries all the spatial
information), the tanh-gelu caption MLP with its RMSNorm (eps 1e-5),
``MLPEmbedder`` over the cos-first 256 sinusoid of sigma x 1000 and
``time_proj`` to 6 x dim; blocks of ReLU linear self-attention (70 heads of
32), softmax cross-attention (20 heads of 112) behind a LayerNorm without
affine, and the GLUMBConv Mix-FFN (1 x 1 expand to 2 x 5600, silu, depthwise
3 x 3 "SAME", the GLU split with the value first and the gate second, a
bias-free 1 x 1), each modulated by the block's ``scale_shift_table`` (6,
dim) plus ``t6`` in f32, cast to the compute dtype; then the final (2, dim)
table plus the timestep vector and ``final_proj``.

The linear attention is three f32 products (``relu_linear_attention``, as
the JAX einsums: no S x S matrix and no kernel); the convolutions are
``torch.nn.functional`` ops (the 1 x 1s as dense products over the
channels-last features, the depthwise one as a grouped ``conv2d``), as
``nn.Conv`` is XLA in JAX.  The cross-attention goes through
:func:`dot_product_attention` with no mask, as in JAX (the Hopper flash
kernels on the card, the head dim 112 zero-padded to 128 in the wrapper,
scale 112^-1/2): Gemma's pad keys are attended, because the family's collate
drops the mask (ROADMAP Queue 3).  Submodules keep the JAX names
(``block_{i}.attn1_q``, ``block_{i}.ff.conv_depth``); remat checkpoints every
block whole, as ``nn.remat`` wraps ``SanaBlock``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import dot_product_attention
from ..layers import LoRADense, MLPEmbedder, RMSNorm, layer_norm, timestep_embedding


def relu_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """(B, S, H, D) linear attention with ReLU feature maps in f32 (diffusers
    ``SanaLinearAttnProcessor2_0``): ``kv = K^T V`` and ``k_sum`` per head, the
    output over ``q . k_sum + eps``."""
    q = F.relu(q.to(torch.float32))
    k = F.relu(k.to(torch.float32))
    v = v.to(torch.float32)
    kv = torch.einsum("bshd,bshe->bhde", k, v)
    normalizer = torch.einsum("bshd,bhd->bsh", q, k.sum(dim=1)) + eps
    return torch.einsum("bshd,bhde->bshe", q, kv) / normalizer[..., None]


@dataclasses.dataclass(frozen=True)
class SanaConfig:
    in_channels: int = 32  # DC-AE latents
    patch_size: int = 1
    hidden_size: int = 2240
    depth: int = 20
    self_heads: int = 70
    self_head_dim: int = 32
    cross_heads: int = 20
    cross_head_dim: int = 112
    text_dim: int = 2304  # gemma-2
    ffn_ratio: float = 2.5

    @property
    def num_heads(self) -> int:
        return self.cross_heads

    @property
    def head_dim(self) -> int:
        return self.cross_head_dim

    @classmethod
    def tiny(cls) -> "SanaConfig":
        return cls(
            in_channels=4, hidden_size=64, depth=2, self_heads=4, self_head_dim=16,
            cross_heads=2, cross_head_dim=32, text_dim=32,
        )


def pointwise(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1 x 1 ``conv`` over channels-last ``x`` (..., C_in) as a dense product."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


def depthwise(conv: nn.Conv2d, x: torch.Tensor, padding) -> torch.Tensor:
    """A grouped (depthwise) ``conv`` over channels-last ``x`` (N, H, W, C)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, padding=padding, groups=conv.groups)
    return out.permute(0, 2, 3, 1)


class GLUMBConv(nn.Module):
    """Mix-FFN over (B, H, W, dim): 1 x 1 expand -> silu -> depthwise 3 x 3
    -> GLU (value first, gate second) -> bias-free 1 x 1."""

    def __init__(self, dim: int, ratio: float, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        hidden = int(dim * ratio)
        self.conv_inverted = nn.Conv2d(dim, 2 * hidden, 1, dtype=dtype)
        self.conv_depth = nn.Conv2d(2 * hidden, 2 * hidden, 3, groups=2 * hidden, dtype=dtype)
        self.conv_point = nn.Conv2d(hidden, dim, 1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = depthwise(self.conv_depth, F.silu(pointwise(self.conv_inverted, x)), padding=1)
        value, gate = h.chunk(2, dim=-1)
        return pointwise(self.conv_point, value * F.silu(gate))


class SanaBlock(nn.Module):
    """One block: ``x`` (B, S, dim) over the (H', W') grid ``hw``,
    ``context`` (B, L, dim) projected text, ``t6`` (B, 6, dim)."""

    def __init__(self, config: SanaConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim = config.hidden_size
        inner_self, inner_cross = config.self_heads * config.self_head_dim, config.cross_heads * config.cross_head_dim
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.scale_shift_table = nn.Parameter(torch.empty(6, dim, dtype=torch.float32))
        for name in ("q", "k", "v"):
            self.add_module(f"attn1_{name}", LoRADense(dim, inner_self, **lora))
        self.attn1_proj = LoRADense(inner_self, dim, **lora)
        self.attn2_q = LoRADense(dim, inner_cross, **lora)
        self.attn2_k = LoRADense(dim, inner_cross, **lora)
        self.attn2_v = LoRADense(dim, inner_cross, **lora)
        self.attn2_proj = LoRADense(inner_cross, dim, **lora)
        self.ff = GLUMBConv(dim, config.ffn_ratio, dtype)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale_shift_table.normal_(0.0, 1.0 / math.sqrt(self.config.hidden_size), generator=generator)

    def forward(self, x: torch.Tensor, context: torch.Tensor, t6: torch.Tensor,
                hw: Tuple[int, int]) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        batch, seq = x.shape[:2]
        mods = (self.scale_shift_table[None] + t6.to(torch.float32)).to(dtype)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (m[:, None] for m in mods.unbind(dim=1))

        # ReLU linear self-attention (no position)
        x_n = layer_norm(x, dtype) * (1 + scale_msa) + shift_msa
        heads = (batch, seq, cfg.self_heads, cfg.self_head_dim)
        attn = relu_linear_attention(self.attn1_q(x_n).reshape(heads), self.attn1_k(x_n).reshape(heads),
                                     self.attn1_v(x_n).reshape(heads))
        x = x + gate_msa * self.attn1_proj(attn.reshape(batch, seq, -1).to(dtype))

        # softmax cross-attention, unmasked
        x_c = layer_norm(x, dtype)
        shape_kv = (batch, context.shape[1], cfg.cross_heads, cfg.cross_head_dim)
        q = self.attn2_q(x_c).reshape(batch, seq, cfg.cross_heads, cfg.cross_head_dim)
        attn = dot_product_attention(q, self.attn2_k(context).reshape(shape_kv),
                                     self.attn2_v(context).reshape(shape_kv))
        x = x + self.attn2_proj(attn.reshape(batch, seq, -1))

        # GLUMBConv Mix-FFN on the (H', W') grid
        x_f = layer_norm(x, dtype) * (1 + scale_mlp) + shift_mlp
        return x + gate_mlp * self.ff(x_f.reshape(batch, *hw, -1)).reshape(batch, seq, -1)


class SanaTransformer(nn.Module):
    """The Sana DiT.  ``latents`` (B, H, W, C), ``timesteps`` (B,) sigmas in
    [0, 1] (the x 1000 is inside the sinusoid), ``context`` (B, L, text_dim)
    Gemma-2 features; returns (B, H, W, C) f32."""

    def __init__(self, config: SanaConfig = SanaConfig(), dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora", remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim, p = config.hidden_size, config.patch_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.patch_in = LoRADense(p * p * config.in_channels, dim, **lora)
        self.caption_in_1 = LoRADense(config.text_dim, dim, **lora)
        self.caption_in_2 = LoRADense(dim, dim, **lora)
        self.caption_norm = RMSNorm(dim, eps=1e-5, dtype=dtype)
        self.time_in = MLPEmbedder(256, dim, dtype=dtype)
        self.time_proj = LoRADense(dim, 6 * dim, dtype=dtype)
        for layer in range(config.depth):
            self.add_module(f"block_{layer}", SanaBlock(config, dtype, lora_rank, lora_alpha, lora_algo))
        self.final_scale_shift_table = nn.Parameter(torch.empty(2, dim, dtype=torch.float32))
        self.final_proj = LoRADense(dim, p * p * config.in_channels, dtype=dtype)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.final_scale_shift_table.normal_(0.0, 1.0 / math.sqrt(self.config.hidden_size), generator=generator)

    def _run(self, name: str, *args):
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        p = cfg.patch_size
        batch, height, width, channels = latents.shape
        hh, ww = height // p, width // p

        x = latents.reshape(batch, hh, p, ww, p, channels).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_in(x.reshape(batch, hh * ww, p * p * channels))
        txt = self.caption_norm(self.caption_in_2(F.gelu(self.caption_in_1(context), approximate="tanh")))
        t_emb = self.time_in(timestep_embedding(timesteps, 256).to(dtype))
        t6 = self.time_proj(F.silu(t_emb)).reshape(batch, 6, -1)

        for layer in range(cfg.depth):
            x = self._run(f"block_{layer}", x, txt, t6, (hh, ww))

        final = self.final_scale_shift_table[None] + t_emb[:, None].to(torch.float32)
        shift, scale = final[:, 0][:, None].to(dtype), final[:, 1][:, None].to(dtype)
        x = self.final_proj(layer_norm(x, dtype) * (1 + scale) + shift)
        x = x.reshape(batch, hh, ww, p, p, channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(batch, height, width, channels).to(torch.float32)
