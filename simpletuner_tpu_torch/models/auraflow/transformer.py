"""AuraFlow DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/auraflow/transformer.py`` (diffusers'
``AuraFlowTransformer2DModel``): (c, pi, pj)-ordered patch features through a
linear, the learned 4096 x dim position table read at a centred crop of its
64 x 64 grid (flat indices ``row * 64 + col``, so a bucket wider or taller
than 64 patches wraps across the grid's rows, as diffusers'
``pe_selection_index_based_on_dim`` does), 8 learned register tokens placed
before the projected caption, joint MMDiT blocks (context first in the
concatenated sequence) and then single-stream blocks over the fused
sequence, and a final modulation, scale first and then shift.  Submodules
keep the JAX names (``double_{i}.attn_q``, ``single_{i}.ff.linear_1``,
``time_in.in_layer``), so the bridge maps a Flax tree by name.

Mirrored as the JAX module computes them: every linear but ``patch_in`` and
``time_in`` is bias-free; the LayerNorms (``fp32_ln``) have no affine, eps
1e-5, statistics in f32 and output in the input's dtype, and the per-head q
and k norms are the same; the adaLN-Zero modulations come from
``silu(vec)`` taken in f32 and cast to the compute dtype; the SwiGLU
feed-forward is ``out_projection(silu(linear_1(x)) * linear_2(x))`` with
``find_multiple(int(2 * 4 * dim / 3), 256)`` hidden units (8192 at dim
3072); and attention reaches the residual stream only through the
feed-forward branch: ``x + gate_mlp * ff(norm(x + gate_msa * attn))``.
Attention runs unmasked through ``ops.dot_product_attention`` (the Hopper
flash kernels on the card: 12 heads of 256 at AuraFlow's width).  Remat
(``gradient_checkpointing``) checkpoints every block whole, as ``nn.remat``
wraps ``AuraJointBlock`` and ``AuraSingleBlock``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import dot_product_attention
from ..layers import LoRADense, MLPEmbedder, layer_norm, timestep_embedding


def find_multiple(n: int, k: int) -> int:
    return n if n % k == 0 else n + k - (n % k)


@dataclasses.dataclass(frozen=True)
class AuraFlowConfig:
    in_channels: int = 4
    patch_size: int = 2
    hidden_size: int = 3072
    depth_double: int = 4
    depth_single: int = 32
    num_heads: int = 12
    text_dim: int = 2048
    mlp_ratio: float = 4.0
    pos_embed_max_size: int = 4096  # 64x64 grid = 1024px latents
    num_register_tokens: int = 8

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_hidden(self) -> int:
        return find_multiple(int(2 * (self.hidden_size * self.mlp_ratio) / 3), 256)

    @classmethod
    def tiny(cls) -> "AuraFlowConfig":
        return cls(hidden_size=64, depth_double=1, depth_single=2, num_heads=2, text_dim=32, pos_embed_max_size=64)


def fp32_ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm without affine over the last axis, in f32, back in x's dtype."""
    return layer_norm(x, x.dtype, eps=eps)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return fp32_ln(x) * (1 + scale[:, None]) + shift[:, None]


class AuraFF(nn.Module):
    """SwiGLU: ``out_projection(silu(linear_1(x)) * linear_2(x))``, bias-free."""

    def __init__(self, dim: int, hidden: int, **lora) -> None:
        super().__init__()
        self.linear_1 = LoRADense(dim, hidden, use_bias=False, **lora)
        self.linear_2 = LoRADense(dim, hidden, use_bias=False, **lora)
        self.out_projection = LoRADense(hidden, dim, use_bias=False, **lora)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_projection(F.silu(self.linear_1(x)) * self.linear_2(x))


def _adaln_zero(dim: int, dtype: torch.dtype) -> LoRADense:
    """``norm1.linear``: silu(vec) -> 6 modulations, zero-initialised, no adapter."""
    return LoRADense(dim, 6 * dim, use_bias=False, dtype=dtype, zero_init=True)


def _mods(lin: LoRADense, vec: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    return lin(F.silu(vec.to(torch.float32)).to(dtype)).chunk(6, dim=-1)


class AuraJointBlock(nn.Module):
    def __init__(self, config: AuraFlowConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim = config.hidden_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.norm1_lin = _adaln_zero(dim, dtype)
        self.norm1_context_lin = _adaln_zero(dim, dtype)
        for name in ("attn_q", "attn_k", "attn_v", "attn_add_q", "attn_add_k", "attn_add_v", "attn_proj",
                     "attn_add_proj"):
            self.add_module(name, LoRADense(dim, dim, use_bias=False, **lora))
        self.ff = AuraFF(dim, config.ffn_hidden, **lora)
        self.ff_context = AuraFF(dim, config.ffn_hidden, **lora)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor, vec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        batch, ctx_len = x.shape[0], ctx.shape[1]
        sh, sc, g_msa, sh_mlp, sc_mlp, g_mlp = _mods(self.norm1_lin, vec, self.dtype)
        c_sh, c_sc, c_g_msa, c_sh_mlp, c_sc_mlp, c_g_mlp = _mods(self.norm1_context_lin, vec, self.dtype)
        x_n = _modulate(x, sh, sc)
        c_n = _modulate(ctx, c_sh, c_sc)

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(batch, t.shape[1], cfg.num_heads, cfg.head_dim)

        # context-first concat (diffusers AuraFlowAttnProcessor2_0)
        q = torch.cat([heads(self.attn_add_q(c_n)), heads(self.attn_q(x_n))], dim=1)
        k = torch.cat([heads(self.attn_add_k(c_n)), heads(self.attn_k(x_n))], dim=1)
        v = torch.cat([heads(self.attn_add_v(c_n)), heads(self.attn_v(x_n))], dim=1)
        attn = dot_product_attention(fp32_ln(q), fp32_ln(k), v).reshape(batch, -1, cfg.hidden_size)
        attn_c = self.attn_add_proj(attn[:, :ctx_len])
        attn_i = self.attn_proj(attn[:, ctx_len:])
        # AuraFlow residual: attention enters only through the FF branch
        x = x + g_mlp[:, None] * self.ff(_modulate(x + g_msa[:, None] * attn_i, sh_mlp, sc_mlp))
        ctx = ctx + c_g_mlp[:, None] * self.ff_context(_modulate(ctx + c_g_msa[:, None] * attn_c, c_sh_mlp, c_sc_mlp))
        return x, ctx


class AuraSingleBlock(nn.Module):
    def __init__(self, config: AuraFlowConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim = config.hidden_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.norm1_lin = _adaln_zero(dim, dtype)
        for name in ("attn_q", "attn_k", "attn_v", "attn_proj"):
            self.add_module(name, LoRADense(dim, dim, use_bias=False, **lora))
        self.ff = AuraFF(dim, config.ffn_hidden, **lora)

    def forward(self, stream: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        batch, seq = stream.shape[:2]
        sh, sc, g_msa, sh_mlp, sc_mlp, g_mlp = _mods(self.norm1_lin, vec, self.dtype)
        s_n = _modulate(stream, sh, sc)
        shape = (batch, seq, cfg.num_heads, cfg.head_dim)
        q = fp32_ln(self.attn_q(s_n).reshape(shape))
        k = fp32_ln(self.attn_k(s_n).reshape(shape))
        attn = dot_product_attention(q, k, self.attn_v(s_n).reshape(shape)).reshape(batch, seq, cfg.hidden_size)
        attn = self.attn_proj(attn)
        return stream + g_mlp[:, None] * self.ff(_modulate(stream + g_msa[:, None] * attn, sh_mlp, sc_mlp))


class AuraFlowTransformer(nn.Module):
    """The AuraFlow DiT.  ``latents`` (B, H, W, C) noisy latents,
    ``timesteps`` (B,) sigmas in [0, 1], ``context`` (B, L, text_dim) T5
    features; returns the (B, H, W, C) flow prediction in f32."""

    def __init__(self, config: AuraFlowConfig = AuraFlowConfig(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim, p = config.hidden_size, config.patch_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.patch_in = LoRADense(config.in_channels * p * p, dim, **lora)
        self.pos_embed = nn.Parameter(torch.empty(config.pos_embed_max_size, dim, dtype=torch.float32))
        self.context_in = LoRADense(config.text_dim, dim, use_bias=False, **lora)
        self.register_tokens = nn.Parameter(torch.empty(config.num_register_tokens, dim, dtype=torch.float32))
        self.time_in = MLPEmbedder(256, dim, dtype=dtype)
        for layer in range(config.depth_double):
            self.add_module(f"double_{layer}", AuraJointBlock(config, **lora))
        for layer in range(config.depth_single):
            self.add_module(f"single_{layer}", AuraSingleBlock(config, **lora))
        self.final_mod = LoRADense(dim, 2 * dim, use_bias=False, dtype=dtype)
        self.final_proj = LoRADense(dim, p * p * config.in_channels, use_bias=False, dtype=dtype)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.pos_embed.normal_(0.0, 0.1, generator=generator)
        self.register_tokens.normal_(0.0, 0.02, generator=generator)

    def position_embedding(self, hh: int, ww: int) -> torch.Tensor:
        """The (hh * ww, dim) rows of the position table at the centred crop
        (flat indices made on the device, so a captured step makes them too)."""
        grid = int(self.config.pos_embed_max_size ** 0.5)
        device = self.pos_embed.device
        rows = torch.arange(grid // 2 - hh // 2, grid // 2 - hh // 2 + hh, device=device)
        cols = torch.arange(grid // 2 - ww // 2, grid // 2 - ww // 2 + ww, device=device)
        return self.pos_embed[(rows[:, None] * grid + cols[None, :]).reshape(-1)]

    def _run(self, block: nn.Module, *args):
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        p = cfg.patch_size
        batch, height, width, channels = latents.shape
        hh, ww = height // p, width // p
        # patchify with (c, pi, pj) feature order (reference AuraFlowPatchEmbed)
        x = latents.reshape(batch, hh, p, ww, p, channels).permute(0, 1, 3, 5, 2, 4)
        x = self.patch_in(x.reshape(batch, hh * ww, channels * p * p))
        x = x + self.position_embedding(hh, ww).to(dtype)[None]
        ctx = self.context_in(context)
        registers = self.register_tokens.to(dtype)[None].expand(batch, -1, -1)
        ctx = torch.cat([registers, ctx], dim=1)
        vec = self.time_in(timestep_embedding(timesteps, 256).to(dtype))
        for layer in range(cfg.depth_double):
            x, ctx = self._run(getattr(self, f"double_{layer}"), x, ctx, vec)
        ctx_len = ctx.shape[1]
        stream = torch.cat([ctx, x], dim=1)
        for layer in range(cfg.depth_single):
            stream = self._run(getattr(self, f"single_{layer}"), stream, vec)
        x = stream[:, ctx_len:]
        # AuraFlowPreFinalBlock: SCALE first, then shift
        scale, shift = self.final_mod(F.silu(vec.to(torch.float32)).to(dtype)).chunk(2, dim=-1)
        x = self.final_proj(x * (1 + scale[:, None]) + shift[:, None])
        x = x.reshape(batch, hh, ww, p, p, channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(batch, height, width, channels).to(torch.float32)
