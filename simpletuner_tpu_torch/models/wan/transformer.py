"""Wan video DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/wan/transformer.py`` (diffusers'
``WanTransformer3DModel``): the (1, 2, 2) patchify as one dense over the
(pt, ph, pw, C)-ordered patch features, the two-layer tanh-gelu text
projection (``text_in0``, ``text_in2``), the timestep MLP ``time_in`` and
the shared six-way modulation ``time_proj`` (``e6``), blocks of
self-attention over the video tokens with 3-D axial RoPE (axes (44, 42, 42)
over (t, h, w) at head dim 128), ungated cross-attention to the text behind
an affine LayerNorm, and a tanh-gelu feed-forward of ``ffn_ratio`` x dim,
each modulated by the block's ``scale_shift_table`` (6, dim) plus ``e6``;
then the final (2, dim) table plus the timestep vector, a linear, and the
unpatchify.  Submodules keep the JAX names (``block_{i}.self_attn_q``,
``block_{i}.cross_norm.LayerNorm_0``), so the bridge maps a Flax tree by name.

Mirrored as the JAX module computes them: the q and k RMSNorms run across
the heads (over the whole inner dim, eps 1e-6, in f32); the modulations are
the table plus ``e6`` in f32, cast to the compute dtype; the LayerNorms have
eps 1e-6 and compute in f32 (the unnamed ones without affine); the RoPE
ids are made on the device, so a captured step makes them too.  Both
attentions run unmasked through ``ops.dot_product_attention`` (on the card
the Hopper flash kernels at head dim 128: self-attention over every video
token, cross-attention against every text token, pads included).  Remat
(``gradient_checkpointing``) checkpoints every block whole, as ``nn.remat``
wraps ``WanBlock``.
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
from ...ops.rope import apply_rope, axial_rope
from ..layers import LoRADense, MLPEmbedder, RMSNorm, layer_norm, modulate, timestep_embedding


@dataclasses.dataclass(frozen=True)
class WanConfig:
    in_channels: int = 16
    out_channels: int = 0  # 0 = same as in_channels (I2V uses fewer out than in)
    patch: Tuple[int, int, int] = (1, 2, 2)  # (t, h, w)
    hidden_size: int = 1536
    depth: int = 30
    num_heads: int = 12
    head_dim: int = 128
    ffn_ratio: float = 4.0
    text_dim: int = 4096  # umT5-xxl features
    axes_dim: Tuple[int, ...] = (44, 42, 42)  # rope split over (t, h, w); sums to head_dim
    qk_norm: bool = True

    @property
    def ffn_hidden(self) -> int:
        return int(self.hidden_size * self.ffn_ratio)

    @classmethod
    def b1_3(cls) -> "WanConfig":
        return cls()

    @classmethod
    def b14(cls) -> "WanConfig":
        return cls(hidden_size=5120, depth=40, num_heads=40)

    @classmethod
    def tiny(cls) -> "WanConfig":
        return cls(in_channels=4, hidden_size=64, depth=2, num_heads=2, head_dim=32,
                   text_dim=32, axes_dim=(12, 10, 10))


class AffineLayerNorm(nn.Module):
    """The JAX ``LayerNorm`` wrapper with scale and bias: its ``nn.LayerNorm``
    child (``LayerNorm_0``) holds them in f32; f32 statistics, eps 1e-6
    unless given, output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6) -> None:
        super().__init__()
        self.dtype = dtype
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=eps, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm_0(x.to(torch.float32)).to(self.dtype)


class WanBlock(nn.Module):
    """diffusers ``WanTransformerBlock``: ``x`` (B, S, dim), ``context`` (B,
    L, dim) projected text, ``e6`` (B, 6, dim) and the RoPE (cos, sin)."""

    def __init__(self, config: WanConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, inner = config.hidden_size, config.num_heads * config.head_dim
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.scale_shift_table = nn.Parameter(torch.empty(6, dim, dtype=torch.float32))
        for prefix in ("self_attn", "cross_attn"):
            for name in ("q", "k", "v"):
                self.add_module(f"{prefix}_{name}", LoRADense(dim, inner, **lora))
            self.add_module(f"{prefix}_proj", LoRADense(inner, dim, **lora))
            if config.qk_norm:
                self.add_module(f"{prefix}_norm_q", RMSNorm(inner, dtype=dtype))
                self.add_module(f"{prefix}_norm_k", RMSNorm(inner, dtype=dtype))
        self.cross_norm = AffineLayerNorm(dim, dtype)
        self.ffn_in = LoRADense(dim, config.ffn_hidden, **lora)
        self.ffn_out = LoRADense(config.ffn_hidden, dim, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale_shift_table.normal_(0.0, 1.0 / math.sqrt(self.config.hidden_size), generator=generator)

    def _qk(self, prefix: str, name: str, x: torch.Tensor) -> torch.Tensor:
        value = getattr(self, f"{prefix}_{name}")(x)
        return getattr(self, f"{prefix}_norm_{name}")(value) if self.config.qk_norm else value

    def forward(self, x: torch.Tensor, context: torch.Tensor, e6: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        batch, seq = x.shape[:2]
        heads = (batch, seq, cfg.num_heads, cfg.head_dim)
        mods = (self.scale_shift_table[None] + e6.to(torch.float32)).to(dtype).unbind(dim=1)

        # self-attention over the video tokens (3-D rope)
        x_n = modulate(layer_norm(x, dtype), mods[0], mods[1])
        q = apply_rope(self._qk("self_attn", "q", x_n).reshape(heads), cos, sin)
        k = apply_rope(self._qk("self_attn", "k", x_n).reshape(heads), cos, sin)
        v = self.self_attn_v(x_n).reshape(heads)
        attn = dot_product_attention(q, k, v).reshape(batch, seq, -1)
        x = x + mods[2][:, None] * self.self_attn_proj(attn)

        # cross-attention to the text (no rope, ungated; affine norm)
        x_c = self.cross_norm(x)
        ctx = (batch, context.shape[1], cfg.num_heads, cfg.head_dim)
        q = self._qk("cross_attn", "q", x_c).reshape(heads)
        k = self._qk("cross_attn", "k", context).reshape(ctx)
        v = self.cross_attn_v(context).reshape(ctx)
        x = x + self.cross_attn_proj(dot_product_attention(q, k, v).reshape(batch, seq, -1))

        # feed-forward
        x_f = modulate(layer_norm(x, dtype), mods[3], mods[4])
        return x + mods[5][:, None] * self.ffn_out(F.gelu(self.ffn_in(x_f), approximate="tanh"))


def rope_ids(frames: int, height: int, width: int, device) -> torch.Tensor:
    """(1, frames * height * width, 3) (t, h, w) ids in row-major order."""
    grids = torch.meshgrid(torch.arange(frames, device=device), torch.arange(height, device=device),
                           torch.arange(width, device=device), indexing="ij")
    return torch.stack(grids, dim=-1).reshape(1, -1, 3)


class WanTransformer(nn.Module):
    """The Wan DiT.  ``latents`` (B, T, H, W, C) noisy video latents,
    ``timesteps`` (B,) sigmas in [0, 1], ``context`` (B, L, text_dim) umT5
    features; returns the (B, T, H, W, out) flow prediction in f32."""

    def __init__(self, config: WanConfig = WanConfig(), dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora", remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim = config.hidden_size
        pt, ph, pw = config.patch
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.patch_in = LoRADense(pt * ph * pw * config.in_channels, dim, **lora)
        self.text_in0 = LoRADense(config.text_dim, dim, **lora)
        self.text_in2 = LoRADense(dim, dim, **lora)
        self.time_in = MLPEmbedder(256, dim, dtype=dtype)
        self.time_proj = LoRADense(dim, 6 * dim, dtype=dtype)
        for layer in range(config.depth):
            self.add_module(f"block_{layer}", WanBlock(config, **lora))
        self.final_scale_shift_table = nn.Parameter(torch.empty(2, dim, dtype=torch.float32))
        self.final_proj = LoRADense(dim, pt * ph * pw * (config.out_channels or config.in_channels), dtype=dtype)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.final_scale_shift_table.normal_(0.0, 1.0 / math.sqrt(self.config.hidden_size), generator=generator)

    def _run(self, block: nn.Module, *args):
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        dim = cfg.hidden_size
        pt, ph, pw = cfg.patch
        batch, frames, height, width, channels = latents.shape
        tt, hh, ww = frames // pt, height // ph, width // pw
        out_ch = cfg.out_channels or channels

        # (1, 2, 2) patchify, (pt, ph, pw, C) feature order
        x = latents.reshape(batch, tt, pt, hh, ph, ww, pw, channels).permute(0, 1, 3, 5, 2, 4, 6, 7)
        x = self.patch_in(x.reshape(batch, tt * hh * ww, pt * ph * pw * channels))
        txt = self.text_in2(F.gelu(self.text_in0(context), approximate="tanh"))
        vec = self.time_in(timestep_embedding(timesteps, 256).to(dtype))
        e6 = self.time_proj(F.silu(vec)).reshape(-1, 6, dim)
        cos, sin = axial_rope(cfg.axes_dim, rope_ids(tt, hh, ww, latents.device).expand(batch, -1, -1))

        for layer in range(cfg.depth):
            x = self._run(getattr(self, f"block_{layer}"), x, txt, e6, cos, sin)

        # final head: (2, dim) table + the timestep vector (diffusers wan norm_out)
        final = self.final_scale_shift_table[None] + vec.to(torch.float32)[:, None]
        shift, scale = final[:, 0].to(dtype), final[:, 1].to(dtype)
        x = self.final_proj(modulate(layer_norm(x, dtype), shift, scale))
        x = x.reshape(batch, tt, hh, ww, pt, ph, pw, out_ch).permute(0, 1, 4, 2, 5, 3, 6, 7)
        return x.reshape(batch, frames, height, width, out_ch).to(torch.float32)
