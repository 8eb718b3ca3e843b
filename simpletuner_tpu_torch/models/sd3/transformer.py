"""SD3 / SD3.5 MMDiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/sd3/transformer.py``: 2x2 patch
embedding, the learned position table centre-cropped to the latent grid
(diffusers ``pos_embed_max_size``) or, without one, 2-D sincos positions,
pooled-CLIP and timestep conditioning summed into one vector, and a stack of
MMDiT blocks with separate image/text parameters and joint attention over
the text tokens followed by the image tokens.  The last block is
``context_pre_only``: its text stream only feeds the attention (two text
modulations, no text projection or MLP).  Submodules keep the JAX names
(``block_{i}.img_attn_q``, ``pooled_in.in_layer``, ``pos_embed``, ...).

Remat (``gradient_checkpointing``) checkpoints every block whole under
``torch.utils.checkpoint`` (non-reentrant, no RNG state), as the JAX module
wraps each block in ``nn.remat``; the JAX SD3 transformer has no other
policy.  Skip-layer guidance (``skip_layers``, ROADMAP Queue 1 item 4d) and
ControlNet residuals (item 7) are not ported and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import dot_product_attention
from ..flux.transformer import pack_latents, unpack_latents
from ..layers import (
    AdaLayerNormZero,
    LoRADense,
    MLPEmbedder,
    RMSNorm,
    gate_mod,
    layer_norm,
    modulate,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class SD3Config:
    in_channels: int = 16
    patch_size: int = 2
    hidden_size: int = 1536  # sd3-medium: 24 layers * 64
    depth: int = 24
    num_heads: int = 24
    context_dim: int = 4096  # t5 + padded clip sequence features
    pooled_dim: int = 2048  # clip-l + clip-g pooled
    mlp_ratio: float = 4.0
    qk_norm: bool = True
    # learned pos-embed grid side (diffusers pos_embed_max_size); 0 = sincos
    pos_embed_max_size: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def medium(cls) -> "SD3Config":
        return cls(pos_embed_max_size=192)

    @classmethod
    def large(cls) -> "SD3Config":
        """stabilityai/stable-diffusion-3.5-large's ``transformer/config.json`` (8.1B parameters)."""
        return cls(hidden_size=2432, depth=38, num_heads=38, pos_embed_max_size=192)

    @classmethod
    def tiny(cls) -> "SD3Config":
        # dims match the tiny text encoders: CLIP-L 32 + CLIP-G 64 (sequence concat 96 = pooled concat 96)
        return cls(hidden_size=64, depth=2, num_heads=2, context_dim=96, pooled_dim=96)


def posemb_2d_sincos(height: int, width: int, dim: int, base: float = 10000.0, device=None) -> torch.Tensor:
    """Fixed 2-D sincos position embedding (H*W, dim): sin|cos of the row, then sin|cos of the column."""
    quarter = dim // 4
    omega = 1.0 / (base ** (torch.arange(quarter, dtype=torch.float32, device=device) / quarter))
    out_y = torch.arange(height, dtype=torch.float32, device=device)[:, None] * omega[None]
    out_x = torch.arange(width, dtype=torch.float32, device=device)[:, None] * omega[None]
    emb_y = torch.cat([torch.sin(out_y), torch.cos(out_y)], dim=-1)
    emb_x = torch.cat([torch.sin(out_x), torch.cos(out_x)], dim=-1)
    grid = torch.cat([emb_y[:, None, :].expand(height, width, 2 * quarter),
                      emb_x[None, :, :].expand(height, width, 2 * quarter)], dim=-1)
    return grid.reshape(height * width, -1)


class MMDiTBlock(nn.Module):
    """Joint attention block: separate img/txt projections and MLPs, one
    attention over the text tokens followed by the image tokens."""

    def __init__(self, config: SD3Config, context_pre_only: bool = False, dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config = config
        self.context_pre_only = context_pre_only
        self.dtype = dtype
        dim = config.hidden_size
        mlp_dim = int(dim * config.mlp_ratio)
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.img_mod = AdaLayerNormZero(dim, 6, dtype=dtype)
        self.txt_mod = AdaLayerNormZero(dim, 2 if context_pre_only else 6, dtype=dtype)
        for prefix in ("img", "txt"):
            for proj in ("q", "k", "v"):
                self.add_module(f"{prefix}_attn_{proj}", LoRADense(dim, dim, **lora))
            if config.qk_norm:
                self.add_module(f"{prefix}_attn_norm_q", RMSNorm(config.head_dim, dtype=dtype))
                self.add_module(f"{prefix}_attn_norm_k", RMSNorm(config.head_dim, dtype=dtype))
        streams = ("img",) if context_pre_only else ("img", "txt")
        for prefix in streams:
            self.add_module(f"{prefix}_attn_proj", LoRADense(dim, dim, **lora))
            self.add_module(f"{prefix}_mlp_in", LoRADense(dim, mlp_dim, **lora))
            self.add_module(f"{prefix}_mlp_out", LoRADense(mlp_dim, dim, **lora))

    def _qkv(self, prefix: str, x: torch.Tensor):
        cfg = self.config
        shape = (x.shape[0], x.shape[1], cfg.num_heads, cfg.head_dim)
        q = getattr(self, f"{prefix}_attn_q")(x).reshape(shape)
        k = getattr(self, f"{prefix}_attn_k")(x).reshape(shape)
        v = getattr(self, f"{prefix}_attn_v")(x).reshape(shape)
        if cfg.qk_norm:
            q = getattr(self, f"{prefix}_attn_norm_q")(q)
            k = getattr(self, f"{prefix}_attn_norm_k")(k)
        return q, k, v

    def _residual(self, prefix: str, x: torch.Tensor, attn: torch.Tensor, mods) -> torch.Tensor:
        x = x + gate_mod(mods[2]) * getattr(self, f"{prefix}_attn_proj")(attn)
        h = getattr(self, f"{prefix}_mlp_in")(modulate(layer_norm(x, self.dtype), mods[3], mods[4]))
        return x + gate_mod(mods[5]) * getattr(self, f"{prefix}_mlp_out")(F.gelu(h, approximate="tanh"))

    def forward(self, img: torch.Tensor, txt: torch.Tensor, vec: torch.Tensor):
        img_mods = self.img_mod(vec)
        txt_mods = self.txt_mod(vec)
        img_q, img_k, img_v = self._qkv("img", modulate(layer_norm(img, self.dtype), img_mods[0], img_mods[1]))
        txt_q, txt_k, txt_v = self._qkv("txt", modulate(layer_norm(txt, self.dtype), txt_mods[0], txt_mods[1]))
        # the joint stream: text tokens first, then image tokens
        attn = dot_product_attention(torch.cat([txt_q, img_q], dim=1), torch.cat([txt_k, img_k], dim=1),
                                     torch.cat([txt_v, img_v], dim=1))
        attn = attn.reshape(img.shape[0], -1, self.config.hidden_size)
        txt_attn, img_attn = attn[:, : txt.shape[1]], attn[:, txt.shape[1]:]
        img = self._residual("img", img, img_attn, img_mods)
        if self.context_pre_only:
            return img, txt
        return img, self._residual("txt", txt, txt_attn, txt_mods)


class SD3Transformer(nn.Module):
    """The SD3 MMDiT.  ``latents`` (B, H, W, C) noisy latents, ``timesteps``
    (B,) sigma in [0, 1], ``context`` (B, T, context_dim) CLIP + T5 sequence
    features, ``pooled`` (B, pooled_dim); returns the (B, H, W, C) velocity in
    f32.  ``remat`` checkpoints every block (module docstring)."""

    def __init__(self, config: SD3Config = SD3Config(), dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora", remat: bool = False) -> None:
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.remat = remat
        dim, p = config.hidden_size, config.patch_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.patch_in = LoRADense(p * p * config.in_channels, dim, **lora)
        if config.pos_embed_max_size:
            side = config.pos_embed_max_size
            self.pos_embed = nn.Parameter(torch.empty(side, side, dim, dtype=torch.float32))
        self.context_in = LoRADense(config.context_dim, dim, **lora)
        self.time_in = MLPEmbedder(256, dim, dtype=dtype)
        self.pooled_in = MLPEmbedder(config.pooled_dim, dim, dtype=dtype)
        for layer in range(config.depth):
            self.add_module(f"block_{layer}", MMDiTBlock(config, context_pre_only=layer == config.depth - 1, **lora))
        self.final_mod = AdaLayerNormZero(dim, 2, dtype=dtype)
        self.final_proj = LoRADense(dim, p * p * config.in_channels, dtype=dtype)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The learned position table, N(0, 0.02) as the Flax initialiser."""
        if self.config.pos_embed_max_size:
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def _positions(self, hh: int, ww: int, device) -> torch.Tensor:
        if not self.config.pos_embed_max_size:
            return posemb_2d_sincos(hh, ww, self.config.hidden_size, device=device)
        side = self.config.pos_embed_max_size
        top, left = (side - hh) // 2, (side - ww) // 2
        return self.pos_embed[top: top + hh, left: left + ww].reshape(hh * ww, -1)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor, pooled: torch.Tensor,
                controlnet_block_residuals: Optional[Sequence[torch.Tensor]] = None,
                skip_layers: Optional[Sequence[int]] = None) -> torch.Tensor:
        if skip_layers is not None:
            raise NotImplementedError("skip-layer guidance is not ported (ROADMAP Queue 1 item 4d)")
        if controlnet_block_residuals is not None:
            raise NotImplementedError("ControlNet residuals are not ported (ROADMAP Queue 1 item 7)")
        cfg = self.config
        if latents.shape[-1] != cfg.in_channels:
            raise ValueError(f"latents with {latents.shape[-1]} channels; this SD3 takes {cfg.in_channels} "
                             "(SD3Config.in_channels, the 16-channel VAE's)")
        p = cfg.patch_size
        height, width = latents.shape[1], latents.shape[2]
        x = self.patch_in(pack_latents(latents, p))
        x = x + self._positions(height // p, width // p, latents.device)[None].to(self.dtype)
        txt = self.context_in(context)
        vec = self.time_in(timestep_embedding(timesteps, 256).to(self.dtype))
        vec = vec + self.pooled_in(pooled.to(self.dtype))
        for layer in range(cfg.depth):
            block = getattr(self, f"block_{layer}")
            if self.remat and torch.is_grad_enabled():
                # a block draws no random numbers: the recompute needs no RNG
                # state (reading it is refused while a CUDA graph captures)
                x, txt = checkpoint(block, x, txt, vec, use_reentrant=False, preserve_rng_state=False)
            else:
                x, txt = block(x, txt, vec)
        shift, scale = self.final_mod(vec)
        x = self.final_proj(modulate(layer_norm(x, self.dtype), shift, scale))
        return unpack_latents(x, height, width, p).to(torch.float32)

