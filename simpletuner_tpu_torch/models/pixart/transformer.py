"""PixArt (alpha / Sigma) DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/pixart/transformer.py`` (diffusers'
``PixArtTransformer2DModel`` with ``ada_norm_single`` blocks): a 2x2 patch
embedding with the diffusers sincos position table (``base_size`` and
``interpolation_scale``; computed per bucket, never stored), caption tokens
through a gelu-tanh projection MLP, adaLN-single (one 6 x dim modulation
``t6`` from the timestep embedding shared by every block, plus each block's
learned ``scale_shift_table``), blocks of self-attention on the modulated
stream -> cross-attention on the **raw** stream (no norm, no gate) -> the
modulated gelu-tanh feed-forward, and a final (2, dim) table shifted by the
embedded timestep.  The learned-range head of the Sigma checkpoints puts out
2 x ``in_channels``; only the epsilon half is returned, as the JAX module
returns it.  Submodules keep the JAX names
(``block_{i}.attn1_q``, ``time_in.in_layer``, ``final_scale_shift_table``).

Mirrored as the JAX module computes them: the modulations are summed in f32
and cast to the compute dtype; the LayerNorms have no affine and eps 1e-6;
the position table is float64 (numpy, on the host) cast once to the compute
dtype.  Attention
runs through ``ops.dot_product_attention`` (the Hopper flash kernel on the
card; a head dim of 72 is zero-padded to 128 there, with the softmax scale
72^-0.5), unmasked on both: the family collates no caption mask.  Remat
(``gradient_checkpointing``) checkpoints every block whole, as ``nn.remat``
wraps ``PixartBlock``.  Refused: PixArt-alpha 1024's resolution and
aspect-ratio embedders (``use_additional_conditions``; no family of the
registry sets it, ROADMAP Queue 1 item 6) and ControlNet residuals
(PixArt-delta, item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import dot_product_attention
from ..flux.transformer import pack_latents, unpack_latents
from ..layers import LoRADense, MLPEmbedder, layer_norm, modulate, timestep_embedding


@dataclasses.dataclass(frozen=True)
class PixartConfig:
    in_channels: int = 4
    out_channels: int = 0  # 0 = same as in; the Sigma checkpoints' learned-range head has 2x
    patch_size: int = 2
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    head_dim: int = 72
    text_dim: int = 4096
    ffn_ratio: float = 4.0
    # diffusers PatchEmbed sincos parameters: base_size = sample_size // patch,
    # interpolation_scale = max(sample_size // 64, 1)
    base_size: int = 64
    interpolation_scale: int = 2
    use_additional_conditions: bool = False  # PixArt-alpha 1024 only

    @classmethod
    def tiny(cls) -> "PixartConfig":
        return cls(hidden_size=64, depth=2, num_heads=2, head_dim=32, text_dim=32, base_size=8,
                   interpolation_scale=1)

    @classmethod
    def sigma_1024(cls) -> "PixartConfig":
        return cls(out_channels=8)

    @classmethod
    def sigma_512(cls) -> "PixartConfig":
        return cls(out_channels=8, base_size=32, interpolation_scale=1)

    @property
    def effective_out_channels(self) -> int:
        return self.out_channels or self.in_channels


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_pos_embed_2d(embed_dim: int, grid_h: int, grid_w: int, base_size: int,
                        interpolation_scale: float) -> np.ndarray:
    """diffusers ``get_2d_sincos_pos_embed`` (row-major h, w), (h*w, dim) in
    float64 on the host, as the JAX function computes it: the width's
    sin|cos, then the height's."""
    gh = np.arange(grid_h, dtype=np.float64) / (grid_h / base_size) / interpolation_scale
    gw = np.arange(grid_w, dtype=np.float64) / (grid_w / base_size) / interpolation_scale
    grid = np.stack(np.meshgrid(gw, gh), axis=0).reshape(2, 1, grid_h, grid_w)  # w first, 'xy' indexing
    return np.concatenate([_sincos_1d(embed_dim // 2, grid[0]), _sincos_1d(embed_dim // 2, grid[1])], axis=1)


def _reset_table(table: torch.Tensor, dim: int, generator: Optional[torch.Generator]) -> None:
    # flax normal(stddev=1/sqrt(dim))
    table.normal_(0.0, dim ** -0.5, generator=generator)


class PixartBlock(nn.Module):
    """``BasicTransformerBlock(ada_norm_single)``: self-attention -> cross-
    attention on the unnormalized stream, ungated -> gelu-tanh feed-forward."""

    def __init__(self, config: PixartConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, inner = config.hidden_size, config.num_heads * config.head_dim
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.scale_shift_table = nn.Parameter(torch.empty(6, dim, dtype=torch.float32))
        for attn in ("attn1", "attn2"):
            for proj in ("q", "k", "v"):
                self.add_module(f"{attn}_{proj}", LoRADense(dim, inner, **lora))
            self.add_module(f"{attn}_proj", LoRADense(inner, dim, **lora))
        self.ff_in = LoRADense(dim, int(dim * config.ffn_ratio), **lora)
        self.ff_out = LoRADense(int(dim * config.ffn_ratio), dim, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_table(self.scale_shift_table, self.config.hidden_size, generator)

    def _attention(self, name: str, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        q = getattr(self, f"{name}_q")(x).reshape(x.shape[0], x.shape[1], cfg.num_heads, cfg.head_dim)
        kv_shape = (context.shape[0], context.shape[1], cfg.num_heads, cfg.head_dim)
        k = getattr(self, f"{name}_k")(context).reshape(kv_shape)
        v = getattr(self, f"{name}_v")(context).reshape(kv_shape)
        attn = dot_product_attention(q, k, v).reshape(x.shape[0], x.shape[1], -1)
        return getattr(self, f"{name}_proj")(attn)

    def forward(self, x: torch.Tensor, context: torch.Tensor, t6: torch.Tensor) -> torch.Tensor:
        mods = (self.scale_shift_table[None] + t6.to(torch.float32)).to(self.dtype)  # (B, 6, dim)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (mods[:, i][:, None] for i in range(6))
        x_n = modulate(layer_norm(x, self.dtype), shift_msa, scale_msa)
        x = x + gate_msa * self._attention("attn1", x_n, x_n)
        x = x + self._attention("attn2", x, context)
        h = self.ff_in(modulate(layer_norm(x, self.dtype), shift_mlp, scale_mlp))
        return x + gate_mlp * self.ff_out(F.gelu(h, approximate="tanh"))


class PixartTransformer(nn.Module):
    """The PixArt DiT.  ``latents`` (B, H, W, C) noisy latents, ``timesteps``
    (B,) DDPM timesteps, ``context`` (B, L, text_dim) T5 features; returns the
    (B, H, W, in_channels) epsilon in f32."""

    def __init__(self, config: PixartConfig = PixartConfig(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        if config.use_additional_conditions:
            raise NotImplementedError("PixArt-alpha's size conditioning (use_additional_conditions) is not ported "
                                      "(ROADMAP Queue 1 item 6)")
        self.config, self.dtype, self.remat = config, dtype, remat
        dim, p = config.hidden_size, config.patch_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.patch_in = LoRADense(p * p * config.in_channels, dim, **lora)
        self.caption_in_1 = LoRADense(config.text_dim, dim, **lora)
        self.caption_in_2 = LoRADense(dim, dim, **lora)
        self.time_in = MLPEmbedder(256, dim, dtype=dtype)
        self.time_proj = LoRADense(dim, 6 * dim, dtype=dtype)
        for layer in range(config.depth):
            self.add_module(f"block_{layer}", PixartBlock(config, **lora))
        self.final_scale_shift_table = nn.Parameter(torch.empty(2, dim, dtype=torch.float32))
        self.final_proj = LoRADense(dim, p * p * config.effective_out_channels, **lora)
        self._positions: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def position_table(self, hh: int, ww: int, device) -> torch.Tensor:
        """The (hh*ww, dim) sincos table in the compute dtype on ``device``,
        made on the host the first time a bucket shape is seen (an eager or
        warm-up step; a captured step reads it), as the JAX module makes it a
        constant of the traced program."""
        key = (hh, ww, torch.device(device))
        if key not in self._positions:
            cfg = self.config
            table = sincos_pos_embed_2d(cfg.hidden_size, hh, ww, cfg.base_size, cfg.interpolation_scale)
            self._positions[key] = torch.from_numpy(table).to(self.dtype).to(device)
        return self._positions[key]

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_table(self.final_scale_shift_table, self.config.hidden_size, generator)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                controlnet_block_residuals: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        if controlnet_block_residuals is not None:
            raise NotImplementedError("PixArt ControlNet residuals are not ported (ROADMAP Queue 1 item 7)")
        cfg, dtype = self.config, self.dtype
        p, dim = cfg.patch_size, cfg.hidden_size
        height, width = latents.shape[1:3]
        hh, ww = height // p, width // p
        x = self.patch_in(pack_latents(latents, p))
        x = x + self.position_table(hh, ww, latents.device)[None]
        txt = self.caption_in_2(F.gelu(self.caption_in_1(context), approximate="tanh"))
        t_emb = self.time_in(timestep_embedding(timesteps.to(torch.float32), 256, time_factor=1.0).to(dtype))
        t6 = self.time_proj(F.silu(t_emb)).reshape(-1, 6, dim)
        for layer in range(cfg.depth):
            block = getattr(self, f"block_{layer}")
            if self.remat and torch.is_grad_enabled():
                # a block draws no random numbers: the recompute needs no RNG state
                x = checkpoint(block, x, txt, t6, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x, txt, t6)
        mods = self.final_scale_shift_table[None] + t_emb[:, None, :].to(torch.float32)  # (B, 2, dim)
        x = modulate(layer_norm(x, dtype), mods[:, 0][:, None].to(dtype), mods[:, 1][:, None].to(dtype))
        x = unpack_latents(self.final_proj(x), height, width, p)
        return x[..., : cfg.in_channels].to(torch.float32)
