"""Cosmos (Predict2) video DiT core in PyTorch, also the core of Anima.

Counterpart of ``simpletuner_tpu/models/cosmos1/transformer.py``
(``CosmosTransformer3DModel``), NTHWC like the JAX module:

- a bias-free patch embed over features in [C, p_t, p_h, p_w] order, after a
  constant padding-mask plane (zeros by default) is concatenated onto the
  latent channels (``concat_padding_mask``); the unpatchify reads the
  output features in the other order, [p_h, p_w, p_t, C];
- the time embedding: a [cos, sin] sinusoid, a bias-free SiLU MLP to 3H
  (``temb``) and an affine RMSNorm (eps 1e-6) of the sinusoid
  (``embedded``); per-token (B, S) timesteps give per-token embeddings;
- per-block AdaLN-LoRA heads (silu -> ``linear_1`` (H -> 256) ->
  ``linear_2`` (256 -> 3H), plus ``temb``) before each of self-attention,
  cross-attention and the feed-forward, over a LayerNorm without affine
  (eps 1e-6), with gated residuals; the output head reads ``temb[..., :2H]``;
- bias-free attention with affine per-head RMS q/k norms (eps 1e-5, ones at
  init), the self-attention rotated by a per-axis NTK rope (thetas
  ``10000 * scale^(d / (d - 2))`` over the post-patch (t, h, w) grid,
  non-interleaved half rotation), made on the host in float64 once per grid,
  fps and device; the cross-attention over the text without rope;
- the exact-erf gelu in the feed-forward (not the tanh gelu of the other
  DiTs);
- the L2-normalised learnable position embedding, added before every block
  where the preset has one (``tiny``; the published presets have none).

The self- and cross-attentions go through :func:`dot_product_attention`
(the flash kernels on the card); a text mask, where a caller passes one,
masks keys, and the families pass none (zeroed T5 pads still attend, as in
JAX).  Submodules keep the JAX names (``block_{i}.attn1_q``,
``block_{i}.norm2.linear_2``); remat (``gradient_checkpointing``)
checkpoints every block whole.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import dot_product_attention, key_mask_segments
from ..layers import LoRADense, layer_norm

Angles = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Cosmos1Config:
    in_channels: int = 16
    out_channels: int = 16
    num_heads: int = 32
    head_dim: int = 128
    num_layers: int = 28
    mlp_ratio: float = 4.0
    text_embed_dim: int = 1024
    adaln_lora_dim: int = 256
    max_size: Tuple[int, int, int] = (128, 240, 240)
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    rope_scale: Tuple[float, float, float] = (2.0, 1.0, 1.0)
    concat_padding_mask: bool = True
    learnable_pos_embed: bool = True
    base_fps: int = 24

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim

    @classmethod
    def tiny(cls) -> "Cosmos1Config":
        return cls(
            in_channels=4, out_channels=4, num_heads=2, head_dim=12, num_layers=2,
            mlp_ratio=2.0, text_embed_dim=32, adaln_lora_dim=8,
            max_size=(16, 64, 64),
        )

    @classmethod
    def anima(cls) -> "Cosmos1Config":
        """Anima's core: 16 heads of 128, 28 layers, rope scale (1, 4, 4), no learnable position embedding."""
        return cls(
            num_heads=16, head_dim=128, num_layers=28, text_embed_dim=1024,
            rope_scale=(1.0, 4.0, 4.0), learnable_pos_embed=False,
        )

    @classmethod
    def predict2_2b(cls) -> "Cosmos1Config":
        """Cosmos-Predict2-2B-Text2Image: the core dims of Anima's."""
        return cls.anima()

    @classmethod
    def predict2_14b(cls) -> "Cosmos1Config":
        """Cosmos-Predict2-14B-Text2Image: 40 heads of 128 (5120 wide), 36 layers."""
        return cls(
            num_heads=40, head_dim=128, num_layers=36, text_embed_dim=1024,
            rope_scale=(1.0, 4.0, 4.0), learnable_pos_embed=False,
        )


def cosmos1_rope(config: Cosmos1Config, grid: Tuple[int, int, int], fps: Optional[float] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """cos and sin (S, head_dim) f32 over the post-patch (t, h, w) grid, made in float64."""
    hd = config.head_dim
    dim_h = dim_w = hd // 6 * 2
    dim_t = hd - dim_h - dim_w
    t_theta = 10000.0 * config.rope_scale[0] ** (dim_t / (dim_t - 2))
    h_theta = 10000.0 * config.rope_scale[1] ** (dim_h / (dim_h - 2))
    w_theta = 10000.0 * config.rope_scale[2] ** (dim_w / (dim_w - 2))

    t, h, w = grid
    h_freqs = 1.0 / h_theta ** (np.arange(0, dim_h, 2, dtype=np.float64)[: dim_h // 2] / dim_h)
    w_freqs = 1.0 / w_theta ** (np.arange(0, dim_w, 2, dtype=np.float64)[: dim_w // 2] / dim_w)
    t_freqs = 1.0 / t_theta ** (np.arange(0, dim_t, 2, dtype=np.float64)[: dim_t // 2] / dim_t)

    t_pos = np.arange(t, dtype=np.float64)
    if fps is not None:
        t_pos = t_pos / fps * config.base_fps
    emb_t = np.outer(t_pos, t_freqs)[:, None, None, :]
    emb_h = np.outer(np.arange(h, dtype=np.float64), h_freqs)[None, :, None, :]
    emb_w = np.outer(np.arange(w, dtype=np.float64), w_freqs)[None, None, :, :]
    full = np.concatenate(
        [np.broadcast_to(emb_t, (t, h, w, emb_t.shape[-1])),
         np.broadcast_to(emb_h, (t, h, w, emb_h.shape[-1])),
         np.broadcast_to(emb_w, (t, h, w, emb_w.shape[-1]))] * 2,
        axis=-1,
    ).reshape(t * h * w, hd)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


def apply_half_rope(x: torch.Tensor, angles: Angles) -> torch.Tensor:
    """Non-interleaved half rotation of (B, S, H, D) ``x`` by (S, D) tables, in f32."""
    cos, sin = angles
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.to(torch.float32) * cos[:, None, :] + rotated.to(torch.float32) * sin[:, None, :]).to(x.dtype)


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Affine RMSNorm in f32, returned in x's dtype."""
    x_f = x.to(torch.float32)
    return (x_f * torch.rsqrt(x_f.square().mean(dim=-1, keepdim=True) + eps) * scale.to(torch.float32)).to(x.dtype)


class CosmosAdaZero(nn.Module):
    """A block's AdaLN-LoRA head: (LayerNorm(x) * (1 + scale) + shift, gate)."""

    def __init__(self, hidden_size: int, lora_dim: int) -> None:
        super().__init__()
        if lora_dim != hidden_size:
            self.linear_1 = LoRADense(hidden_size, lora_dim, use_bias=False, dtype=torch.float32)
        self.linear_2 = LoRADense(lora_dim, 3 * hidden_size, use_bias=False, dtype=torch.float32)

    def forward(self, x: torch.Tensor, embedded: torch.Tensor, temb: torch.Tensor):
        e = F.silu(embedded.to(torch.float32))
        if hasattr(self, "linear_1"):
            e = self.linear_1(e)
        e = self.linear_2(e) + temb.to(torch.float32)
        shift, scale, gate = e.chunk(3, dim=-1)
        if shift.dim() == 2:
            shift, scale, gate = shift[:, None], scale[:, None], gate[:, None]
        return (layer_norm(x, torch.float32) * (1.0 + scale) + shift).to(x.dtype), gate


class Cosmos1Block(nn.Module):
    def __init__(self, config: Cosmos1Config, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, hd = config.hidden_size, config.head_dim
        lora = dict(use_bias=False, dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        for norm in ("norm1", "norm2", "norm3"):
            self.add_module(norm, CosmosAdaZero(dim, config.adaln_lora_dim))
        for prefix, kv_dim in (("attn1", dim), ("attn2", config.text_embed_dim)):
            self.add_module(f"{prefix}_q", LoRADense(dim, dim, **lora))
            self.add_module(f"{prefix}_k", LoRADense(kv_dim, dim, **lora))
            self.add_module(f"{prefix}_v", LoRADense(kv_dim, dim, **lora))
            self.register_parameter(f"{prefix}_norm_q", nn.Parameter(torch.empty(hd, dtype=torch.float32)))
            self.register_parameter(f"{prefix}_norm_k", nn.Parameter(torch.empty(hd, dtype=torch.float32)))
            self.add_module(f"{prefix}_out", LoRADense(dim, dim, **lora))
        self.ff_in = LoRADense(dim, int(dim * config.mlp_ratio), **lora)
        self.ff_out = LoRADense(int(dim * config.mlp_ratio), dim, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for prefix in ("attn1", "attn2"):
            getattr(self, f"{prefix}_norm_q").fill_(1.0)
            getattr(self, f"{prefix}_norm_k").fill_(1.0)

    def _attend(self, prefix: str, query_src: torch.Tensor, kv_src: torch.Tensor, angles: Optional[Angles],
                key_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        batch = query_src.shape[0]
        heads, hd = cfg.num_heads, cfg.head_dim
        q = getattr(self, f"{prefix}_q")(query_src).reshape(batch, -1, heads, hd)
        k = getattr(self, f"{prefix}_k")(kv_src).reshape(batch, -1, heads, hd)
        v = getattr(self, f"{prefix}_v")(kv_src).reshape(batch, -1, heads, hd)
        q = rms(q, getattr(self, f"{prefix}_norm_q"), 1e-5)
        k = rms(k, getattr(self, f"{prefix}_norm_k"), 1e-5)
        if angles is not None:
            q, k = apply_half_rope(q, angles), apply_half_rope(k, angles)
        q_ids = None if key_ids is None else torch.ones((batch, q.shape[1]), dtype=torch.int32, device=q.device)
        out = dot_product_attention(q, k, v, q_segment_ids=q_ids, kv_segment_ids=key_ids)
        return getattr(self, f"{prefix}_out")(out.reshape(batch, -1, cfg.hidden_size).to(self.dtype))

    def forward(self, x: torch.Tensor, context: torch.Tensor, embedded: torch.Tensor, temb: torch.Tensor,
                angles: Angles, context_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        normed, gate = self.norm1(x, embedded, temb)
        x = (x.to(torch.float32) + gate * self._attend("attn1", normed, normed, angles).to(torch.float32)).to(x.dtype)
        normed, gate = self.norm2(x, embedded, temb)
        cross = self._attend("attn2", normed, context, None, context_ids)
        x = (x.to(torch.float32) + gate * cross.to(torch.float32)).to(x.dtype)
        normed, gate = self.norm3(x, embedded, temb)
        h = self.ff_out(F.gelu(self.ff_in(normed), approximate="none"))
        return (x.to(torch.float32) + gate * h.to(torch.float32)).to(x.dtype)


class Cosmos1Transformer(nn.Module):
    """The Cosmos DiT core.  ``latents`` (B, T, H, W, C) NTHWC, ``timesteps``
    (B,) or (B, S), ``context`` (B, S_txt, text_embed_dim), ``context_mask``
    (B, S_txt) or None, the padding-mask plane's constant value and the
    clip's fps (None: frame index positions); returns (B, T, H, W, C) f32."""

    def __init__(self, config: Cosmos1Config = Cosmos1Config(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim = config.hidden_size
        pt, ph, pw = config.patch_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        c_in = config.in_channels + (1 if config.concat_padding_mask else 0)
        self.patch_embed = LoRADense(c_in * pt * ph * pw, dim, use_bias=False, **lora)
        self.t_embedder_1 = LoRADense(dim, dim, use_bias=False, dtype=torch.float32)
        self.t_embedder_2 = LoRADense(dim, 3 * dim, use_bias=False, dtype=torch.float32)
        self.t_norm = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        if config.learnable_pos_embed:
            for axis, (size, patch) in zip("thw", zip(config.max_size, config.patch_size)):
                self.register_parameter(f"pos_emb_{axis}", nn.Parameter(torch.empty(size // patch, dim,
                                                                                    dtype=torch.float32)))
        for i in range(config.num_layers):
            self.add_module(f"block_{i}", Cosmos1Block(config, **lora))
        self.norm_out_1 = LoRADense(dim, config.adaln_lora_dim, use_bias=False, dtype=torch.float32)
        self.norm_out_2 = LoRADense(config.adaln_lora_dim, 2 * dim, use_bias=False, dtype=torch.float32)
        self.proj_out = LoRADense(dim, pt * ph * pw * config.out_channels, use_bias=False, **lora)
        self._tables: Dict[Tuple, Angles] = {}

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.t_norm.fill_(1.0)
        if self.config.learnable_pos_embed:
            for axis in "thw":
                getattr(self, f"pos_emb_{axis}").normal_(0.0, 0.02, generator=generator)

    def rope_table(self, grid: Tuple[int, int, int], fps: Optional[float], device: torch.device) -> Angles:
        """The rope tables of a grid, made on the host once per grid, fps and
        device (before a captured step needs them)."""
        key = (grid, fps, device)
        if key not in self._tables:
            cos, sin = cosmos1_rope(self.config, grid, fps)
            self._tables[key] = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))
        return self._tables[key]

    def _run(self, name: str, *args):
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None, padding_mask_value: float = 0.0,
                fps: Optional[float] = None) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        dim = cfg.hidden_size
        batch, t_in, h_in, w_in, _ = latents.shape
        pt, ph, pw = cfg.patch_size
        grid = (t_in // pt, h_in // ph, w_in // pw)
        seq = grid[0] * grid[1] * grid[2]

        x = latents.to(dtype)
        if cfg.concat_padding_mask:
            x = torch.cat([x, torch.full((batch, t_in, h_in, w_in, 1), padding_mask_value, dtype=dtype,
                                         device=x.device)], dim=-1)
        c_in = x.shape[-1]
        x = x.reshape(batch, grid[0], pt, grid[1], ph, grid[2], pw, c_in).permute(0, 1, 3, 5, 7, 2, 4, 6)
        x = self.patch_embed(x.reshape(batch, seq, c_in * pt * ph * pw))

        half = dim // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=x.device) / half)
        args = timesteps.to(torch.float32).reshape(-1)[:, None] * freqs[None]
        proj = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        temb = self.t_embedder_2(F.silu(self.t_embedder_1(proj)))
        embedded = rms(proj, self.t_norm, 1e-6)
        if timesteps.dim() == 2:
            temb = temb.reshape(batch, timesteps.shape[1], 3 * dim)
            embedded = embedded.reshape(batch, timesteps.shape[1], dim)

        angles = self.rope_table(grid, fps, x.device)
        extra = None
        if cfg.learnable_pos_embed:
            limits = tuple(size // patch for size, patch in zip(cfg.max_size, cfg.patch_size))
            if any(g > m for g, m in zip(grid, limits)):
                raise ValueError(f"input grid {grid} exceeds learnable pos-embed max_size {cfg.max_size} (post-patch)")
            emb = (self.pos_emb_t[: grid[0], None, None] + self.pos_emb_h[None, : grid[1], None]
                   + self.pos_emb_w[None, None, : grid[2]]).reshape(1, seq, dim).to(torch.float32)
            norm = 1e-6 + emb.square().sum(dim=-1, keepdim=True).sqrt() * float(np.sqrt(1.0 / dim))
            extra = (emb / norm).to(dtype)

        ctx = context.to(dtype)
        context_ids = key_mask_segments(context_mask)
        for i in range(cfg.num_layers):
            if extra is not None:
                x = x + extra  # before every block
            x = self._run(f"block_{i}", x, ctx, embedded, temb, angles, context_ids)

        e = self.norm_out_2(self.norm_out_1(F.silu(embedded.to(torch.float32))))
        shift, scale = (e + temb[..., : 2 * dim].to(torch.float32)).chunk(2, dim=-1)
        if shift.dim() == 2:
            shift, scale = shift[:, None], scale[:, None]
        x = (layer_norm(x, torch.float32) * (1.0 + scale) + shift).to(dtype)
        out = self.proj_out(x).reshape(batch, grid[0], grid[1], grid[2], ph, pw, pt, cfg.out_channels)
        out = out.permute(0, 1, 6, 2, 4, 3, 5, 7)  # (B, T', pt, H', ph, W', pw, C)
        return out.reshape(batch, t_in, h_in, w_in, cfg.out_channels).to(torch.float32)
