"""Kandinsky 5.0 3-D DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/kandinsky5/transformer.py`` (the
ai-forever ``Kandinsky5Transformer3DModel``, T2V / T2I "lite"): an f32
cos-first sinusoid of the timestep over ``model_dim / 2`` frequencies
through the f32 SiLU MLP ``time_in`` / ``time_out``; the pooled CLIP state
through ``pooled_in`` and an affine f32 LayerNorm (eps 1e-5) added to it;
the Qwen2.5-VL states through ``text_in`` and the affine ``text_norm``; the
(1, 2, 2) patchify with features in [p_t, p_h, p_w, c] order into
``visual_in``.  Text blocks (six-way modulation: self-attention with 1-D
rope, feed-forward) run first; then the visual blocks (nine-way:
self-attention with 3-D rope over the flattened (t, h, w) grid, each axis's
angles divided by its ``rope_scale``, cross-attention over the text stream
without rope, feed-forward); last the two-way out modulation and
``out_proj``, unpatchified from the [c, p_t, p_h, p_w] order.  Submodules
keep the JAX names (``visual_block_{i}.self_attention.to_query``,
``text_block_{i}.text_modulation.out_layer``), so the bridge maps a Flax
tree by name.

Mirrored as the JAX module computes them: every modulation head is a
zero-initialised f32 linear off ``silu(t)`` in f32; the LayerNorms before
each branch are parameter-free, in f32 (eps 1e-5), and the modulate and the
gated residual add run in f32 and round to the stream's dtype; attention has
biased projections, per-head affine RMS q/k norms (eps 1e-6, f32) and the
pairwise rope on consecutive feature pairs in f32; the feed-forward is
bias-free with the exact gelu.  Every attention runs unmasked through
``ops.dot_product_attention`` (on the card the Hopper flash kernels at the
head dim 64 of the published size).  The timestep may be per sample (B,)
or tokenwise (B, S_vis): then the visual stream is modulated per token and
the text stream by the token mean.  The rope tables and the sinusoid's
frequencies are made in float64 on the host and rounded to f32, once per
grid and device.  Remat (``gradient_checkpointing``) checkpoints every
block whole, as ``nn.remat`` wraps the blocks.  The JAX module's per-block
``intermediates`` tap (CREPA) is not ported (ROADMAP Queue 1 item 4h).
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

from ...ops import dot_product_attention
from ..layers import LoRADense


@dataclasses.dataclass(frozen=True)
class Kandinsky5Config:
    in_visual_dim: int = 4
    out_visual_dim: int = 4
    in_text_dim: int = 3584  # Qwen2.5-VL hidden
    in_text_dim2: int = 768  # CLIP pooled
    time_dim: int = 512
    model_dim: int = 2048
    ff_dim: int = 5120
    num_text_blocks: int = 2
    num_visual_blocks: int = 32
    axes_dims: Tuple[int, int, int] = (16, 24, 24)
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    visual_cond: bool = False  # I2V: input carries [latent, cond, mask]
    rope_scale: Tuple[float, float, float] = (1.0, 2.0, 2.0)

    @property
    def head_dim(self) -> int:
        return sum(self.axes_dims)

    @property
    def num_heads(self) -> int:
        return self.model_dim // self.head_dim

    @property
    def visual_embed_dim(self) -> int:
        return 2 * self.in_visual_dim + 1 if self.visual_cond else self.in_visual_dim

    @classmethod
    def tiny(cls) -> "Kandinsky5Config":
        return cls(in_text_dim=24, in_text_dim2=12, time_dim=16, model_dim=32, ff_dim=64, num_text_blocks=1,
                   num_visual_blocks=2, axes_dims=(4, 6, 6))


def _get_freqs(dim: int) -> np.ndarray:
    return np.exp(-math.log(10000.0) * np.arange(dim, dtype=np.float64) / dim)


def k5_rope_1d(positions: np.ndarray, dim: int) -> np.ndarray:
    """1-D text rope angles (S, dim / 2), float64 rounded to f32."""
    return np.outer(positions, _get_freqs(dim // 2)).astype(np.float32)


def k5_rope_3d(grid: Tuple[int, int, int], axes_dims: Tuple[int, int, int],
               scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> np.ndarray:
    """3-D rope angles of the flattened (t, h, w) grid, (t * h * w, head_dim / 2):
    the per-axis tables divided by the axis's ``scale``, concatenated."""
    t, h, w = grid
    t_args = np.outer(np.arange(t), _get_freqs(axes_dims[0] // 2)) / scale[0]
    h_args = np.outer(np.arange(h), _get_freqs(axes_dims[1] // 2)) / scale[1]
    w_args = np.outer(np.arange(w), _get_freqs(axes_dims[2] // 2)) / scale[2]
    full = np.concatenate([np.tile(t_args[:, None, None, :], (1, h, w, 1)),
                           np.tile(h_args[None, :, None, :], (t, 1, w, 1)),
                           np.tile(w_args[None, None, :, :], (t, h, 1, 1))], axis=-1)
    return full.reshape(t * h * w, -1).astype(np.float32)


def k5_apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate consecutive feature pairs of (B, S, H, D) ``x`` by (S, D / 2) ``angles``, in f32."""
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x_f = x.to(torch.float32)
    x0, x1 = x_f[..., 0::2], x_f[..., 1::2]
    return torch.stack([cos * x0 - sin * x1, sin * x0 + cos * x1], dim=-1).reshape(x.shape).to(x.dtype)


def _ln(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free LayerNorm in f32 (eps 1e-5)."""
    return F.layer_norm(x.to(torch.float32), (x.shape[-1],), eps=1e-5)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 LN-modulate; shift / scale (B, D) or per token (B, S, D)."""
    if shift.dim() == 2:
        shift, scale = shift[:, None], scale[:, None]
    return (_ln(x) * (scale + 1.0) + shift).to(x.dtype)


def _gated_add(x: torch.Tensor, gate: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    if gate.dim() == 2:
        gate = gate[:, None]
    return (x.to(torch.float32) + gate * out.to(torch.float32)).to(x.dtype)


class K5Modulation(nn.Module):
    """Zero-initialised f32 modulation head off ``silu(t)`` (no adapter)."""

    def __init__(self, num_params: int, config: Kandinsky5Config) -> None:
        super().__init__()
        self.out_layer = LoRADense(config.time_dim, num_params * config.model_dim, dtype=torch.float32,
                                   zero_init=True)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.out_layer(F.silu(t.to(torch.float32)))


class K5Attention(nn.Module):
    """Biased q / k / v, per-head affine RMS q / k norms, the optional
    pairwise rope, the op (unmasked) and the biased ``out_layer``."""

    def __init__(self, config: Kandinsky5Config, **lora) -> None:
        super().__init__()
        self.config = config
        dim = config.model_dim
        for name in ("to_query", "to_key", "to_value", "out_layer"):
            self.add_module(name, LoRADense(dim, dim, **lora))
        self.query_norm = nn.Parameter(torch.empty(config.head_dim, dtype=torch.float32))
        self.key_norm = nn.Parameter(torch.empty(config.head_dim, dtype=torch.float32))

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.query_norm.fill_(1.0)
        self.key_norm.fill_(1.0)

    @staticmethod
    def _rms(a: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        a_f = a.to(torch.float32)
        y = a_f * torch.rsqrt(a_f.square().mean(dim=-1, keepdim=True) + 1e-6)
        return (y * scale).to(a.dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                angles: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        ctx = x if context is None else context
        batch, s_q, s_kv = x.shape[0], x.shape[1], ctx.shape[1]
        q = self.to_query(x).reshape(batch, s_q, cfg.num_heads, cfg.head_dim)
        k = self.to_key(ctx).reshape(batch, s_kv, cfg.num_heads, cfg.head_dim)
        v = self.to_value(ctx).reshape(batch, s_kv, cfg.num_heads, cfg.head_dim)
        q, k = self._rms(q, self.query_norm), self._rms(k, self.key_norm)
        if angles is not None:
            q, k = k5_apply_rope(q, angles), k5_apply_rope(k, angles)
        return self.out_layer(dot_product_attention(q, k, v).reshape(batch, s_q, cfg.model_dim))


class K5FeedForward(nn.Module):
    """Bias-free Linear - exact GELU - Linear."""

    def __init__(self, config: Kandinsky5Config, **lora) -> None:
        super().__init__()
        self.in_layer = LoRADense(config.model_dim, config.ff_dim, use_bias=False, **lora)
        self.out_layer = LoRADense(config.ff_dim, config.model_dim, use_bias=False, **lora)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_layer(F.gelu(self.in_layer(x)))


class K5EncoderBlock(nn.Module):
    """Text block: six-way modulation, self-attention (1-D rope), feed-forward."""

    def __init__(self, config: Kandinsky5Config, **lora) -> None:
        super().__init__()
        self.text_modulation = K5Modulation(6, config)
        self.self_attention = K5Attention(config, **lora)
        self.feed_forward = K5FeedForward(config, **lora)

    def forward(self, x: torch.Tensor, t: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
        shift, scale, gate, ff_shift, ff_scale, ff_gate = self.text_modulation(t).chunk(6, dim=-1)
        x = _gated_add(x, gate, self.self_attention(_modulate(x, shift, scale), angles=angles))
        return _gated_add(x, ff_gate, self.feed_forward(_modulate(x, ff_shift, ff_scale)))


class K5DecoderBlock(nn.Module):
    """Visual block: nine-way modulation, self-attention (3-D rope),
    cross-attention over the text stream (no rope), feed-forward."""

    def __init__(self, config: Kandinsky5Config, **lora) -> None:
        super().__init__()
        self.visual_modulation = K5Modulation(9, config)
        self.self_attention = K5Attention(config, **lora)
        self.cross_attention = K5Attention(config, **lora)
        self.feed_forward = K5FeedForward(config, **lora)

    def forward(self, x: torch.Tensor, text: torch.Tensor, t: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
        mods = self.visual_modulation(t).chunk(9, dim=-1)
        x = _gated_add(x, mods[2], self.self_attention(_modulate(x, mods[0], mods[1]), angles=angles))
        x = _gated_add(x, mods[5], self.cross_attention(_modulate(x, mods[3], mods[4]), context=text))
        return _gated_add(x, mods[8], self.feed_forward(_modulate(x, mods[6], mods[7])))


def k5_patchify(x: torch.Tensor, patch: Tuple[int, int, int]) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T / pt, H / ph, W / pw, pt * ph * pw * C), features in [p_t, p_h, p_w, c] order."""
    b, t, h, w, c = x.shape
    pt, ph, pw = patch
    x = x.reshape(b, t // pt, pt, h // ph, ph, w // pw, pw, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, t // pt, h // ph, w // pw, pt * ph * pw * c)


def k5_unpatchify(x: torch.Tensor, patch: Tuple[int, int, int], out_dim: int) -> torch.Tensor:
    """(B, T', H', W', prod(patch) * C) in the out layer's [c, p_t, p_h, p_w] order -> (B, T, H, W, C)."""
    b, t, h, w, _ = x.shape
    pt, ph, pw = patch
    x = x.reshape(b, t, h, w, out_dim, pt, ph, pw).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, t * pt, h * ph, w * pw, out_dim)


class Kandinsky5Transformer(nn.Module):
    """The Kandinsky 5.0 DiT.  ``latents`` (B, T, H, W, visual_embed_dim),
    ``text_embeds`` (B, S_txt, in_text_dim), ``pooled_embeds`` (B,
    in_text_dim2), ``timesteps`` (B,) or tokenwise (B, S_vis) at the
    scheduler's scale (sigma x 1000); returns (B, T, H, W, out_visual_dim) in f32."""

    def __init__(self, config: Kandinsky5Config = Kandinsky5Config(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim = config.model_dim
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.time_in = LoRADense(dim, config.time_dim, dtype=torch.float32)
        self.time_out = LoRADense(config.time_dim, config.time_dim, dtype=torch.float32)
        self.pooled_in = LoRADense(config.in_text_dim2, config.time_dim, dtype=dtype)
        self.pooled_norm = nn.LayerNorm(config.time_dim, eps=1e-5, dtype=torch.float32)
        self.text_in = LoRADense(config.in_text_dim, dim, dtype=dtype)
        self.text_norm = nn.LayerNorm(dim, eps=1e-5, dtype=torch.float32)
        self.visual_in = LoRADense(math.prod(config.patch_size) * config.visual_embed_dim, dim, **lora)
        for i in range(config.num_text_blocks):
            self.add_module(f"text_block_{i}", K5EncoderBlock(config, **lora))
        for i in range(config.num_visual_blocks):
            self.add_module(f"visual_block_{i}", K5DecoderBlock(config, **lora))
        self.out_modulation = K5Modulation(2, config)
        self.out_proj = LoRADense(dim, math.prod(config.patch_size) * config.out_visual_dim, **lora)
        self._tables: Dict[tuple, torch.Tensor] = {}

    def table(self, key: tuple, device: torch.device) -> torch.Tensor:
        """An f32 host table on ``device``, made once per key and device
        (before a captured step needs it): ("time",), ("text", S) or ("grid", t, h, w)."""
        cache_key = (*key, device)
        if cache_key not in self._tables:
            cfg = self.config
            if key[0] == "time":
                values = _get_freqs(cfg.model_dim // 2).astype(np.float32)
            elif key[0] == "text":
                values = k5_rope_1d(np.arange(key[1]), cfg.head_dim)
            else:
                values = k5_rope_3d(key[1:], cfg.axes_dims, cfg.rope_scale)
            self._tables[cache_key] = torch.from_numpy(values).to(device)
        return self._tables[cache_key]

    def _run(self, name: str, *args) -> torch.Tensor:
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, text_embeds: torch.Tensor, pooled_embeds: torch.Tensor,
                timesteps: torch.Tensor) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        batch, device = latents.shape[0], latents.device

        # the f32 sinusoid (cos first) through the f32 SiLU MLP
        args = timesteps.to(torch.float32).reshape(-1)[:, None] * self.table(("time",), device)[None]
        temb = self.time_out(F.silu(self.time_in(torch.cat([torch.cos(args), torch.sin(args)], dim=-1))))
        temb = temb.reshape(*timesteps.shape, cfg.time_dim)
        pooled = self.pooled_norm(self.pooled_in(pooled_embeds.to(dtype)).to(torch.float32))
        if temb.dim() == 2:
            text_time = visual_time = temb + pooled
        else:  # tokenwise (B, S_vis, time_dim): the text stream takes the token mean
            visual_time = temb + pooled[:, None]
            text_time = visual_time.mean(dim=1)

        text = self.text_norm(self.text_in(text_embeds.to(dtype)).to(torch.float32)).to(dtype)
        grid = k5_patchify(latents.to(dtype), cfg.patch_size)
        t_len, h_len, w_len = grid.shape[1:4]
        visual = self.visual_in(grid).reshape(batch, t_len * h_len * w_len, cfg.model_dim)
        text_angles = self.table(("text", text.shape[1]), device)
        visual_angles = self.table(("grid", t_len, h_len, w_len), device)

        for i in range(cfg.num_text_blocks):
            text = self._run(f"text_block_{i}", text, text_time, text_angles)
        for i in range(cfg.num_visual_blocks):
            visual = self._run(f"visual_block_{i}", visual, text, visual_time, visual_angles)

        shift, scale = self.out_modulation(visual_time).chunk(2, dim=-1)
        out = self.out_proj(_modulate(visual, shift, scale)).reshape(batch, t_len, h_len, w_len, -1)
        return k5_unpatchify(out, cfg.patch_size, cfg.out_visual_dim).to(torch.float32)
