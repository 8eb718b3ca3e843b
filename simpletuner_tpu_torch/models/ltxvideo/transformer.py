"""LTX-Video DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/ltxvideo/transformer.py`` (diffusers'
``LTXVideoTransformer3DModel``): (1, 1, 1)-patch tokens straight from the
128-channel causal-VAE latents through ``patch_in``, the caption MLP
(``caption_in_1``, tanh-gelu, ``caption_in_2``), adaLN-single time
conditioning (``time_in`` on the 256-wide sinusoid, ``time_proj`` to one
(6, dim) modulation plus each block's ``scale_shift_table``), blocks of
[scale-free RMSNorm self-attention with LTX's rotary over the flattened inner
dim and affine q / k RMSNorms across the heads] -> [cross-attention on the
*raw* stream, qk-normed, ungated] -> [tanh-gelu feed-forward of 4 x dim], and
a final (2, dim) table over the *embedded* timestep.  Submodules keep the JAX
names (``block_{i}.attn1_q``, ``block_{i}.attn2_norm_k``,
``time_in.in_layer``), so the bridge maps a Flax tree by name.

Per-frame timesteps: ``timesteps`` (B, T) gives every latent frame its own
modulation, (B, T, 6, dim) in the blocks and (B, T, 2, dim) in the head; the
frame's tokens share it.  They broadcast over the frame's H x W tokens where
the JAX module repeats them per token: the same values, elementwise.

Mirrored as the JAX module computes them: the RoPE tables are made on the
host in float64 (``ltx_rope``, once per latent grid and device, so a captured
step reads them), cast to f32, and applied in f32 to the normed q and k in
interleaved pairs; the modulations are the tables plus the conditioning in
f32, cast to the compute dtype; the RMSNorms have eps 1e-6 and compute in
f32, the final LayerNorm has no affine.  Both attentions run unmasked through
``ops.dot_product_attention`` (on the card the Hopper flash kernels: head dim
64 at 2B, 128 at 13B; the cross-attention against every T5 token, pads
included).  Remat (``gradient_checkpointing``) checkpoints every block whole,
as ``nn.remat`` wraps ``LTXBlock``.
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
from ..layers import LoRADense, MLPEmbedder, RMSNorm, layer_norm, modulate, timestep_embedding


@dataclasses.dataclass(frozen=True)
class LTXConfig:
    in_channels: int = 128
    out_channels: int = 128
    patch: Tuple[int, int, int] = (1, 1, 1)  # latent cells are already 32x32x8 px
    hidden_size: int = 2048
    depth: int = 28
    num_heads: int = 32
    head_dim: int = 64
    text_dim: int = 4096  # caption_channels (T5-XXL)
    cross_dim: int = 2048  # cross_attention_dim
    ffn_ratio: float = 4.0
    rope_theta: float = 10000.0
    base_num_frames: int = 20
    base_height: int = 2048
    base_width: int = 2048
    frame_rate: float = 25.0

    @property
    def ffn_hidden(self) -> int:
        return int(self.hidden_size * self.ffn_ratio)

    @classmethod
    def tiny(cls) -> "LTXConfig":
        return cls(in_channels=8, out_channels=8, hidden_size=64, depth=2, num_heads=2, head_dim=32, text_dim=32,
                   cross_dim=64)

    @classmethod
    def b13(cls) -> "LTXConfig":
        """The 13B flavour as the JAX family builds it: 48 blocks of 32 x 128, cross 4096."""
        return cls(hidden_size=4096, depth=48, num_heads=32, head_dim=128, cross_dim=4096)


def ltx_rope(cfg: LTXConfig, t: int, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(seq, inner) f32 cos / sin tables, ``LTXVideoRotaryPosEmbed``: inner // 6
    log-spaced frequencies per (t, h, w) axis over the coordinates scaled by
    (8 / frame_rate, 32, 32) and the base sizes, mapped to 2 x coord - 1,
    each value repeated for its interleaved pair; the ``inner % 6`` leading
    entries take cos 1 and sin 0.  float64 on the host, as the JAX function."""
    inner = cfg.num_heads * cfg.head_dim
    scale = (1.0 / (cfg.frame_rate / 8.0), 32.0, 32.0)
    grid_f, grid_h, grid_w = np.meshgrid(np.arange(t, dtype=np.float64), np.arange(h, dtype=np.float64),
                                         np.arange(w, dtype=np.float64), indexing="ij")
    grid = np.stack([grid_f * scale[0] * 1.0 / cfg.base_num_frames, grid_h * scale[1] * 1.0 / cfg.base_height,
                     grid_w * scale[2] * 1.0 / cfg.base_width], axis=0).reshape(3, -1).T  # (seq, 3)
    n_freqs = inner // 6
    freqs = cfg.rope_theta ** np.linspace(math.log(1.0, cfg.rope_theta), math.log(cfg.rope_theta, cfg.rope_theta),
                                          n_freqs)
    freqs = freqs * math.pi / 2.0
    args = freqs[None, None, :] * (grid[:, :, None] * 2.0 - 1.0)  # (seq, 3, n_freqs)
    args = np.swapaxes(args, 1, 2).reshape(grid.shape[0], -1)
    cos = np.repeat(np.cos(args), 2, axis=-1)
    sin = np.repeat(np.sin(args), 2, axis=-1)
    pad = inner % 6
    if pad:
        cos = np.concatenate([np.ones_like(cos[:, :pad]), cos], axis=-1)
        sin = np.concatenate([np.zeros_like(sin[:, :pad]), sin], axis=-1)
    return cos.astype(np.float32), sin.astype(np.float32)


def apply_ltx_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x`` (B, S, inner) rotated in interleaved pairs (x0, x1) -> (-x1, x0)
    by the (S, inner) tables, in f32, returned in ``x``'s dtype."""
    xf = x.to(torch.float32)
    rotated = torch.stack([-xf[..., 1::2], xf[..., 0::2]], dim=-1).reshape(xf.shape)
    return (xf * cos + rotated * sin).to(x.dtype)


def rms_norm(x: torch.Tensor, dtype: torch.dtype, eps: float = 1e-6) -> torch.Tensor:
    """``RMSNorm(use_scale=False)``: f32 statistics, output in ``dtype``."""
    x_f = x.to(torch.float32)
    return (x_f * torch.rsqrt(x_f.square().mean(dim=-1, keepdim=True) + eps)).to(dtype)


def _reset_table(table: torch.Tensor, dim: int, generator: Optional[torch.Generator]) -> None:
    # flax normal(stddev=1/sqrt(dim))
    table.normal_(0.0, dim ** -0.5, generator=generator)


def _per_token(x: torch.Tensor, frames: int) -> torch.Tensor:
    """(B, S, dim) as (B, frames, S / frames, dim): a frame's tokens in a row."""
    return x.reshape(x.shape[0], frames, -1, x.shape[-1])


class LTXBlock(nn.Module):
    """``LTXVideoTransformerBlock``: ``x`` (B, S, dim), ``context`` (B, L, dim)
    projected captions, ``t6`` (B, 6, dim) or per frame (B, T, 6, dim), and the
    (S, inner) RoPE tables."""

    def __init__(self, config: LTXConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, inner = config.hidden_size, config.num_heads * config.head_dim
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.scale_shift_table = nn.Parameter(torch.empty(6, dim, dtype=torch.float32))
        for attn in ("attn1", "attn2"):
            for proj in ("q", "k", "v"):
                self.add_module(f"{attn}_{proj}", LoRADense(dim, inner, **lora))
            self.add_module(f"{attn}_norm_q", RMSNorm(inner, dtype=dtype))
            self.add_module(f"{attn}_norm_k", RMSNorm(inner, dtype=dtype))
            self.add_module(f"{attn}_proj", LoRADense(inner, dim, **lora))
        self.ff_in = LoRADense(dim, config.ffn_hidden, **lora)
        self.ff_out = LoRADense(config.ffn_hidden, dim, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_table(self.scale_shift_table, self.config.hidden_size, generator)

    def forward(self, x: torch.Tensor, context: torch.Tensor, t6: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        batch, seq = x.shape[:2]
        heads = (batch, seq, cfg.num_heads, cfg.head_dim)
        if t6.dim() == 4:
            # per frame: each frame's mods over its tokens, (B, T, 1, dim) against (B, T, HW, dim)
            frames = t6.shape[1]
            mods = (self.scale_shift_table[None, None] + t6.to(torch.float32)).to(dtype)
            mods = [mods[:, :, i, None] for i in range(6)]

            def apply(fn, value):
                return fn(_per_token(value, frames)).reshape(value.shape)
        else:
            mods = (self.scale_shift_table[None] + t6.to(torch.float32)).to(dtype)
            mods = [mods[:, i][:, None] for i in range(6)]

            def apply(fn, value):
                return fn(value)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods

        # self-attention: rope over the flattened inner dim, qk RMSNorm across the heads
        x_n = apply(lambda v: modulate(v, shift_msa, scale_msa), rms_norm(x, dtype))
        q = apply_ltx_rope(self.attn1_norm_q(self.attn1_q(x_n)), cos, sin)
        k = apply_ltx_rope(self.attn1_norm_k(self.attn1_k(x_n)), cos, sin)
        v = self.attn1_v(x_n)
        attn = dot_product_attention(q.reshape(heads), k.reshape(heads), v.reshape(heads)).reshape(batch, seq, -1)
        out = self.attn1_proj(attn)
        x = x + apply(lambda o: gate_msa * o, out)

        # cross-attention on the raw stream (qk-normed, ungated)
        ctx = (batch, context.shape[1], cfg.num_heads, cfg.head_dim)
        q = self.attn2_norm_q(self.attn2_q(x)).reshape(heads)
        k = self.attn2_norm_k(self.attn2_k(context)).reshape(ctx)
        v = self.attn2_v(context).reshape(ctx)
        x = x + self.attn2_proj(dot_product_attention(q, k, v).reshape(batch, seq, -1))

        # tanh-gelu feed-forward
        x_f = apply(lambda v: modulate(v, shift_mlp, scale_mlp), rms_norm(x, dtype))
        out = self.ff_out(F.gelu(self.ff_in(x_f), approximate="tanh"))
        return x + apply(lambda o: gate_mlp * o, out)


class LTXTransformer(nn.Module):
    """The LTX-Video DiT.  ``latents`` (B, T, H, W, C) noisy latents,
    ``timesteps`` (B,) sigmas in [0, 1] or (B, T) per latent frame,
    ``context`` (B, L, text_dim) T5 features; returns the (B, T, H, W, out)
    flow prediction in f32."""

    def __init__(self, config: LTXConfig = LTXConfig(), dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora", remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim = config.hidden_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.patch_in = LoRADense(config.in_channels, dim, **lora)
        self.caption_in_1 = LoRADense(config.text_dim, dim, **lora)
        self.caption_in_2 = LoRADense(dim, dim, **lora)
        self.time_in = MLPEmbedder(256, dim, dtype=dtype)
        self.time_proj = LoRADense(dim, 6 * dim, dtype=dtype)
        for layer in range(config.depth):
            self.add_module(f"block_{layer}", LTXBlock(config, **lora))
        self.final_scale_shift_table = nn.Parameter(torch.empty(2, dim, dtype=torch.float32))
        self.final_proj = LoRADense(dim, config.out_channels, dtype=dtype)
        self._rope: Dict[Tuple[int, int, int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_table(self.final_scale_shift_table, self.config.hidden_size, generator)

    def rope(self, t: int, h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (seq, inner) f32 tables on ``device``, made on the host the
        first time a latent grid is seen (an eager or warm-up step; a captured
        step reads them), as the JAX module makes them constants of its
        traced program."""
        key = (t, h, w, torch.device(device))
        if key not in self._rope:
            self._rope[key] = tuple(torch.from_numpy(a).to(device) for a in ltx_rope(self.config, t, h, w))
        return self._rope[key]

    def _run(self, block: nn.Module, *args):
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        dim = cfg.hidden_size
        batch, frames, height, width, channels = latents.shape

        x = self.patch_in(latents.reshape(batch, frames * height * width, channels))
        txt = self.caption_in_2(F.gelu(self.caption_in_1(context), approximate="tanh"))
        per_frame = timesteps.dim() == 2
        t_emb = self.time_in(timestep_embedding(timesteps.reshape(-1), 256).to(dtype))  # (B,) or (B * T,)
        t6 = self.time_proj(F.silu(t_emb))
        if per_frame:
            t6, t_emb = t6.reshape(batch, frames, 6, dim), t_emb.reshape(batch, frames, dim)
        else:
            t6 = t6.reshape(-1, 6, dim)
        cos, sin = self.rope(frames, height, width, latents.device)

        for layer in range(cfg.depth):
            x = self._run(getattr(self, f"block_{layer}"), x, txt, t6, cos, sin)

        # the head: the (2, dim) table plus the embedded timestep, per frame or per sample
        final = (self.final_scale_shift_table + t_emb.to(torch.float32)[..., None, :]).to(dtype)
        x = layer_norm(x, dtype)
        if per_frame:
            x = modulate(_per_token(x, frames), final[:, :, None, 0], final[:, :, None, 1]).reshape(x.shape)
        else:
            x = modulate(x, final[:, 0], final[:, 1])
        x = self.final_proj(x)
        return x.reshape(batch, frames, height, width, cfg.out_channels).to(torch.float32)
