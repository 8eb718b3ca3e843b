"""LongCat-Video single-stream video DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/longcat_video/transformer.py``
(``LongCatVideoTransformer3DModel``, meituan's 13.6B): the (1, 2, 2) Conv3d
patch embed (``x_embedder``, computed as one dense over the (pt, ph, pw, C)
patch features); the cos-first 256 sinusoid of the sigma x 1000 timesteps
through the f32 SiLU MLP ``t_in`` / ``t_out`` to 512 features, broadcast over
the frames; the tanh-gelu caption MLP (``y_in_1``, ``y_in_2``); blocks of a
framewise f32 6-way AdaLN of ``silu(t_frames)`` (``adaLN``), the fused biased
``qkv`` with per-head RMS q/k norms (eps 1e-6, the normalised value cast to
the input's dtype before the scale) and the 3-D RoPE, a framewise gate on the
self-attention, the affine LayerNorm before the cross-attention (``crs_q`` /
``crs_kv`` with their per-head RMS norms and the T5 key mask) whose residual
is ungated, and the SwiGLU FFN (``ffn_w1``, ``ffn_w3``, ``ffn_w2``, inner
2/3 of 4 x width rounded up to a multiple of 256); the framewise final AdaLN
(``shift, scale`` in that order), ``final_linear`` and the unpatchify, which
splits the features as (pt, ph, pw, C).

Mirrored as the JAX module computes it: the FFN's residual base is the
MODULATED tensor (``x = modulate(x); x = x + gate * ffn(x)``); the RoPE
tables (per-axis dims hd - 4 (hd // 6), 2 (hd // 6), 2 (hd // 6), linspace
positions, angles duplicated pairwise, interleaved-pair rotation in f32) are
made on the host in float64 once per latent grid and device, so a captured
step reads them and makes none.  Both attentions go through
:func:`dot_product_attention` (the Hopper flash kernels on the card; the JAX
module computes dense f32 softmaxes): the self-attention unmasked over every
video token, the cross-attention with query ids 1 and key ids 1 / -1 from the
T5 mask.  A caption with no valid token gives 0 there where the JAX softmax
over -inf gives NaN (ROADMAP Queue 3).  Submodules keep the JAX names
(``block_{i}.qkv``, ``block_{i}.pre_crs_scale``); remat checkpoints every
block whole, as ``nn.remat`` wraps ``LongCatBlock``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import dot_product_attention, key_mask_segments
from ..layers import LoRADense, layer_norm, timestep_embedding


@dataclasses.dataclass(frozen=True)
class LongCatVideoConfig:
    in_channels: int = 16
    out_channels: int = 16
    hidden_size: int = 4096
    depth: int = 48
    num_heads: int = 32
    caption_channels: int = 4096
    mlp_ratio: float = 4.0
    adaln_tembed_dim: int = 512
    frequency_embedding_size: int = 256
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    multiple_of: int = 256

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_hidden(self) -> int:
        hidden = int(2 * int(self.hidden_size * self.mlp_ratio) / 3)
        return self.multiple_of * ((hidden + self.multiple_of - 1) // self.multiple_of)

    @classmethod
    def tiny(cls) -> "LongCatVideoConfig":
        return cls(
            in_channels=4, out_channels=4, hidden_size=24, depth=2, num_heads=2,
            caption_channels=32, mlp_ratio=2.0, adaln_tembed_dim=16,
            frequency_embedding_size=32, multiple_of=8,
        )


def longcat_rope(config: LongCatVideoConfig, grid: Tuple[int, int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(S, head_dim) f32 cos / sin of the per-axis angles over the (t, h, w)
    grid, each duplicated pairwise; float64 on the host, as the JAX function."""
    hd = config.head_dim
    dim_t = hd - 4 * (hd // 6)
    dim_h = dim_w = 2 * (hd // 6)
    t, h, w = grid

    def axis(n, dim):
        freqs = 1.0 / 10000.0 ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim)
        return np.repeat(np.outer(np.linspace(0, n - 1, n), freqs), 2, axis=-1)

    at = axis(t, dim_t)[:, None, None, :]
    ah = axis(h, dim_h)[None, :, None, :]
    aw = axis(w, dim_w)[None, None, :, :]
    full = np.concatenate([np.broadcast_to(a, (t, h, w, a.shape[-1])) for a in (at, ah, aw)],
                          axis=-1).reshape(t * h * w, hd)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


def apply_longcat_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x`` (B, S, H, D) rotated in interleaved pairs (x0, x1) -> (-x1, x0)
    by the (S, D) tables, in f32, back to ``x``'s dtype."""
    x_f = x.to(torch.float32)
    rotated = torch.stack([-x_f[..., 1::2], x_f[..., 0::2]], dim=-1).reshape(x.shape)
    return (x_f * cos[None, :, None] + rotated * sin[None, :, None]).to(x.dtype)


def rms_cast(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS over the last axis in f32, the normalised value cast to ``x``'s
    dtype before the scale (cast to it too) multiplies it."""
    x_f = x.to(torch.float32)
    y = x_f * torch.rsqrt(x_f.square().mean(dim=-1, keepdim=True) + eps)
    return y.to(x.dtype) * scale.to(x.dtype)


def _framewise(x: torch.Tensor, frames: int) -> torch.Tensor:
    """(B, S, dim) as (B, frames, S / frames, dim)."""
    return x.reshape(x.shape[0], frames, -1, x.shape[-1])


class LongCatBlock(nn.Module):
    """One block: ``x`` (B, S, dim), ``context`` (B, L, dim) projected text,
    ``t_frames`` (B, T, adaln_tembed_dim), the RoPE (cos, sin) and the
    cross-attention's query and key ids (None: unmasked)."""

    def __init__(self, config: LongCatVideoConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, hd, ffn = config.hidden_size, config.head_dim, config.ffn_hidden
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.adaLN = LoRADense(config.adaln_tembed_dim, 6 * dim, dtype=torch.float32)
        self.qkv = LoRADense(dim, 3 * dim, **lora)
        self.q_norm = nn.Parameter(torch.empty(hd, dtype=torch.float32))
        self.k_norm = nn.Parameter(torch.empty(hd, dtype=torch.float32))
        self.attn_proj = LoRADense(dim, dim, **lora)
        self.pre_crs_scale = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.pre_crs_bias = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.crs_q = LoRADense(dim, dim, **lora)
        self.crs_kv = LoRADense(dim, 2 * dim, **lora)
        self.crs_q_norm = nn.Parameter(torch.empty(hd, dtype=torch.float32))
        self.crs_k_norm = nn.Parameter(torch.empty(hd, dtype=torch.float32))
        self.crs_proj = LoRADense(dim, dim, **lora)
        self.ffn_w1 = LoRADense(dim, ffn, use_bias=False, **lora)
        self.ffn_w3 = LoRADense(dim, ffn, use_bias=False, **lora)
        self.ffn_w2 = LoRADense(ffn, dim, use_bias=False, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for param in (self.q_norm, self.k_norm, self.pre_crs_scale, self.crs_q_norm, self.crs_k_norm):
            param.fill_(1.0)
        self.pre_crs_bias.zero_()

    def forward(self, x: torch.Tensor, context: torch.Tensor, t_frames: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, q_ids: Optional[torch.Tensor], key_ids: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.config
        dim, heads, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        batch, seq = x.shape[:2]
        frames = t_frames.shape[1]
        mod = self.adaLN(F.silu(t_frames.to(torch.float32))).reshape(batch, frames, 1, 6, dim).unbind(dim=3)
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = mod

        def modulate(a, shift, scale):
            return (layer_norm(_framewise(a, frames), torch.float32) * (scale + 1.0) + shift).reshape(batch, seq, dim).to(a.dtype)

        def gated(a, gate, y):
            return (a.to(torch.float32) + (gate * _framewise(y, frames).to(torch.float32)).reshape(
                batch, seq, dim)).to(a.dtype)

        # self-attention (fused biased qkv, per-head RMS, 3-D rope), framewise gate
        qkv = self.qkv(modulate(x, sh_msa, sc_msa)).reshape(batch, seq, 3, heads, hd)
        q = apply_longcat_rope(rms_cast(qkv[:, :, 0], self.q_norm), cos, sin)
        k = apply_longcat_rope(rms_cast(qkv[:, :, 1], self.k_norm), cos, sin)
        attn = dot_product_attention(q, k, qkv[:, :, 2]).reshape(batch, seq, dim).to(self.dtype)
        x = gated(x, g_msa, self.attn_proj(attn))

        # cross-attention behind the affine LayerNorm (ungated residual)
        x_n = (layer_norm(x, torch.float32) * self.pre_crs_scale + self.pre_crs_bias).to(x.dtype)
        q = rms_cast(self.crs_q(x_n).reshape(batch, seq, heads, hd), self.crs_q_norm)
        kv = self.crs_kv(context.to(self.dtype)).reshape(batch, context.shape[1], 2, heads, hd)
        ck = rms_cast(kv[:, :, 0], self.crs_k_norm)
        cattn = dot_product_attention(q, ck, kv[:, :, 1], q_segment_ids=q_ids, kv_segment_ids=key_ids)
        x = x + self.crs_proj(cattn.reshape(batch, seq, dim).to(self.dtype))

        # SwiGLU FFN whose residual base is the modulated tensor
        x = modulate(x, sh_mlp, sc_mlp)
        return gated(x, g_mlp, self.ffn_w2(F.silu(self.ffn_w1(x)) * self.ffn_w3(x)))


class LongCatVideoTransformer(nn.Module):
    """The LongCat-Video DiT.  ``latents`` (B, T, H, W, C) noisy video
    latents, ``timesteps`` (B,) at scheduler scale (sigma x 1000),
    ``context`` (B, L, caption_channels) T5 features, ``context_mask`` (B, L)
    1 = valid (None: every key valid); returns (B, T, H, W, out_channels) f32."""

    def __init__(self, config: LongCatVideoConfig = LongCatVideoConfig(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim, temb = config.hidden_size, config.adaln_tembed_dim
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.x_embedder = nn.Conv3d(config.in_channels, dim, config.patch_size, stride=config.patch_size,
                                    dtype=dtype)
        self.t_in = LoRADense(config.frequency_embedding_size, temb, dtype=torch.float32)
        self.t_out = LoRADense(temb, temb, dtype=torch.float32)
        self.y_in_1 = LoRADense(config.caption_channels, dim, dtype=dtype)
        self.y_in_2 = LoRADense(dim, dim, dtype=dtype)
        for i in range(config.depth):
            self.add_module(f"block_{i}", LongCatBlock(config, dtype, **lora))
        self.final_adaLN = LoRADense(temb, 2 * dim, dtype=torch.float32)
        self.final_linear = LoRADense(dim, int(np.prod(config.patch_size)) * config.out_channels, dtype=dtype,
                                      **lora)
        self._rope: Dict[Tuple[int, int, int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(self, grid: Tuple[int, int, int], device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (S, head_dim) tables of ``grid`` on ``device``, made there the first time."""
        key = (*grid, device)
        if key not in self._rope:
            self._rope[key] = tuple(torch.from_numpy(a).to(device) for a in longcat_rope(self.config, grid))
        return self._rope[key]

    def _run(self, name: str, *args):
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        dim = cfg.hidden_size
        batch, frames, height, width, channels = latents.shape
        pt, ph, pw = cfg.patch_size
        grid = (frames // pt, height // ph, width // pw)
        seq = grid[0] * grid[1] * grid[2]

        # the (1, 2, 2) conv as one dense over (pt, ph, pw, C)-ordered patches
        x = latents.to(dtype).reshape(batch, grid[0], pt, grid[1], ph, grid[2], pw, channels)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(batch, seq, pt * ph * pw * channels)
        weight = self.x_embedder.weight.permute(0, 2, 3, 4, 1).reshape(dim, -1)
        x = F.linear(x, weight, self.x_embedder.bias)

        # time: cos-first sinusoid of the scheduler-scale steps, f32 SiLU MLP, framewise
        t_freq = timestep_embedding(timesteps, cfg.frequency_embedding_size, time_factor=1.0)
        t_emb = self.t_out(F.silu(self.t_in(t_freq)))
        t_frames = t_emb[:, None].expand(batch, grid[0], cfg.adaln_tembed_dim)

        ctx = self.y_in_2(F.gelu(self.y_in_1(context.to(dtype)), approximate="tanh"))
        key_ids = key_mask_segments(context_mask)
        q_ids = None if key_ids is None else torch.ones((batch, seq), dtype=torch.int32, device=x.device)
        cos, sin = self.rope(grid, x.device)

        for i in range(cfg.depth):
            x = self._run(f"block_{i}", x, ctx, t_frames, cos, sin, q_ids, key_ids)

        # final: framewise 2-way AdaLN (shift, scale) and the linear
        shift, scale = self.final_adaLN(F.silu(t_frames.to(torch.float32))).reshape(
            batch, grid[0], 1, 2, dim).unbind(dim=3)
        x = (layer_norm(_framewise(x, grid[0]), torch.float32) * (scale + 1.0) + shift).reshape(batch, seq, dim).to(dtype)
        out = self.final_linear(x)

        # unpatchify: the features split as (pt, ph, pw, C)
        out = out.reshape(batch, *grid, pt, ph, pw, cfg.out_channels).permute(0, 1, 4, 2, 5, 3, 6, 7)
        return out.reshape(batch, frames, height, width, cfg.out_channels).to(torch.float32)
