"""Sana-Video linear-attention video DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/sanavideo/transformer.py``
(``SanaVideoTransformer3DModel``, Efficient-Large-Model's SANA-Video 2B): the
(1, 2, 2) Conv3d patch embed (``patch_embedding``, computed as one dense over
the (pt, ph, pw, C) patch features); AdaLayerNormSingle (the cos-first 256
sinusoid of sigma x 1000 through the f32 ``time_in`` / ``time_out`` /
``time_mod``, 6 x dim); the tanh-gelu caption MLP and its affine RMS across
the whole width; blocks of ReLU linear self-attention with RoPE, dense
cross-attention and the GLUMBTempConv FFN, each modulated by the block's
``scale_shift_table`` plus ``t6`` in f32, cast to the compute dtype; then the
output (2, dim) table plus the embedded timestep, ``proj_out`` and the
unpatchify, which splits the features as (pt, ph, pw, C), as the code (not
the docstring) of the JAX module does.

Mirrored as the JAX module computes it: the RoPE tables are built per axis
with dims (hd - 4 (hd // 6), 2 (hd // 6), 2 (hd // 6)) and split with the
other sizes (hd - 2 (hd // 3), hd // 3, hd // 3), so odd boundaries cut pairs
apart, and the rotation reads ``cos[0::2]`` and ``sin[1::2]``
(``sanavideo_rope``, float64 on the host once per latent grid and device, so
a captured step reads them and makes none); the linear attention applies
RoPE after the ReLU and takes its normaliser from the UNROTATED q and k; the
q / k norms are affine RMS over the whole inner width (eps 1e-5), before the
heads are split.  The linear attention is f32 products (no kernel); the
convolutions are ``torch.nn.functional`` ops.  The cross-attention goes
through :func:`dot_product_attention` (the Hopper flash kernels on the card,
head dim 112 zero-padded to 128): the JAX module's additive key bias (1 -
mask) x -10000 becomes key ids -1 with query ids 1, equal on every row with a
valid key (exp(-10000) is 0 in f32); with no valid key the JAX softmax is the
unmasked one (the bias shifts every logit alike) and the kernels give 0
(ROADMAP Queue 3).  Submodules keep the JAX names; remat checkpoints every
block whole, as ``nn.remat`` wraps ``SanaVideoBlock``.
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
from ..cosmos1.transformer import rms
from ..layers import LoRADense, layer_norm, timestep_embedding
from ..sana.transformer import depthwise, pointwise


@dataclasses.dataclass(frozen=True)
class SanaVideoConfig:
    in_channels: int = 16
    out_channels: int = 16
    num_heads: int = 20
    head_dim: int = 112
    num_layers: int = 20
    cross_heads: int = 20
    cross_head_dim: int = 112
    caption_channels: int = 2304
    mlp_ratio: float = 2.5
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    rope_max_seq_len: int = 1024
    norm_eps: float = 1e-6

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim

    @classmethod
    def tiny(cls) -> "SanaVideoConfig":
        # head_dim 12: the build dims (4, 4, 4) and split sizes (4, 4, 4) coincide
        return cls(
            in_channels=4, out_channels=4, num_heads=2, head_dim=12,
            num_layers=2, cross_heads=2, cross_head_dim=12, caption_channels=32,
            mlp_ratio=1.0, rope_max_seq_len=64,
        )


def sanavideo_rope(config: SanaVideoConfig, grid: Tuple[int, int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(S, head_dim) f32 cos / sin: per-axis pairwise-duplicated tables with
    dims (t_dim, h_dim, w_dim) concatenated, split with the other (thirds)
    sizes and tiled over the (t, h, w) grid; float64 on the host, as the JAX
    function."""
    hd = config.head_dim
    h_dim = w_dim = 2 * (hd // 6)
    t_dim = hd - h_dim - w_dim
    positions = np.arange(config.rope_max_seq_len, dtype=np.float64)
    tables = []
    for dim in (t_dim, h_dim, w_dim):
        ang = np.outer(positions, 1.0 / 10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        tables.append((np.repeat(np.cos(ang), 2, axis=1), np.repeat(np.sin(ang), 2, axis=1)))
    full_cos = np.concatenate([c for c, _ in tables], axis=1)
    full_sin = np.concatenate([s for _, s in tables], axis=1)

    bounds = np.cumsum([0, hd - 2 * (hd // 3), hd // 3, hd // 3])
    t, h, w = grid
    parts_cos, parts_sin = [], []
    for i, size in enumerate(grid):
        shape, reps = [1, 1, 1, bounds[i + 1] - bounds[i]], [t, h, w, 1]
        shape[i], reps[i] = size, 1
        parts_cos.append(np.tile(full_cos[:size, bounds[i]:bounds[i + 1]].reshape(shape), reps))
        parts_sin.append(np.tile(full_sin[:size, bounds[i]:bounds[i + 1]].reshape(shape), reps))
    cos = np.concatenate(parts_cos, axis=-1).reshape(t * h * w, hd)
    sin = np.concatenate(parts_sin, axis=-1).reshape(t * h * w, hd)
    return cos.astype(np.float32), sin.astype(np.float32)


def apply_sv_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x`` (B, S, H, D) rotated in interleaved pairs by ``cos[0::2]`` and
    ``sin[1::2]`` of the (S, D) tables, back to ``x``'s dtype."""
    c, s = cos[None, :, None, 0::2], sin[None, :, None, 1::2]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape).to(x.dtype)


def rope_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor,
                          sin: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) linear attention over ReLU'd f32 ``q`` and ``k``: the
    scores ``V^T K_rot`` applied to ``q_rot`` (both rotated by
    :func:`apply_sv_rope`) over a normaliser from the UNROTATED q and k
    (eps 1e-15)."""
    denom = torch.einsum("bhd,bshd->bsh", k.sum(dim=1), q) + 1e-15
    scores = torch.einsum("bshd,bshe->bhde", v, apply_sv_rope(k, cos, sin))
    return torch.einsum("bhde,bshe->bshd", scores, apply_sv_rope(q, cos, sin)) / denom[..., None]


class GLUMBTempConv(nn.Module):
    """Over (B, T, H, W, C): the per-frame GLUMBConv (1 x 1 expand, silu,
    depthwise 3 x 3 with padding 1, GLU, bias-free 1 x 1), then a bias-free
    (3, 1) conv over (T, H * W) added as a residual."""

    def __init__(self, channels: int, out_channels: int, expand_ratio: float,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        hidden = int(expand_ratio * channels)
        self.conv_inverted = nn.Conv2d(channels, 2 * hidden, 1, dtype=dtype)
        self.conv_depth = nn.Conv2d(2 * hidden, 2 * hidden, 3, groups=2 * hidden, dtype=dtype)
        self.conv_point = nn.Conv2d(hidden, out_channels, 1, bias=False, dtype=dtype)
        self.conv_temp = nn.Conv2d(out_channels, out_channels, (3, 1), bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        y = depthwise(self.conv_depth, F.silu(pointwise(self.conv_inverted, x.reshape(b * t, h, w, c))), padding=1)
        value, gate = y.chunk(2, dim=-1)
        seq = pointwise(self.conv_point, value * F.silu(gate)).reshape(b, t, h * w, -1)
        temporal = F.conv2d(seq.permute(0, 3, 1, 2), self.conv_temp.weight, padding=(1, 0)).permute(0, 2, 3, 1)
        return (seq + temporal).reshape(b, t, h, w, -1)


class SanaVideoBlock(nn.Module):
    """One block: ``x`` (B, S, dim) over the latent ``grid``, ``context`` (B,
    L, dim) projected text, ``t6`` (B, 6, dim), the RoPE (cos, sin) and the
    cross-attention's query and key ids (None: unmasked)."""

    def __init__(self, config: SanaVideoConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, inner_cross = config.hidden_size, config.cross_heads * config.cross_head_dim
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.scale_shift_table = nn.Parameter(torch.empty(6, dim, dtype=torch.float32))
        for name in ("q", "k", "v"):
            self.add_module(f"attn1_{name}", LoRADense(dim, dim, use_bias=False, **lora))
        self.attn1_norm_q = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.attn1_norm_k = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.attn1_proj = LoRADense(dim, dim, **lora)
        self.attn2_q = LoRADense(dim, inner_cross, **lora)
        self.attn2_k = LoRADense(dim, inner_cross, **lora)
        self.attn2_v = LoRADense(dim, inner_cross, **lora)
        self.attn2_norm_q = nn.Parameter(torch.empty(inner_cross, dtype=torch.float32))
        self.attn2_norm_k = nn.Parameter(torch.empty(inner_cross, dtype=torch.float32))
        self.attn2_proj = LoRADense(inner_cross, dim, **lora)
        self.ff = GLUMBTempConv(dim, dim, config.mlp_ratio, dtype)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale_shift_table.normal_(0.0, 1.0 / math.sqrt(self.config.hidden_size), generator=generator)
        for param in (self.attn1_norm_q, self.attn1_norm_k, self.attn2_norm_q, self.attn2_norm_k):
            param.fill_(1.0)

    def forward(self, x: torch.Tensor, context: torch.Tensor, t6: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, grid: Tuple[int, int, int], q_ids: Optional[torch.Tensor],
                key_ids: Optional[torch.Tensor]) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        batch, seq = x.shape[:2]
        mods = (self.scale_shift_table[None] + t6.to(torch.float32)).to(dtype)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (m[:, None] for m in mods.unbind(dim=1))

        # ReLU linear self-attention: rope after the relu, the normaliser from the unrotated q and k
        x_n = layer_norm(x, x.dtype, cfg.norm_eps) * (1 + scale_msa) + shift_msa
        heads = (batch, seq, cfg.num_heads, cfg.head_dim)
        q = F.relu(rms(self.attn1_q(x_n), self.attn1_norm_q, 1e-5).reshape(heads)).to(torch.float32)
        k = F.relu(rms(self.attn1_k(x_n), self.attn1_norm_k, 1e-5).reshape(heads)).to(torch.float32)
        out = rope_linear_attention(q, k, self.attn1_v(x_n).reshape(heads).to(torch.float32), cos, sin)
        x = x + gate_msa * self.attn1_proj(out.reshape(batch, seq, -1).to(dtype))

        # cross-attention with across-heads q / k norms, the caption mask as key ids
        cross = (cfg.cross_heads, cfg.cross_head_dim)
        q = rms(self.attn2_q(x), self.attn2_norm_q, 1e-5).reshape(batch, seq, *cross)
        k = rms(self.attn2_k(context), self.attn2_norm_k, 1e-5).reshape(batch, -1, *cross)
        v = self.attn2_v(context).reshape(batch, -1, *cross)
        attn = dot_product_attention(q, k, v, q_segment_ids=q_ids, kv_segment_ids=key_ids)
        x = x + self.attn2_proj(attn.reshape(batch, seq, -1).to(dtype))

        # GLUMBTempConv FFN
        x_f = layer_norm(x, x.dtype, cfg.norm_eps) * (1 + scale_mlp) + shift_mlp
        return x + gate_mlp * self.ff(x_f.reshape(batch, *grid, -1)).reshape(batch, seq, -1)


class SanaVideoTransformer(nn.Module):
    """The Sana-Video DiT.  ``latents`` (B, T, H, W, C), ``timesteps`` (B,) at
    scheduler scale (sigma x 1000), ``context`` (B, L, caption_channels)
    Gemma-2 features, ``context_mask`` (B, L) 1 = keep (None: every key);
    returns (B, T, H, W, out_channels) f32."""

    def __init__(self, config: SanaVideoConfig = SanaVideoConfig(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim = config.hidden_size
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.patch_embedding = nn.Conv3d(config.in_channels, dim, config.patch_size, stride=config.patch_size,
                                         dtype=dtype)
        self.time_in = LoRADense(256, dim, dtype=torch.float32)
        self.time_out = LoRADense(dim, dim, dtype=torch.float32)
        self.time_mod = LoRADense(dim, 6 * dim, dtype=torch.float32)
        self.caption_in_1 = LoRADense(config.caption_channels, dim, dtype=dtype)
        self.caption_in_2 = LoRADense(dim, dim, dtype=dtype)
        self.caption_norm = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        for i in range(config.num_layers):
            self.add_module(f"block_{i}", SanaVideoBlock(config, dtype, **lora))
        self.scale_shift_table = nn.Parameter(torch.empty(2, dim, dtype=torch.float32))
        self.proj_out = LoRADense(dim, int(np.prod(config.patch_size)) * config.out_channels, dtype=dtype, **lora)
        self._rope: Dict[Tuple[int, int, int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.caption_norm.fill_(1.0)
        self.scale_shift_table.normal_(0.0, 1.0 / math.sqrt(self.config.hidden_size), generator=generator)

    def rope(self, grid: Tuple[int, int, int], device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (S, head_dim) tables of ``grid`` on ``device``, made there the first time."""
        key = (*grid, device)
        if key not in self._rope:
            self._rope[key] = tuple(torch.from_numpy(a).to(device) for a in sanavideo_rope(self.config, grid))
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
        weight = self.patch_embedding.weight.permute(0, 2, 3, 4, 1).reshape(dim, -1)
        x = F.linear(x, weight, self.patch_embedding.bias)

        # AdaLayerNormSingle: cos-first sinusoid, f32 MLP, 6-way modulation
        emb = self.time_out(F.silu(self.time_in(timestep_embedding(timesteps, 256, time_factor=1.0))))
        t6 = self.time_mod(F.silu(emb)).reshape(batch, 6, dim)

        ctx = self.caption_in_2(F.gelu(self.caption_in_1(context.to(dtype)), approximate="tanh"))
        ctx = rms(ctx, self.caption_norm, 1e-5)
        key_ids = key_mask_segments(context_mask)
        q_ids = None if key_ids is None else torch.ones((batch, seq), dtype=torch.int32, device=x.device)
        cos, sin = self.rope(grid, x.device)

        for i in range(cfg.num_layers):
            x = self._run(f"block_{i}", x, ctx, t6, cos, sin, grid, q_ids, key_ids)

        # output: (2, dim) table + the embedded timestep, f32 LayerNorm, proj_out
        mods = self.scale_shift_table[None] + emb.to(torch.float32)[:, None]
        x_f = layer_norm(x, torch.float32) * (1 + mods[:, 1][:, None]) + mods[:, 0][:, None]
        out = self.proj_out(x_f.to(dtype))

        # unpatchify: the features split as (pt, ph, pw, C)
        out = out.reshape(batch, *grid, pt, ph, pw, cfg.out_channels).permute(0, 1, 4, 2, 5, 3, 6, 7)
        return out.reshape(batch, frames, height, width, cfg.out_channels).to(torch.float32)
