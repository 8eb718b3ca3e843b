"""ERNIE-Image single-stream DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/ernie/transformer.py``
(``ErnieImageTransformer2DModel``): the sequence is [image | text] (patch
embedded latents first, projected text after); per-axis angles over
(32, 48, 48) at theta 256, concatenated and then duplicated pairwise
(theta0, theta0, theta1, theta1, ...) but applied rotate-half over the full
head dim, mirrored as the JAX module does it (``ernie_rope_angles``,
``apply_ernie_rope``); image position ids (text_len, y, x), the first axis
each sample's own text length, and text ids (i, 0, 0); a diffusers
sin-first time embedding (``time_in`` / ``time_out``, f32) and one shared
zero-init 6-way AdaLN (``adaLN_modulation``, f32) for every layer; blocks
with affine RMS pre-norms, bias-free q/k/v/out with per-head RMS q/k norms
(eps 1e-5), f32 modulate and gate arithmetic and ``linear_fc2(up *
gelu_exact(gate))``; the final AdaLN-continuous (``final_adaLN`` of ``c``,
not of ``silu(c)``: ``scale, shift`` in that order; a LayerNorm without
affine) and the zero-init ``final_linear``.  ``text_proj`` (2560 -> 3072 at
the published size) carries no adapter.

The joint attention goes through :func:`dot_product_attention` (the flash
kernels on the card; the JAX module computes a dense f32 softmax with -inf
at masked keys): query ids 1, key ids 1 for the image and for the first
``text_lens`` text tokens of each sample and ``SEGMENT_PAD_ID`` past them,
as the JAX module builds its key mask from the lengths (not from the
mask itself).  The image keys are always valid, so no row is fully masked.
Submodules keep the JAX names (``layer_{i}.to_q``, ``layer_{i}.adaLN_sa_ln``);
remat checkpoints every block whole, as ``nn.remat`` wraps ``ErnieBlock``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import dot_product_attention, key_mask_segments
from ..cosmos1.transformer import rms
from ..layers import LoRADense


@dataclasses.dataclass(frozen=True)
class ErnieConfig:
    hidden_size: int = 3072
    num_heads: int = 24
    num_layers: int = 24
    ffn_hidden_size: int = 8192
    in_channels: int = 128
    out_channels: int = 128
    patch_size: int = 1
    text_in_dim: int = 2560
    rope_theta: float = 256.0
    rope_axes_dim: Tuple[int, int, int] = (32, 48, 48)
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls) -> "ErnieConfig":
        return cls(
            hidden_size=32, num_heads=2, num_layers=2, ffn_hidden_size=64,
            in_channels=16, out_channels=16, text_in_dim=32,
            rope_axes_dim=(4, 6, 6),
        )


def ernie_rope_angles(ids: torch.Tensor, axes_dim: Sequence[int], theta: float) -> torch.Tensor:
    """(B, S, 3) ids -> (B, S, head_dim) angles, each axis's f32 angles
    concatenated and then duplicated pairwise."""
    parts = []
    for i, dax in enumerate(axes_dim):
        omega = 1.0 / theta ** (torch.arange(0, dax, 2, dtype=torch.float32, device=ids.device) / dax)
        parts.append(ids[..., i, None].to(torch.float32) * omega)
    return torch.cat(parts, dim=-1).repeat_interleave(2, dim=-1)


def apply_ernie_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate-half over the full head dim, in f32, back to x's dtype."""
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    x_f = x.to(torch.float32)
    half = x.shape[-1] // 2
    rotated = torch.cat([-x_f[..., half:], x_f[..., :half]], dim=-1)
    return (x_f * cos + rotated * sin).to(x.dtype)


class ErnieBlock(nn.Module):
    def __init__(self, config: ErnieConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        hidden, hd = config.hidden_size, config.head_dim
        lora = dict(use_bias=False, dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.adaLN_sa_ln = nn.Parameter(torch.empty(hidden, dtype=torch.float32))
        self.to_q = LoRADense(hidden, hidden, **lora)
        self.to_k = LoRADense(hidden, hidden, **lora)
        self.to_v = LoRADense(hidden, hidden, **lora)
        self.norm_q = nn.Parameter(torch.empty(hd, dtype=torch.float32))
        self.norm_k = nn.Parameter(torch.empty(hd, dtype=torch.float32))
        self.to_out = LoRADense(hidden, hidden, **lora)
        self.adaLN_mlp_ln = nn.Parameter(torch.empty(hidden, dtype=torch.float32))
        self.gate_proj = LoRADense(hidden, config.ffn_hidden_size, **lora)
        self.up_proj = LoRADense(hidden, config.ffn_hidden_size, **lora)
        self.linear_fc2 = LoRADense(config.ffn_hidden_size, hidden, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for param in (self.adaLN_sa_ln, self.norm_q, self.norm_k, self.adaLN_mlp_ln):
            param.fill_(1.0)

    def forward(self, x: torch.Tensor, angles: torch.Tensor, temb6: List[torch.Tensor],
                key_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        batch, seq = x.shape[:2]
        heads, hd = cfg.num_heads, cfg.head_dim
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = temb6

        h = rms(x, self.adaLN_sa_ln, cfg.eps)
        h = (h.to(torch.float32) * (1.0 + scale_msa) + shift_msa).to(x.dtype)
        q = rms(self.to_q(h).reshape(batch, seq, heads, hd), self.norm_q, 1e-5)
        k = rms(self.to_k(h).reshape(batch, seq, heads, hd), self.norm_k, 1e-5)
        v = self.to_v(h).reshape(batch, seq, heads, hd)
        q, k = apply_ernie_rope(q, angles), apply_ernie_rope(k, angles)
        q_ids = None if key_ids is None else torch.ones_like(key_ids)
        attn = dot_product_attention(q, k, v, q_segment_ids=q_ids, kv_segment_ids=key_ids)
        attn = self.to_out(attn.reshape(batch, seq, cfg.hidden_size).to(self.dtype))
        x = (x.to(torch.float32) + gate_msa * attn.to(torch.float32)).to(x.dtype)

        h = rms(x, self.adaLN_mlp_ln, cfg.eps)
        h = (h.to(torch.float32) * (1.0 + scale_mlp) + shift_mlp).to(x.dtype)
        ff = self.linear_fc2(self.up_proj(h) * F.gelu(self.gate_proj(h), approximate="none"))
        return (x.to(torch.float32) + gate_mlp * ff.to(torch.float32)).to(x.dtype)


class ErnieTransformer(nn.Module):
    """The ERNIE-Image DiT.  ``latents`` (B, H, W, in_channels) packed
    latents, ``timesteps`` (B,) at scheduler scale (sigma x 1000),
    ``text_embeds`` (B, T, text_in_dim), ``text_lens`` (B,) valid text
    lengths; returns (B, H, W, out_channels) f32."""

    def __init__(self, config: ErnieConfig = ErnieConfig(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        hidden = config.hidden_size
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.x_embedder = LoRADense(config.in_channels, hidden, dtype=dtype, **lora)
        if config.text_in_dim != hidden:
            self.text_proj = LoRADense(config.text_in_dim, hidden, use_bias=False, dtype=dtype)
        self.time_in = LoRADense(hidden, hidden, dtype=torch.float32)
        self.time_out = LoRADense(hidden, hidden, dtype=torch.float32)
        self.adaLN_modulation = LoRADense(hidden, 6 * hidden, dtype=torch.float32, zero_init=True)
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", ErnieBlock(config, dtype, **lora))
        self.final_adaLN = LoRADense(hidden, 2 * hidden, dtype=torch.float32)
        self.final_linear = LoRADense(hidden, config.out_channels, dtype=dtype, zero_init=True, **lora)

    def _run(self, name: str, *args):
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, text_embeds: torch.Tensor,
                text_lens: torch.Tensor) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        batch, height, width, _ = latents.shape
        n_img = height * width
        t_max = text_embeds.shape[1]
        device = latents.device

        img = self.x_embedder(latents.to(dtype).reshape(batch, n_img, cfg.in_channels))
        text = text_embeds.to(dtype)
        if cfg.text_in_dim != cfg.hidden_size:
            text = self.text_proj(text)
        x = torch.cat([img, text], dim=1)  # image first

        lens = text_lens.to(torch.float32)
        ys = torch.arange(height, device=device).repeat_interleave(width).to(torch.float32)
        xs = torch.arange(width, device=device).repeat(height).to(torch.float32)
        img_ids = torch.stack([lens[:, None].expand(batch, n_img), ys[None].expand(batch, n_img),
                               xs[None].expand(batch, n_img)], dim=-1)
        text_ids = torch.cat([torch.arange(t_max, dtype=torch.float32, device=device)[None, :, None].expand(
            batch, t_max, 1), torch.zeros((batch, t_max, 2), dtype=torch.float32, device=device)], dim=-1)
        angles = ernie_rope_angles(torch.cat([img_ids, text_ids], dim=1), cfg.rope_axes_dim, cfg.rope_theta)
        valid_text = torch.arange(t_max, device=device)[None] < text_lens.to(device)[:, None]
        key_ids = key_mask_segments(torch.cat(
            [torch.ones((batch, n_img), dtype=torch.bool, device=device), valid_text], dim=1))

        # time: diffusers Timesteps (sin first, shift 0), then the SiLU MLP, in f32
        half = cfg.hidden_size // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=device) / half)
        args = timesteps.to(torch.float32)[:, None] * freqs[None]
        c = self.time_out(F.silu(self.time_in(torch.cat([torch.sin(args), torch.cos(args)], dim=-1))))
        temb6 = [m[:, None] for m in self.adaLN_modulation(F.silu(c)).chunk(6, dim=-1)]

        for i in range(cfg.num_layers):
            x = self._run(f"layer_{i}", x, angles, temb6, key_ids)

        f_scale, f_shift = self.final_adaLN(c).chunk(2, dim=-1)
        x_f = F.layer_norm(x.to(torch.float32), (cfg.hidden_size,), eps=cfg.eps)
        x_f = x_f * (1.0 + f_scale[:, None]) + f_shift[:, None]
        out = self.final_linear(x_f.to(dtype))
        return out[:, :n_img].reshape(batch, height, width, cfg.out_channels).to(torch.float32)
