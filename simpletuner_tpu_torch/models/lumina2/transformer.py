"""Lumina-Image 2.0 Next-DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/lumina2/transformer.py`` (diffusers'
``Lumina2Transformer2DModel``): a (ph, pw, c) 2 x 2 patch linear, the
timestep MLP on a 256-dim sinusoid of the (already reversed) timestep taken
at ``time_factor`` 1, the caption through an RMSNorm and a linear, two
unmodulated context refiners over the caption (masked by the caption mask),
two modulated noise refiners over the image (unmasked), then 26 modulated
blocks over the joint [caption, image] sequence and the f32
LayerNorm-continuous final (no affine, eps 1e-6, scale ``1 + emb``, no
shift).  Blocks are Llama-style: bias-free GQA attention (24 query and 8 kv
heads of 96 at the published size; the kv heads are repeated before the
op, which zero-pads D = 96 to the kernels' 128), per-head RMS q/k norms
(eps 1e-5), a 3-axis complex RoPE over (caption index, row, col) position
ids in f32 (interleaved pairs), the bias-free SwiGLU with its gate's silu in
f32, sandwich RMSNorms, and in the modulated form the 4-way adaLN (scale,
tanh gate, scale, tanh gate) from ``silu(temb)``.  Submodules keep the JAX
names (``layer_{i}.attn_q``, ``feed_forward.linear_1``, ``time_in.in_layer``).

Mirrored as the JAX module computes it: the joint sequence keeps the full
static caption length, and its segment ids are ``[context_mask, ones]``, so
a padded caption token carries segment id 0, not the pad id -1: pads attend
only to each other (in the context refiners and in all 26 joint layers,
which are always masked), and image and valid caption tokens never see them
(ROADMAP Queue 3).  Padded caption positions take RoPE angle 0, and image
tokens start their first axis at the count of valid caption tokens.  The
per-axis frequencies are made in float64 on the host and rounded to f32,
once per device.  Remat (``gradient_checkpointing``) checkpoints every
block whole, as ``nn.remat`` wraps ``Lumina2Block``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import dot_product_attention
from ..layers import LoRADense, MLPEmbedder, RMSNorm, layer_norm, timestep_embedding


@dataclasses.dataclass(frozen=True)
class Lumina2Config:
    in_channels: int = 16
    patch_size: int = 2
    hidden_size: int = 2304
    depth: int = 26
    refiner_depth: int = 2
    num_heads: int = 24
    num_kv_heads: int = 8
    cap_feat_dim: int = 2304
    multiple_of: int = 256
    ffn_dim_multiplier: float = 0.0  # 0 = unset
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    axes_dim: Tuple[int, int, int] = (32, 32, 32)

    @classmethod
    def tiny(cls) -> "Lumina2Config":
        return cls(
            in_channels=4, hidden_size=96, depth=2, refiner_depth=1,
            num_heads=4, num_kv_heads=2, cap_feat_dim=32, multiple_of=32,
            axes_dim=(8, 8, 8),
        )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def time_dim(self) -> int:
        return min(self.hidden_size, 1024)

    @property
    def ffn_inner(self) -> int:
        # diffusers LuminaFeedForward: 4 x dim, then 2/3, then up to a multiple_of
        inner = int(2 * (4 * self.hidden_size) / 3)
        if self.ffn_dim_multiplier:
            inner = int(self.ffn_dim_multiplier * inner)
        return self.multiple_of * ((inner + self.multiple_of - 1) // self.multiple_of)


def rope_frequencies(axes_dim: Tuple[int, ...], theta: float) -> Tuple[np.ndarray, ...]:
    """Per axis the ``d // 2`` frequencies ``1 / theta^(2k/d)``, float64 rounded to f32."""
    return tuple((1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)).astype(np.float32) for d in axes_dim)


def rope_angles(positions: torch.Tensor, freqs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """(B, S, n_axes) position ids -> (B, S, sum(axes_dim) // 2) f32 angles."""
    return torch.cat([positions[..., i:i + 1].to(torch.float32) * f[None, None] for i, f in enumerate(freqs)], dim=-1)


def apply_rope_complex(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate consecutive feature pairs of (B, S, H, D) ``x`` by ``angles``
    (B, S, D / 2), in f32 (diffusers ``apply_rotary_emb``, ``use_real=False``)."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x_f = x.to(torch.float32)
    x0, x1 = x_f[..., 0::2], x_f[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(x.shape).to(x.dtype)


class LuminaFFN(nn.Module):
    """SwiGLU: ``linear_2(silu_f32(linear_1(x)) * linear_3(x))``, bias-free."""

    def __init__(self, config: Lumina2Config, **lora) -> None:
        super().__init__()
        dim, inner = config.hidden_size, config.ffn_inner
        self.dtype = lora["dtype"]
        self.linear_1 = LoRADense(dim, inner, use_bias=False, **lora)
        self.linear_3 = LoRADense(dim, inner, use_bias=False, **lora)
        self.linear_2 = LoRADense(inner, dim, use_bias=False, **lora)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.linear_1(x), self.linear_3(x)
        return self.linear_2((F.silu(gate.to(torch.float32)) * up.to(torch.float32)).to(self.dtype))


class Lumina2Block(nn.Module):
    """One Next-DiT block; ``modulation`` False is the context refiner's form."""

    def __init__(self, config: Lumina2Config, modulation: bool = True, dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.modulation, self.dtype = config, modulation, dtype
        dim, dh = config.hidden_size, config.head_dim
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        norm = dict(eps=config.norm_eps, dtype=dtype)
        if modulation:
            self.norm1_linear = LoRADense(config.time_dim, 4 * dim, dtype=dtype)
        self.norm1_norm = RMSNorm(dim, **norm)
        self.attn_q = LoRADense(dim, config.num_heads * dh, use_bias=False, **lora)
        self.attn_k = LoRADense(dim, config.num_kv_heads * dh, use_bias=False, **lora)
        self.attn_v = LoRADense(dim, config.num_kv_heads * dh, use_bias=False, **lora)
        self.norm_q = RMSNorm(dh, eps=1e-5, dtype=dtype)
        self.norm_k = RMSNorm(dh, eps=1e-5, dtype=dtype)
        self.attn_proj = LoRADense(config.num_heads * dh, dim, use_bias=False, **lora)
        self.norm2 = RMSNorm(dim, **norm)
        self.ffn_norm1 = RMSNorm(dim, **norm)
        self.feed_forward = LuminaFFN(config, **lora)
        self.ffn_norm2 = RMSNorm(dim, **norm)

    def forward(self, x: torch.Tensor, angles: torch.Tensor, temb: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        dh = cfg.head_dim
        batch, seq = x.shape[:2]
        if self.modulation:
            mod = self.norm1_linear(F.silu(temb.to(torch.float32)).to(dtype)).to(torch.float32)
            scale_msa, gate_msa, scale_mlp, gate_mlp = mod.chunk(4, dim=-1)
            x_n = (self.norm1_norm(x).to(torch.float32) * (1 + scale_msa[:, None])).to(dtype)
        else:
            x_n = self.norm1_norm(x)

        q = self.norm_q(self.attn_q(x_n).reshape(batch, seq, cfg.num_heads, dh))
        k = self.norm_k(self.attn_k(x_n).reshape(batch, seq, cfg.num_kv_heads, dh))
        v = self.attn_v(x_n).reshape(batch, seq, cfg.num_kv_heads, dh)
        q = apply_rope_complex(q, angles)
        k = apply_rope_complex(k, angles)
        n_rep = cfg.num_heads // cfg.num_kv_heads
        if n_rep > 1:
            k = k.repeat_interleave(n_rep, dim=2)
            v = v.repeat_interleave(n_rep, dim=2)
        attn = dot_product_attention(q, k, v, q_segment_ids=segment_ids, kv_segment_ids=segment_ids)
        attn = self.attn_proj(attn.reshape(batch, seq, cfg.num_heads * dh))

        if self.modulation:
            x = x + torch.tanh(gate_msa)[:, None].to(dtype) * self.norm2(attn)
            h = (self.ffn_norm1(x).to(torch.float32) * (1 + scale_mlp[:, None])).to(dtype)
            return x + torch.tanh(gate_mlp)[:, None].to(dtype) * self.ffn_norm2(self.feed_forward(h))
        x = x + self.norm2(attn)
        return x + self.ffn_norm2(self.feed_forward(self.ffn_norm1(x)))


class Lumina2Transformer(nn.Module):
    """The Lumina2 DiT.  ``latents`` (B, H, W, C), ``timesteps`` (B,) already
    reversed (the family passes ``1 - sigma``), ``context`` (B, L,
    cap_feat_dim) LLM hidden states, ``context_mask`` (B, L), 1 on valid
    caption tokens (None: all valid); returns (B, H, W, C) in f32."""

    def __init__(self, config: Lumina2Config = Lumina2Config(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim, p = config.hidden_size, config.patch_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.time_in = MLPEmbedder(256, config.time_dim, dtype=dtype)
        self.cap_norm = RMSNorm(config.cap_feat_dim, eps=config.norm_eps, dtype=dtype)
        self.cap_in = LoRADense(config.cap_feat_dim, dim, **lora)
        self.patch_in = LoRADense(p * p * config.in_channels, dim, **lora)
        for layer in range(config.refiner_depth):
            self.add_module(f"context_refiner_{layer}", Lumina2Block(config, modulation=False, **lora))
        for layer in range(config.refiner_depth):
            self.add_module(f"noise_refiner_{layer}", Lumina2Block(config, modulation=True, **lora))
        for layer in range(config.depth):
            self.add_module(f"layer_{layer}", Lumina2Block(config, modulation=True, **lora))
        self.final_mod = LoRADense(config.time_dim, dim, dtype=dtype)
        self.final_proj = LoRADense(dim, p * p * config.in_channels, **lora)
        self._freqs: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def rope_freqs(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The per-axis frequencies on ``device``, made once (before a captured step needs them)."""
        if device not in self._freqs:
            self._freqs[device] = tuple(torch.from_numpy(f).to(device) for f in
                                        rope_frequencies(self.config.axes_dim, self.config.rope_theta))
        return self._freqs[device]

    def _run(self, name: str, *args) -> torch.Tensor:
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        p = cfg.patch_size
        batch, height, width, channels = latents.shape
        hh, ww = height // p, width // p
        img_len, cap_len = hh * ww, context.shape[1]
        device = latents.device
        if context_mask is None:
            context_mask = torch.ones((batch, cap_len), dtype=torch.int32, device=device)
        context_mask = context_mask.to(torch.int32)

        t_emb = self.time_in(timestep_embedding(timesteps, 256, time_factor=1.0).to(dtype))
        cap = self.cap_in(self.cap_norm(context.to(dtype)))
        x = latents.to(dtype).reshape(batch, hh, p, ww, p, channels).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_in(x.reshape(batch, img_len, p * p * channels))

        # position ids: the caption's running index (pads at 0), then the image
        # at (valid caption count, row, col)
        eff_cap = context_mask.sum(dim=1)
        cap_pos0 = (context_mask.cumsum(dim=1) - 1) * context_mask
        zeros = torch.zeros_like(cap_pos0)
        cap_positions = torch.stack([cap_pos0, zeros, zeros], dim=-1)
        rows = torch.arange(hh, dtype=torch.int64, device=device).repeat_interleave(ww)
        cols = torch.arange(ww, dtype=torch.int64, device=device).repeat(hh)
        img_positions = torch.stack([eff_cap[:, None].expand(batch, img_len), rows[None].expand(batch, img_len),
                                     cols[None].expand(batch, img_len)], dim=-1)
        freqs = self.rope_freqs(device)
        cap_angles = rope_angles(cap_positions, freqs)
        img_angles = rope_angles(img_positions, freqs)

        for layer in range(cfg.refiner_depth):
            cap = self._run(f"context_refiner_{layer}", cap, cap_angles, None, context_mask)
        for layer in range(cfg.refiner_depth):
            x = self._run(f"noise_refiner_{layer}", x, img_angles, t_emb, None)

        # the joint [caption, image] sequence; a padded caption token has
        # segment id 0 (pads attend to each other only), the rest 1
        joint = torch.cat([cap, x], dim=1)
        joint_angles = torch.cat([cap_angles, img_angles], dim=1)
        segment_ids = torch.cat([context_mask, torch.ones((batch, img_len), dtype=torch.int32, device=device)], dim=1)
        for layer in range(cfg.depth):
            joint = self._run(f"layer_{layer}", joint, joint_angles, t_emb, segment_ids)

        emb = self.final_mod(F.silu(t_emb.to(torch.float32)).to(dtype))
        x_n = layer_norm(joint[:, cap_len:], torch.float32) * (1 + emb.to(torch.float32)[:, None])
        out = self.final_proj(x_n.to(dtype))
        out = out.reshape(batch, hh, ww, p, p, channels).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(batch, height, width, channels).to(torch.float32)
