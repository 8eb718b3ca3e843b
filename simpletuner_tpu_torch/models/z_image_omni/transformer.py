"""Z-Image-Omni single-stream DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/z_image_omni/transformer.py``
(``ZImageOmniTransformer2DModel``): a (ph, pw, c) 2 x 2 patch linear for the
noisy target and the clean reference latents, the caption through an
RMSNorm and a linear with a learned pad token in place of every padded
caption token, SigLIP features through an RMSNorm and a linear; three
refiner stacks (the modulated noise refiner over the image tokens, the
unmodulated context and SigLIP refiners), then 30 modulated blocks over the
unified ``[caption | cond? | noisy | siglip?]`` sequence and the f32
LayerNorm (no affine, eps 1e-6) final with scale ``1 + emb``.

Blocks: bias-free attention (30 heads of 128 at the published size), per-head
RMS q/k norms (eps 1e-5), a 3-axis complex RoPE at theta 256 with axes
(32, 48, 48) over (sequence index, row, col) position ids, the bias-free
SwiGLU (inner dim * 8/3, its gate's silu in f32), sandwich RMSNorms and, in
the modulated form, a scale-only adaLN straight from the 256-wide time
embedding (no SiLU before its linear) with tanh gates.  Each token picks
the "noisy" modulation (from t * 1000) or the "clean" one (from 1 * 1000)
by its noise mask: the noisy target takes the noisy one, reference and
SigLIP tokens the clean one, and the caption the first image's (clean when
a reference image rides along, noisy in text-to-image).

Positions: caption token i (of the valid ones) at (i + 1, 0, 0), padded
caption tokens at (0, 0, 0); every image block at (caption end, row, col);
SigLIP at (caption end + 1, ...) with its rows and columns rescaled onto
the latent grid (truncated to integers).  The unified sequence's segment
ids are all 1 (inner caption pads stay attended), as the JAX module passes
them.  Submodules keep the JAX names (``layer_{i}.attn_q``,
``noise_refiner_{i}.adaLN_modulation``, ``feed_forward.w1``).  Remat
(``gradient_checkpointing``) checkpoints every block whole.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import dot_product_attention
from ..layers import LoRADense, RMSNorm, layer_norm, timestep_embedding
from ..lumina2.transformer import rope_angles as _angles

ADALN_EMBED_DIM = 256
Angles = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ZImageOmniConfig:
    in_channels: int = 16
    patch_size: int = 2
    hidden_size: int = 3840
    depth: int = 30
    refiner_depth: int = 2
    num_heads: int = 30
    num_kv_heads: int = 30
    cap_feat_dim: int = 2560
    siglip_feat_dim: int = 1152
    norm_eps: float = 1e-5
    rope_theta: float = 256.0
    t_scale: float = 1000.0
    t_mid_size: int = 1024
    axes_dim: Tuple[int, int, int] = (32, 48, 48)

    @classmethod
    def tiny(cls) -> "ZImageOmniConfig":
        return cls(
            in_channels=4, hidden_size=96, depth=2, refiner_depth=1,
            num_heads=4, num_kv_heads=4, cap_feat_dim=32, siglip_feat_dim=24,
            t_mid_size=64, axes_dim=(8, 8, 8),
        )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def adaln_dim(self) -> int:
        return min(self.hidden_size, ADALN_EMBED_DIM)

    @property
    def ffn_inner(self) -> int:
        return int(self.hidden_size / 3 * 8)


def rope_frequencies(axes_dim: Tuple[int, ...], theta: float) -> Tuple[torch.Tensor, ...]:
    """Per axis the ``d // 2`` frequencies ``1 / theta^(2k/d)``, in f32 as the JAX module makes them."""
    return tuple(1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d)) for d in axes_dim)


def rope_angles(positions: torch.Tensor, freqs: Tuple[torch.Tensor, ...]) -> Angles:
    """(B, S, 3) position ids -> (cos, sin), each (B, S, head_dim / 2) f32."""
    angles = _angles(positions, freqs)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, angles: Angles) -> torch.Tensor:
    """Rotate consecutive feature pairs of (B, S, H, D) ``x``, in f32."""
    cos, sin = angles
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x_f = x.to(torch.float32)
    x0, x1 = x_f[..., 0::2], x_f[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(x.shape).to(x.dtype)


class ZOmniFFN(nn.Module):
    """``w2(silu_f32(w1 x) * w3 x)``, bias-free."""

    def __init__(self, config: ZImageOmniConfig, **lora) -> None:
        super().__init__()
        dim, inner = config.hidden_size, config.ffn_inner
        self.dtype = lora["dtype"]
        self.w1 = LoRADense(dim, inner, use_bias=False, **lora)
        self.w3 = LoRADense(dim, inner, use_bias=False, **lora)
        self.w2 = LoRADense(inner, dim, use_bias=False, **lora)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.w1(x), self.w3(x)
        return self.w2((F.silu(gate.to(torch.float32)) * up.to(torch.float32)).to(self.dtype))


class ZOmniBlock(nn.Module):
    """One block; ``modulation`` False is the context and SigLIP refiners' form."""

    def __init__(self, config: ZImageOmniConfig, modulation: bool = True, dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.modulation, self.dtype = config, modulation, dtype
        dim, dh = config.hidden_size, config.head_dim
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        norm = dict(eps=config.norm_eps, dtype=dtype)
        if modulation:
            self.adaLN_modulation = LoRADense(config.adaln_dim, 4 * dim, dtype=dtype)
        self.attention_norm1 = RMSNorm(dim, **norm)
        self.attn_q = LoRADense(dim, config.num_heads * dh, use_bias=False, **lora)
        self.attn_k = LoRADense(dim, config.num_kv_heads * dh, use_bias=False, **lora)
        self.attn_v = LoRADense(dim, config.num_kv_heads * dh, use_bias=False, **lora)
        self.norm_q = RMSNorm(dh, eps=1e-5, dtype=dtype)
        self.norm_k = RMSNorm(dh, eps=1e-5, dtype=dtype)
        self.attn_proj = LoRADense(config.num_heads * dh, dim, use_bias=False, **lora)
        self.attention_norm2 = RMSNorm(dim, **norm)
        self.ffn_norm1 = RMSNorm(dim, **norm)
        self.feed_forward = ZOmniFFN(config, **lora)
        self.ffn_norm2 = RMSNorm(dim, **norm)

    def forward(self, x: torch.Tensor, angles: Angles, cond_noisy: Optional[torch.Tensor] = None,
                cond_clean: Optional[torch.Tensor] = None, noise_mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        dh = cfg.head_dim
        batch, seq = x.shape[:2]
        if self.modulation:
            mod = self.adaLN_modulation(cond_noisy.to(dtype)).to(torch.float32)[:, None]
            if noise_mask is not None:
                clean = self.adaLN_modulation(cond_clean.to(dtype)).to(torch.float32)[:, None]
                mod = torch.where(noise_mask[:, :, None] == 1, mod, clean)
            scale_msa, gate_msa, scale_mlp, gate_mlp = mod.chunk(4, dim=-1)
            x_n = (self.attention_norm1(x).to(torch.float32) * (1.0 + scale_msa)).to(dtype)
        else:
            x_n = self.attention_norm1(x)

        q = self.norm_q(self.attn_q(x_n).reshape(batch, seq, cfg.num_heads, dh))
        k = self.norm_k(self.attn_k(x_n).reshape(batch, seq, cfg.num_kv_heads, dh))
        v = self.attn_v(x_n).reshape(batch, seq, cfg.num_kv_heads, dh)
        q, k = apply_rope(q, angles), apply_rope(k, angles)
        n_rep = cfg.num_heads // cfg.num_kv_heads
        if n_rep > 1:
            k = k.repeat_interleave(n_rep, dim=2)
            v = v.repeat_interleave(n_rep, dim=2)
        attn = dot_product_attention(q, k, v, q_segment_ids=segment_ids, kv_segment_ids=segment_ids)
        attn = self.attn_proj(attn.reshape(batch, seq, cfg.num_heads * dh))

        if self.modulation:
            x = x + torch.tanh(gate_msa).to(dtype) * self.attention_norm2(attn)
            h = (self.ffn_norm1(x).to(torch.float32) * (1.0 + scale_mlp)).to(dtype)
            return x + torch.tanh(gate_mlp).to(dtype) * self.ffn_norm2(self.feed_forward(h))
        x = x + self.attention_norm2(attn)
        return x + self.ffn_norm2(self.feed_forward(self.ffn_norm1(x)))


class ZImageOmniTransformer(nn.Module):
    """The Z-Image-Omni DiT.  ``latents`` (B, H, W, C) noisy, ``timesteps``
    (B,) already reversed (the family passes ``1 - sigma``), ``context`` (B,
    L, cap_feat_dim), ``context_mask`` (B, L) with 1 on valid caption tokens
    (None: all valid), ``siglip_embeds`` (B, Sh, Sw, siglip_feat_dim) and
    ``cond_latents`` (B, H, W, C) clean reference latents, both optional;
    returns the noisy target's (B, H, W, C) in f32."""

    def __init__(self, config: ZImageOmniConfig = ZImageOmniConfig(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim, p = config.hidden_size, config.patch_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.t_in = LoRADense(256, config.t_mid_size, dtype=dtype)
        self.t_out = LoRADense(config.t_mid_size, config.adaln_dim, dtype=dtype)
        self.x_embedder = LoRADense(p * p * config.in_channels, dim, **lora)
        self.cap_norm = RMSNorm(config.cap_feat_dim, eps=config.norm_eps, dtype=dtype)
        self.cap_embedder = LoRADense(config.cap_feat_dim, dim, **lora)
        self.cap_pad_token = nn.Parameter(torch.empty(1, dim, dtype=torch.float32))
        self.siglip_norm = RMSNorm(config.siglip_feat_dim, eps=config.norm_eps, dtype=dtype)
        self.siglip_embedder = LoRADense(config.siglip_feat_dim, dim, **lora)
        for prefix, modulation in (("noise_refiner", True), ("context_refiner", False), ("siglip_refiner", False)):
            for layer in range(config.refiner_depth):
                self.add_module(f"{prefix}_{layer}", ZOmniBlock(config, modulation=modulation, **lora))
        for layer in range(config.depth):
            self.add_module(f"layer_{layer}", ZOmniBlock(config, modulation=True, **lora))
        self.final_adaLN = LoRADense(config.adaln_dim, dim, dtype=dtype)
        self.final_linear = LoRADense(dim, p * p * config.in_channels, **lora)
        self._freqs: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The caption pad token, N(0, 0.02) as the Flax initialiser."""
        self.cap_pad_token.normal_(0.0, 0.02, generator=generator)

    def rope_freqs(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The per-axis frequencies on ``device``, made once (before a captured step needs them)."""
        if device not in self._freqs:
            self._freqs[device] = tuple(f.to(device) for f in
                                        rope_frequencies(self.config.axes_dim, self.config.rope_theta))
        return self._freqs[device]

    def _run(self, name: str, *args) -> torch.Tensor:
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def _t_embed(self, t: torch.Tensor) -> torch.Tensor:
        h = self.t_in(timestep_embedding(t, 256, time_factor=1.0).to(self.dtype))
        return self.t_out(F.silu(h))

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None, siglip_embeds: Optional[torch.Tensor] = None,
                cond_latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        p = cfg.patch_size
        batch, height, width, channels = latents.shape
        hh, ww = height // p, width // p
        img_len, cap_len = hh * ww, context.shape[1]
        device = latents.device
        if context_mask is None:
            context_mask = torch.ones((batch, cap_len), dtype=torch.int32, device=device)
        context_mask = context_mask.to(torch.int32)

        # the noisy (t * 1000) and clean (1 * 1000) time embeddings, one embedder
        t_noisy = self._t_embed(timesteps.to(torch.float32) * cfg.t_scale)
        t_clean = self._t_embed(torch.ones_like(timesteps, dtype=torch.float32) * cfg.t_scale)

        def patchify(v: torch.Tensor) -> torch.Tensor:
            v = v.to(dtype).reshape(batch, hh, p, ww, p, channels).permute(0, 1, 3, 2, 4, 5)
            return v.reshape(batch, img_len, p * p * channels)

        x = self.x_embedder(patchify(latents))
        cap = self.cap_embedder(self.cap_norm(context.to(dtype)))
        cap = torch.where(context_mask[:, :, None] == 1, cap, self.cap_pad_token.to(dtype)[None])

        # positions: the caption at 1..valid (pads 0), each image block at the caption's end
        freqs = self.rope_freqs(device)
        cap_pos0 = context_mask.cumsum(dim=1) * context_mask
        zeros = torch.zeros_like(cap_pos0)
        cap_angles = rope_angles(torch.stack([cap_pos0, zeros, zeros], dim=-1), freqs)
        cap_end = 1 + context_mask.sum(dim=1)
        rows = torch.arange(hh, dtype=torch.int64, device=device).repeat_interleave(ww)
        cols = torch.arange(ww, dtype=torch.int64, device=device).repeat(hh)
        img_positions = torch.stack([cap_end[:, None].expand(batch, img_len), rows[None].expand(batch, img_len),
                                     cols[None].expand(batch, img_len)], dim=-1)
        noisy_angles = rope_angles(img_positions, freqs)

        # the noise refiner runs over every image token jointly (cond, then the
        # target), each token's noise mask picking its modulation
        ones_img = torch.ones((batch, img_len), dtype=torch.int32, device=device)
        if cond_latents is not None:
            x = torch.cat([self.x_embedder(patchify(cond_latents)), x], dim=1)
            x_angles = tuple(torch.cat([a, a], dim=1) for a in noisy_angles)
            x_noise_mask = torch.cat([torch.zeros_like(ones_img), ones_img], dim=1)
        else:
            x_angles, x_noise_mask = noisy_angles, ones_img
        for layer in range(cfg.refiner_depth):
            x = self._run(f"noise_refiner_{layer}", x, x_angles, t_noisy, t_clean, x_noise_mask, None)
        for layer in range(cfg.refiner_depth):
            cap = self._run(f"context_refiner_{layer}", cap, cap_angles, None, None, None, None)

        # the caption inherits the first image's noise mask
        cap_noise = torch.full((batch, cap_len), 0 if cond_latents is not None else 1, dtype=torch.int32,
                               device=device)
        segments, cos, sin = [cap, x], [cap_angles[0], x_angles[0]], [cap_angles[1], x_angles[1]]
        noise_masks = [cap_noise, x_noise_mask]
        if siglip_embeds is not None:
            _, sh, sw, sc = siglip_embeds.shape
            sig = self.siglip_embedder(self.siglip_norm(siglip_embeds.to(dtype).reshape(batch, sh * sw, sc)))
            # rows / cols rescaled onto the latent grid, truncated
            sig_rows = torch.arange(sh, dtype=torch.float32, device=device).repeat_interleave(sw)
            sig_cols = torch.arange(sw, dtype=torch.float32, device=device).repeat(sh)
            sig_rows = (sig_rows / max(sh - 1, 1) * (height - 1)).to(torch.int32)
            sig_cols = (sig_cols / max(sw - 1, 1) * (width - 1)).to(torch.int32)
            sig_angles = rope_angles(torch.stack([(cap_end + 1)[:, None].expand(batch, sh * sw),
                                                  sig_rows[None].expand(batch, sh * sw),
                                                  sig_cols[None].expand(batch, sh * sw)], dim=-1), freqs)
            for layer in range(cfg.refiner_depth):
                sig = self._run(f"siglip_refiner_{layer}", sig, sig_angles, None, None, None, None)
            segments.append(sig)
            cos.append(sig_angles[0])
            sin.append(sig_angles[1])
            noise_masks.append(torch.zeros((batch, sh * sw), dtype=torch.int32, device=device))

        unified = torch.cat(segments, dim=1)
        unified_angles = (torch.cat(cos, dim=1), torch.cat(sin, dim=1))
        unified_noise = torch.cat(noise_masks, dim=1)
        unified_valid = torch.ones_like(unified_noise)
        for layer in range(cfg.depth):
            unified = self._run(f"layer_{layer}", unified, unified_angles, t_noisy, t_clean, unified_noise,
                                unified_valid)

        noisy_start = cap_len + (img_len if cond_latents is not None else 0)
        x = unified[:, noisy_start: noisy_start + img_len]
        scale = 1.0 + self.final_adaLN(F.silu(t_noisy.to(torch.float32)).to(dtype)).to(torch.float32)
        x_n = layer_norm(x, torch.float32) * scale[:, None]
        out = self.final_linear(x_n.to(dtype))
        out = out.reshape(batch, hh, ww, p, p, channels).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(batch, height, width, channels).to(torch.float32)
