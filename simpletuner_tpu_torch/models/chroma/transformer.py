"""Chroma DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/chroma/transformer.py`` (diffusers'
``ChromaTransformer2DModel``): the Flux topology (19 double-stream and 38
single-stream blocks, 24 heads of 128, qk RMSNorms, axial RoPE) with the
per-block modulation MLPs pruned.  One "distilled guidance" approximator
(``in_proj``, then ``approximator_layers`` residual silu MLPs behind
RMSNorms, then ``out_proj``) maps, for every one of ``mod_len`` modulation
slots, [timestep sincos (16) ++ guidance sincos (16, the guidance fixed at 0)
++ slot-index sincos (32)] to that slot's (dim,) vector.  The slot layout:
3 per single block first, then 6 per double block for the image stream,
then 6 per double block for the text stream, then the final norm's pair,
shift first.  The slot-index sincos is made on the host once (float64,
cos before sin, rounded to f32) and kept per device.  Submodules keep the
JAX names (``double_{i}.img_attn_q``, ``single_{i}.linear1``,
``approximator.layer_{i}_1``), so the bridge maps a Flax tree by name.

The forward takes Flux's inputs; ``vec`` (the pooled CLIP width the family
fills with zeros) and ``guidance`` are accepted and unused.  Remat
(``gradient_checkpointing``) checkpoints every block whole, as ``nn.remat``
wraps the JAX blocks (no Flux remat policy), so the forward kernel runs
twice per attention in a train step.
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

from ...ops import apply_rope, axial_rope, dot_product_attention
from ..layers import FeedForward, LoRADense, RMSNorm, gate_mod, layer_norm, modulate, timestep_embedding

Rope = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ChromaConfig:
    in_channels: int = 64
    hidden_size: int = 3072
    num_heads: int = 24
    head_dim: int = 128
    mlp_ratio: float = 4.0
    depth_double: int = 19
    depth_single: int = 38
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: float = 10000.0
    txt_in_features: int = 4096  # T5-XXL
    approximator_channels: int = 64  # input features per modulation slot
    approximator_hidden: int = 5120
    approximator_layers: int = 5
    qkv_bias: bool = True
    # the Flux family's surface (chroma has neither)
    vec_in_features: int = 768
    guidance_embed: bool = False

    @property
    def mod_len(self) -> int:
        return 3 * self.depth_single + 12 * self.depth_double + 2

    @classmethod
    def tiny(cls) -> "ChromaConfig":
        return cls(
            in_channels=16, hidden_size=64, num_heads=2, head_dim=32,
            depth_double=2, depth_single=2, axes_dim=(8, 12, 12),
            txt_in_features=32, approximator_hidden=64, approximator_layers=2,
        )


class ChromaApproximator(nn.Module):
    """``in_proj`` -> n x [h + layer_i_2(silu(layer_i_1(rms_i(h))))] -> ``out_proj``."""

    def __init__(self, config: ChromaConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config = config
        hidden = config.approximator_hidden
        self.in_proj = LoRADense(config.approximator_channels, hidden, dtype=dtype)
        for i in range(config.approximator_layers):
            self.add_module(f"norm_{i}", RMSNorm(hidden, dtype=dtype))
            self.add_module(f"layer_{i}_1", LoRADense(hidden, hidden, dtype=dtype))
            self.add_module(f"layer_{i}_2", LoRADense(hidden, hidden, dtype=dtype))
        self.out_proj = LoRADense(hidden, config.hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, mod_len, approximator_channels)
        h = self.in_proj(x)
        for i in range(self.config.approximator_layers):
            m = getattr(self, f"layer_{i}_1")(getattr(self, f"norm_{i}")(h))
            h = h + getattr(self, f"layer_{i}_2")(F.silu(m))
        return self.out_proj(h)


def slot_index_table(cfg: ChromaConfig) -> np.ndarray:
    """(mod_len, approximator_channels / 2) sincos of the slot index x 1000,
    cos before sin, made in float64 and rounded to f32 (the JAX table)."""
    half = cfg.approximator_channels // 4
    idx = np.arange(cfg.mod_len, dtype=np.float32) * 1000.0
    freqs = np.exp(-math.log(10000.0) * np.arange(half) / half)
    args = idx[:, None] * freqs[None]
    return np.concatenate([np.cos(args), np.sin(args)], axis=-1).astype(np.float32)


def chroma_input_vec(cfg: ChromaConfig, timesteps: torch.Tensor, slot_table: torch.Tensor) -> torch.Tensor:
    """(B, mod_len, 64) f32: [t sincos (16) ++ guidance-0 sincos (16) ++ the slot table (32)]."""
    nc = cfg.approximator_channels // 4
    t_proj = timestep_embedding(timesteps, nc, time_factor=1000.0)
    g_proj = timestep_embedding(torch.zeros_like(timesteps, dtype=torch.float32), nc, time_factor=1000.0)
    batch = timesteps.shape[0]
    tg = torch.cat([t_proj, g_proj], dim=-1)[:, None, :].expand(batch, cfg.mod_len, 2 * nc)
    return torch.cat([tg, slot_table[None].expand(batch, cfg.mod_len, 2 * nc)], dim=-1)


class ChromaDoubleBlock(nn.Module):
    """Flux's double-stream block fed from 6 + 6 approximator slots."""

    def __init__(self, config: ChromaConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim = config.hidden_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        for prefix in ("img", "txt"):
            for proj in ("q", "k", "v"):
                self.add_module(f"{prefix}_attn_{proj}", LoRADense(dim, dim, use_bias=config.qkv_bias, **lora))
            self.add_module(f"{prefix}_attn_norm_q", RMSNorm(config.head_dim, dtype=dtype))
            self.add_module(f"{prefix}_attn_norm_k", RMSNorm(config.head_dim, dtype=dtype))
            self.add_module(f"{prefix}_attn_proj", LoRADense(dim, dim, **lora))
            self.add_module(f"{prefix}_mlp", FeedForward(dim, config.mlp_ratio, **lora))

    def _qkv(self, prefix: str, x: torch.Tensor):
        cfg = self.config
        shape = (x.shape[0], x.shape[1], cfg.num_heads, cfg.head_dim)
        q = getattr(self, f"{prefix}_attn_norm_q")(getattr(self, f"{prefix}_attn_q")(x).reshape(shape))
        k = getattr(self, f"{prefix}_attn_norm_k")(getattr(self, f"{prefix}_attn_k")(x).reshape(shape))
        return q, k, getattr(self, f"{prefix}_attn_v")(x).reshape(shape)

    def forward(self, img, txt, img_mods, txt_mods, rope: Rope, segment_ids=None):
        dim, dtype = self.config.hidden_size, self.dtype
        im = [img_mods[:, i].to(dtype) for i in range(6)]
        tm = [txt_mods[:, i].to(dtype) for i in range(6)]
        img_q, img_k, img_v = self._qkv("img", modulate(layer_norm(img, dtype), im[0], im[1]))
        txt_q, txt_k, txt_v = self._qkv("txt", modulate(layer_norm(txt, dtype), tm[0], tm[1]))
        cos, sin = rope
        q = apply_rope(torch.cat([txt_q, img_q], dim=1), cos, sin)
        k = apply_rope(torch.cat([txt_k, img_k], dim=1), cos, sin)
        v = torch.cat([txt_v, img_v], dim=1)
        attn = dot_product_attention(q, k, v, q_segment_ids=segment_ids, kv_segment_ids=segment_ids)
        attn = attn.reshape(img.shape[0], -1, dim)
        txt_attn, img_attn = attn[:, : txt.shape[1]], attn[:, txt.shape[1]:]

        img = img + gate_mod(im[2]) * self.img_attn_proj(img_attn)
        txt = txt + gate_mod(tm[2]) * self.txt_attn_proj(txt_attn)
        img = img + gate_mod(im[5]) * self.img_mlp(modulate(layer_norm(img, dtype), im[3], im[4]))
        txt = txt + gate_mod(tm[5]) * self.txt_mlp(modulate(layer_norm(txt, dtype), tm[3], tm[4]))
        return img, txt


class ChromaSingleBlock(nn.Module):
    """Flux's single-stream block fed from 3 approximator slots."""

    def __init__(self, config: ChromaConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim = config.hidden_size
        self.mlp_dim = int(dim * config.mlp_ratio)
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.linear1 = LoRADense(dim, dim * 3 + self.mlp_dim, **lora)
        self.norm_q = RMSNorm(config.head_dim, dtype=dtype)
        self.norm_k = RMSNorm(config.head_dim, dtype=dtype)
        self.linear2 = LoRADense(dim + self.mlp_dim, dim, **lora)

    def forward(self, x, mods, rope: Rope, segment_ids=None):
        cfg, dtype = self.config, self.dtype
        dim = cfg.hidden_size
        shift, scale, gate = (mods[:, i].to(dtype) for i in range(3))
        fused = self.linear1(modulate(layer_norm(x, dtype), shift, scale))
        batch, seq = x.shape[:2]
        shape = (batch, seq, cfg.num_heads, cfg.head_dim)
        q, k, v = (t.reshape(shape) for t in fused[..., : dim * 3].split(dim, dim=-1))
        cos, sin = rope
        q = apply_rope(self.norm_q(q), cos, sin)
        k = apply_rope(self.norm_k(k), cos, sin)
        attn = dot_product_attention(q, k, v, q_segment_ids=segment_ids, kv_segment_ids=segment_ids)
        out = self.linear2(torch.cat([attn.reshape(batch, seq, dim),
                                      F.gelu(fused[..., dim * 3:], approximate="tanh")], dim=-1))
        return x + gate_mod(gate) * out


class ChromaTransformer(nn.Module):
    """The Chroma DiT on Flux's inputs (packed image tokens and their ids, T5
    tokens and their ids, timesteps in [0, 1], segment ids); returns the
    (B, S_img, in_channels) prediction in f32."""

    def __init__(self, config: ChromaConfig = ChromaConfig(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim = config.hidden_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.img_in = LoRADense(config.in_channels, dim, **lora)
        self.txt_in = LoRADense(config.txt_in_features, dim, **lora)
        self.approximator = ChromaApproximator(config, dtype)
        for i in range(config.depth_double):
            self.add_module(f"double_{i}", ChromaDoubleBlock(config, **lora))
        for i in range(config.depth_single):
            self.add_module(f"single_{i}", ChromaSingleBlock(config, **lora))
        self.final_proj = LoRADense(dim, config.in_channels, dtype=dtype)
        self._slots: Dict[torch.device, torch.Tensor] = {}

    def slot_table(self, device: torch.device) -> torch.Tensor:
        """The slot-index sincos on ``device``, made once (before a captured step needs it)."""
        if device not in self._slots:
            self._slots[device] = torch.from_numpy(slot_index_table(self.config)).to(device)
        return self._slots[device]

    def _run(self, block: nn.Module, *args):
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, img: torch.Tensor, img_ids: torch.Tensor, txt: torch.Tensor, txt_ids: torch.Tensor,
                timesteps: torch.Tensor, vec: Optional[torch.Tensor] = None, guidance: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        if timesteps.dim() != 1:
            raise NotImplementedError("tokenwise timesteps are not ported")
        img_tok = self.img_in(img)
        txt_tok = self.txt_in(txt)
        slots = self.approximator(chroma_input_vec(cfg, timesteps, self.slot_table(img.device)).to(dtype))
        rope = axial_rope(cfg.axes_dim, torch.cat([txt_ids, img_ids], dim=1), cfg.theta)

        img_off = 3 * cfg.depth_single
        txt_off = img_off + 6 * cfg.depth_double
        for i in range(cfg.depth_double):
            img_tok, txt_tok = self._run(getattr(self, f"double_{i}"), img_tok, txt_tok,
                                         slots[:, img_off + 6 * i: img_off + 6 * i + 6],
                                         slots[:, txt_off + 6 * i: txt_off + 6 * i + 6], rope, segment_ids)
        stream = torch.cat([txt_tok, img_tok], dim=1)
        for i in range(cfg.depth_single):
            stream = self._run(getattr(self, f"single_{i}"), stream, slots[:, 3 * i: 3 * i + 3], rope, segment_ids)
        img_tok = stream[:, txt_tok.shape[1]:]

        # the final norm's pair: shift first, then scale
        shift, scale = slots[:, -2].to(dtype), slots[:, -1].to(dtype)
        img_tok = modulate(layer_norm(img_tok, dtype), shift, scale)
        return self.final_proj(img_tok).to(torch.float32)
