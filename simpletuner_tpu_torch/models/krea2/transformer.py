"""Krea-2 single-stream GQA MMDiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/krea2/transformer.py``
(``Krea2Transformer2DModel``): zero-centred f32 RMSNorms (scale ``1 + w``,
eps 1e-5); bias-free GQA attention (48 query heads and 12 key/value heads of
128 at the published size) with per-head zero-centred q/k norms, the
interleaved-pair rope at theta 1000 over axes (32, 48, 48) and a sigmoid
output gate (``to_gate``) before ``to_out``; the bias-free SwiGLU.

The timestep (flow sigma in [0, 1]) is scaled by 1000 into a cos-first
sinusoid and a gelu-tanh MLP (``temb``, kept (B, 1, H)); one shared
``time_mod_proj`` turns it into six modulations, to which every block adds
its own ``scale_shift_table``.  Text conditioning is a stack of tapped
encoder states (B, S, L, D): the layerwise fusion blocks attend across the L
taps of each token, the ``text_projector`` (L -> 1) collapses them, the
refiner blocks attend across tokens with the text pads masked as keys, and
``txt_in`` (RMSNorm and a gelu-tanh MLP) widens them.  The [text | image]
stream runs through every block, with the text pads masked as keys (query
segment ids 1, key ids 1 or ``SEGMENT_PAD_ID``); the final layer reads
``temb`` (not the six-way modulation) through a (2, H) table.

Every attention goes through :func:`dot_product_attention` (the flash
kernels on the card; the JAX module computes a dense f32 softmax): the joint
one over [text | image], the refiners' over the text, and the layerwise
one over each token's 12 taps (the token as the batch).  K and V are
repeated to the query heads as ``jnp.repeat`` does (head h reads key/value
head h // 4).  Submodules keep the JAX names (``block_{i}.attn.to_gate``,
``text_layerwise_{i}.ff.up``); remat (``gradient_checkpointing``)
checkpoints every main block whole, as the JAX module does (the text
stage, without adapters, takes no gradient).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import dot_product_attention, key_mask_segments
from ...ops.rope import apply_rope, axial_rope
from ..layers import LoRADense, lecun_normal_

Angles = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Krea2Config:
    in_channels: int = 64
    num_layers: int = 28
    attention_head_dim: int = 128
    num_attention_heads: int = 48
    num_key_value_heads: int = 12
    intermediate_size: int = 16384
    timestep_embed_dim: int = 256
    text_hidden_dim: int = 2560
    num_text_layers: int = 12
    text_num_attention_heads: int = 20
    text_num_key_value_heads: int = 20
    text_intermediate_size: int = 6912
    num_layerwise_text_blocks: int = 2
    num_refiner_text_blocks: int = 2
    axes_dims_rope: Tuple[int, int, int] = (32, 48, 48)
    rope_theta: float = 1000.0
    norm_eps: float = 1e-5

    @property
    def hidden_size(self) -> int:
        return self.attention_head_dim * self.num_attention_heads

    @classmethod
    def tiny(cls) -> "Krea2Config":
        return cls(
            in_channels=16, num_layers=2, attention_head_dim=16,
            num_attention_heads=4, num_key_value_heads=2, intermediate_size=96,
            timestep_embed_dim=32, text_hidden_dim=32, num_text_layers=3,
            text_num_attention_heads=2, text_num_key_value_heads=2,
            text_intermediate_size=48, num_layerwise_text_blocks=1,
            num_refiner_text_blocks=1, axes_dims_rope=(4, 6, 6),
        )


def zrms(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Zero-centred RMSNorm in f32 (scale ``1 + weight``), returned in x's dtype."""
    x_f = x.to(torch.float32)
    y = x_f * torch.rsqrt(x_f.square().mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + weight.to(torch.float32))).to(x.dtype)


class Krea2Attention(nn.Module):
    """GQA with zero-centred q/k RMS norms and a sigmoid output gate."""

    def __init__(self, dim: int, num_heads: int, num_kv_heads: int, head_dim: int, norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0, lora_alpha: Optional[float] = None,
                 lora_algo: str = "lora") -> None:
        super().__init__()
        self.heads, self.kv_heads, self.head_dim, self.eps = num_heads, num_kv_heads, head_dim, norm_eps
        self.dtype = dtype
        hidden = num_heads * head_dim
        lora = dict(use_bias=False, dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.to_q = LoRADense(dim, hidden, **lora)
        self.to_k = LoRADense(dim, num_kv_heads * head_dim, **lora)
        self.to_v = LoRADense(dim, num_kv_heads * head_dim, **lora)
        self.to_gate = LoRADense(dim, hidden, **lora)
        self.norm_q = nn.Parameter(torch.empty(head_dim, dtype=torch.float32))
        self.norm_k = nn.Parameter(torch.empty(head_dim, dtype=torch.float32))
        self.to_out = LoRADense(hidden, hidden, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.norm_q.zero_()
        self.norm_k.zero_()

    def forward(self, x: torch.Tensor, angles: Optional[Angles] = None,
                key_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch, seq = x.shape[:2]
        hd = self.head_dim
        q = zrms(self.to_q(x).reshape(batch, seq, self.heads, hd), self.norm_q, self.eps)
        k = zrms(self.to_k(x).reshape(batch, seq, self.kv_heads, hd), self.norm_k, self.eps)
        v = self.to_v(x).reshape(batch, seq, self.kv_heads, hd)
        gate = self.to_gate(x)
        if angles is not None:
            q = apply_rope(q, *angles)
            k = apply_rope(k, *angles)
        rep = self.heads // self.kv_heads
        if rep > 1:  # jnp.repeat(k, rep, axis=2): head h reads key/value head h // rep
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        q_ids = None if key_ids is None else torch.ones_like(key_ids)
        out = dot_product_attention(q, k, v, q_segment_ids=q_ids, kv_segment_ids=key_ids)
        out = out.reshape(batch, seq, self.heads * hd).to(self.dtype)
        out = out * torch.sigmoid(gate.to(torch.float32)).to(self.dtype)
        return self.to_out(out)


class Krea2SwiGLU(nn.Module):
    def __init__(self, dim: int, intermediate_size: int, **lora) -> None:
        super().__init__()
        self.gate = LoRADense(dim, intermediate_size, use_bias=False, **lora)
        self.up = LoRADense(dim, intermediate_size, use_bias=False, **lora)
        self.down = LoRADense(intermediate_size, dim, use_bias=False, **lora)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class Krea2TextFusionBlock(nn.Module):
    """Pre-norm block without rope or modulation (no adapters)."""

    def __init__(self, config: Krea2Config, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.eps = config.norm_eps
        dim = config.text_hidden_dim
        self.norm1 = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.norm2 = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.attn = Krea2Attention(dim, config.text_num_attention_heads, config.text_num_key_value_heads,
                                   dim // config.text_num_attention_heads, config.norm_eps, dtype)
        self.ff = Krea2SwiGLU(dim, config.text_intermediate_size, dtype=dtype)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.norm1.zero_()
        self.norm2.zero_()

    def forward(self, x: torch.Tensor, key_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(zrms(x, self.norm1, self.eps), key_ids=key_ids)
        return x + self.ff(zrms(x, self.norm2, self.eps))


class Krea2Block(nn.Module):
    """Main block: the shared six-way modulation plus the block's own table."""

    def __init__(self, config: Krea2Config, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.eps = config.norm_eps
        hidden = config.hidden_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.scale_shift_table = nn.Parameter(torch.empty(6, hidden, dtype=torch.float32))
        self.norm1 = nn.Parameter(torch.empty(hidden, dtype=torch.float32))
        self.norm2 = nn.Parameter(torch.empty(hidden, dtype=torch.float32))
        self.attn = Krea2Attention(hidden, config.num_attention_heads, config.num_key_value_heads,
                                   config.attention_head_dim, config.norm_eps, **lora)
        self.ff = Krea2SwiGLU(hidden, config.intermediate_size, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale_shift_table.zero_()
        self.norm1.zero_()
        self.norm2.zero_()

    def forward(self, x: torch.Tensor, temb_mod: torch.Tensor, angles: Angles,
                key_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden = self.scale_shift_table.shape[1]
        mods = temb_mod.reshape(temb_mod.shape[0], 1, 6, hidden) + self.scale_shift_table.to(torch.float32)
        prescale, preshift, pregate, postscale, postshift, postgate = mods.unbind(dim=2)
        h = ((1.0 + prescale) * zrms(x, self.norm1, self.eps).to(torch.float32) + preshift).to(x.dtype)
        attn = self.attn(h, angles, key_ids)
        x = (x.to(torch.float32) + pregate * attn.to(torch.float32)).to(x.dtype)
        h = ((1.0 + postscale) * zrms(x, self.norm2, self.eps).to(torch.float32) + postshift).to(x.dtype)
        ff = self.ff(h)
        return (x.to(torch.float32) + postgate * ff.to(torch.float32)).to(x.dtype)


class Krea2Transformer(nn.Module):
    """The Krea-2 DiT.  ``hidden_states`` (B, S_img, in_channels) packed
    latents, ``encoder_hidden_states`` (B, S_txt, L, text_hidden_dim) stacked
    taps, ``timesteps`` (B,) flow sigmas, ``position_ids`` (S_txt + S_img, 3),
    ``encoder_attention_mask`` (B, S_txt) or None; returns (B, S_img,
    in_channels) f32."""

    def __init__(self, config: Krea2Config = Krea2Config(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        hidden = config.hidden_size
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.time_in_1 = LoRADense(config.timestep_embed_dim, hidden, dtype=torch.float32)
        self.time_in_2 = LoRADense(hidden, hidden, dtype=torch.float32)
        self.time_mod_proj = LoRADense(hidden, 6 * hidden, dtype=torch.float32)
        for i in range(config.num_layerwise_text_blocks):
            self.add_module(f"text_layerwise_{i}", Krea2TextFusionBlock(config, dtype))
        self.text_projector = nn.Parameter(torch.empty(config.num_text_layers, 1, dtype=torch.float32))
        for i in range(config.num_refiner_text_blocks):
            self.add_module(f"text_refiner_{i}", Krea2TextFusionBlock(config, dtype))
        self.txt_norm = nn.Parameter(torch.empty(config.text_hidden_dim, dtype=torch.float32))
        self.txt_in_1 = LoRADense(config.text_hidden_dim, hidden, dtype=dtype)
        self.txt_in_2 = LoRADense(hidden, hidden, dtype=dtype)
        self.img_in = LoRADense(config.in_channels, hidden, dtype=dtype, **lora)
        for i in range(config.num_layers):
            self.add_module(f"block_{i}", Krea2Block(config, dtype, **lora))
        self.final_scale_shift_table = nn.Parameter(torch.empty(2, hidden, dtype=torch.float32))
        self.final_norm = nn.Parameter(torch.empty(hidden, dtype=torch.float32))
        self.final_linear = LoRADense(hidden, config.in_channels, dtype=dtype, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.text_projector, self.config.num_text_layers, generator)
        self.txt_norm.zero_()
        self.final_scale_shift_table.zero_()
        self.final_norm.zero_()

    def _run(self, name: str, *args):
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor, timesteps: torch.Tensor,
                position_ids: torch.Tensor, encoder_attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        batch, img_len = hidden_states.shape[:2]
        txt_len = encoder_hidden_states.shape[1]
        device = hidden_states.device

        # time embedding: cos-first sinusoid of t * 1000, in f32, kept (B, 1, H)
        half = cfg.timestep_embed_dim // 2
        freqs = torch.exp(-math.log(1e4) * torch.arange(half, dtype=torch.float32, device=device) / half)
        args = (timesteps.to(torch.float32) * 1e3)[:, None, None] * freqs
        temb = self.time_in_1(torch.cat([torch.cos(args), torch.sin(args)], dim=-1))
        temb = self.time_in_2(F.gelu(temb, approximate="tanh"))
        temb_mod = self.time_mod_proj(F.gelu(temb, approximate="tanh"))

        # text fusion: layerwise over the taps, the L -> 1 projector, the masked refiners
        text_ids = key_mask_segments(encoder_attention_mask)
        full_ids = None
        if text_ids is not None:
            full_ids = torch.cat([text_ids, torch.ones((batch, img_len), dtype=torch.int32, device=device)], dim=1)
        layers, width = cfg.num_text_layers, cfg.text_hidden_dim
        text = encoder_hidden_states.to(dtype).reshape(batch * txt_len, layers, width)
        for i in range(cfg.num_layerwise_text_blocks):
            text = getattr(self, f"text_layerwise_{i}")(text)
        text = text.reshape(batch, txt_len, layers, width).transpose(2, 3)
        text = (text @ self.text_projector.to(text.dtype))[..., 0]
        for i in range(cfg.num_refiner_text_blocks):
            text = getattr(self, f"text_refiner_{i}")(text, text_ids)
        text = self.txt_in_1(zrms(text, self.txt_norm, cfg.norm_eps))
        text = self.txt_in_2(F.gelu(text, approximate="tanh"))

        stream = torch.cat([text, self.img_in(hidden_states.to(dtype))], dim=1)
        angles = axial_rope(cfg.axes_dims_rope, position_ids.to(device), cfg.rope_theta)
        for i in range(cfg.num_layers):
            stream = self._run(f"block_{i}", stream, temb_mod, angles, full_ids)

        img = stream[:, txt_len:]
        mod = temb.to(torch.float32) + self.final_scale_shift_table.to(torch.float32)[None]
        scale, shift = mod[:, 0:1], mod[:, 1:2]
        img = ((1.0 + scale) * zrms(img, self.final_norm, cfg.norm_eps).to(torch.float32) + shift).to(dtype)
        return self.final_linear(img).to(torch.float32)
