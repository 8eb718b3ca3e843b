"""Anima transformer in PyTorch: an LLM adapter and the Cosmos core.

Counterpart of ``simpletuner_tpu/models/anima/transformer.py``
(``AnimaTransformerModel``): the adapter (``_LLMAdapter``) translates
Qwen3-0.6B hidden states onto the caption's T5-token grid, and its output,
padded with zeros to ``adapter_pad_length`` tokens, is the cross-attention
context of the Cosmos core (``models/cosmos1/transformer.py``, 16 heads of
128, 28 layers, rope scale (1, 4, 4)).

The adapter: a T5-id embedding (32,128 rows; an id past the table reads NaN
and a negative one wraps, as ``jnp.take`` does), then per block a pre-RMS
self-attention over the T5 tokens (1-D rope at theta 1e4, the angles
repeated half-wise, rotate-half), a pre-RMS cross-attention into the Qwen
states (the queries at the target positions, the keys at the source ones)
and a biased exact-gelu MLP x 4; bias-free q/k/v/o with per-head affine RMS
norms; RMS eps 1e-6 throughout; ``norm(out_proj(x))`` last.  The adapter
carries no LoRA adapters.  Its attentions (head dim 64, over the 64 T5
tokens and the Qwen tokens) and the core's go through
:func:`dot_product_attention`: the flash kernels on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import dot_product_attention
from ..cosmos1.transformer import Cosmos1Config, Cosmos1Transformer, apply_half_rope, rms
from ..layers import LoRADense, take_rows

Angles = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AnimaConfig:
    core: Cosmos1Config = dataclasses.field(default_factory=Cosmos1Config.anima)
    adapter_vocab_size: int = 32128
    adapter_dim: int = 1024
    adapter_layers: int = 6
    adapter_heads: int = 16
    adapter_pad_length: int = 512

    @classmethod
    def tiny(cls) -> "AnimaConfig":
        return cls(
            core=dataclasses.replace(Cosmos1Config.tiny(), text_embed_dim=32),
            adapter_vocab_size=64, adapter_dim=32, adapter_layers=1,
            adapter_heads=2, adapter_pad_length=16,
        )


def adapter_rope(length: int, head_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """cos and sin (S, head_dim) f32 of the half-repeated angles, made in float64."""
    inv = 1.0 / (10000.0 ** ((2.0 / head_dim) * np.arange(head_dim // 2, dtype=np.float64)))
    ang = np.outer(np.arange(length, dtype=np.float64), inv)
    full = np.concatenate([ang, ang], axis=-1)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


class AnimaAdapterAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        hd = dim // heads
        self.q_proj = LoRADense(dim, dim, use_bias=False, dtype=dtype)
        self.k_proj = LoRADense(context_dim, dim, use_bias=False, dtype=dtype)
        self.v_proj = LoRADense(context_dim, dim, use_bias=False, dtype=dtype)
        self.q_norm = nn.Parameter(torch.empty(hd, dtype=torch.float32))
        self.k_norm = nn.Parameter(torch.empty(hd, dtype=torch.float32))
        self.o_proj = LoRADense(dim, dim, use_bias=False, dtype=dtype)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.q_norm.fill_(1.0)
        self.k_norm.fill_(1.0)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor], rope_q: Angles, rope_k: Angles) -> torch.Tensor:
        hd = self.dim // self.heads
        ctx = x if context is None else context
        batch = x.shape[0]
        q = rms(self.q_proj(x).reshape(batch, -1, self.heads, hd), self.q_norm, 1e-6)
        k = rms(self.k_proj(ctx).reshape(batch, -1, self.heads, hd), self.k_norm, 1e-6)
        v = self.v_proj(ctx).reshape(batch, -1, self.heads, hd)
        q, k = apply_half_rope(q, rope_q), apply_half_rope(k, rope_k)
        out = dot_product_attention(q, k, v)
        return self.o_proj(out.reshape(batch, -1, self.dim).to(self.dtype))


class AnimaLLMAdapter(nn.Module):
    def __init__(self, config: AnimaConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim = config.adapter_dim
        self.embed = nn.Parameter(torch.empty(config.adapter_vocab_size, dim, dtype=torch.float32))
        for i in range(config.adapter_layers):
            for norm in ("self", "cross", "mlp"):
                self.register_parameter(f"block_{i}_norm_{norm}", nn.Parameter(torch.empty(dim, dtype=torch.float32)))
            self.add_module(f"block_{i}_self", AnimaAdapterAttention(dim, dim, config.adapter_heads, dtype))
            self.add_module(f"block_{i}_cross", AnimaAdapterAttention(dim, dim, config.adapter_heads, dtype))
            self.add_module(f"block_{i}_mlp_in", LoRADense(dim, dim * 4, dtype=dtype))
            self.add_module(f"block_{i}_mlp_out", LoRADense(dim * 4, dim, dtype=dtype))
        self.out_proj = LoRADense(dim, dim, dtype=dtype)
        self.norm = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self._tables: Dict[Tuple[int, torch.device], Angles] = {}

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.embed.normal_(0.0, 0.02, generator=generator)
        for i in range(self.config.adapter_layers):
            for norm in ("self", "cross", "mlp"):
                getattr(self, f"block_{i}_norm_{norm}").fill_(1.0)
        self.norm.fill_(1.0)

    def rope_table(self, length: int, device: torch.device) -> Angles:
        """The adapter's rope tables for ``length`` tokens, made once per length and device."""
        key = (length, device)
        if key not in self._tables:
            cos, sin = adapter_rope(length, self.config.adapter_dim // self.config.adapter_heads)
            self._tables[key] = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))
        return self._tables[key]

    def embed_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """``jnp.take(embed, ids, axis=0)``: negative ids wrap once, ids past the table read NaN."""
        return take_rows(self.embed, ids)

    def forward(self, source_hidden: torch.Tensor, target_ids: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self.embed_ids(target_ids).to(self.dtype)
        rope_t = self.rope_table(x.shape[1], x.device)
        rope_s = self.rope_table(source_hidden.shape[1], x.device)
        source = source_hidden.to(self.dtype)
        for i in range(cfg.adapter_layers):
            x = x + getattr(self, f"block_{i}_self")(rms(x, getattr(self, f"block_{i}_norm_self"), 1e-6), None,
                                                     rope_t, rope_t)
            x = x + getattr(self, f"block_{i}_cross")(rms(x, getattr(self, f"block_{i}_norm_cross"), 1e-6), source,
                                                      rope_t, rope_s)
            h = getattr(self, f"block_{i}_mlp_in")(rms(x, getattr(self, f"block_{i}_norm_mlp"), 1e-6))
            x = x + getattr(self, f"block_{i}_mlp_out")(F.gelu(h, approximate="none"))
        return rms(self.out_proj(x), self.norm, 1e-6)


class AnimaTransformer(nn.Module):
    """Adapter and core.  ``latents`` (B, T, H, W, C), ``timesteps`` (B,) flow
    sigmas, ``text_embeds`` (B, S, adapter_dim) Qwen states, ``t5_ids`` (B,
    T5 length) and optional per-token ``t5_weights``; returns (B, T, H, W,
    C) f32."""

    def __init__(self, config: AnimaConfig = AnimaConfig(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config = config
        self.llm_adapter = AnimaLLMAdapter(config, dtype)
        self.core = Cosmos1Transformer(config.core, dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha,
                                       lora_algo=lora_algo, remat=remat)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, text_embeds: torch.Tensor,
                t5_ids: torch.Tensor, t5_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        adapted = self.llm_adapter(text_embeds, t5_ids)
        if t5_weights is not None:
            adapted = adapted * t5_weights[..., None].to(adapted.dtype)
        pad = self.config.adapter_pad_length - adapted.shape[1]
        if pad > 0:
            adapted = F.pad(adapted, (0, 0, 0, pad))
        return self.core(latents, timesteps, adapted)
