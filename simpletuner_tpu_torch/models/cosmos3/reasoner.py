"""Cosmos3 frozen reasoner in PyTorch.

Counterpart of ``simpletuner_tpu/models/cosmos3/reasoner.py``
(``Cosmos3Reasoner``): the MoT's understanding pathway split out as a frozen
causal text stack, run once over the reasoning ids.  Each layer returns its
hidden state and its memory pair, the keys after the q/k RMS norm and the
mRoPE and the raw values, which the generator-only
:class:`~.transformer.Cosmos3OmniTransformer` replays (``reasoner_kv``).
The causal GQA attention is the plain f32 block of the understanding
pathway (K and V repeated as ``jnp.repeat``, no padding mask).  Only the
shipped dense-silu configuration is ported, as in the JAX package.

The checkpoint keys (``embed_tokens.weight``, ``layers.N.self_attn.to_q``,
``layers.N.mlp.gate_proj``, ``layers.N.input_layernorm.weight``) are the MoT
file's understanding-pathway names, so :func:`load_cosmos3_reasoner` reads
them from that file too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..cosmos1.transformer import rms
from ..layers import LoRADense, take_rows
from ..omnigen.transformer import prefix_attention
from .transformer import Cosmos3Config, _apply_mrope, cosmos3_mrope, repeat_kv


@dataclasses.dataclass(frozen=True)
class Cosmos3ReasonerConfig:
    vocab_size: int = 151936
    hidden_size: int = 4096
    head_dim: int = 128
    num_heads: int = 32
    num_kv_heads: int = 8
    num_layers: int = 36
    intermediate_size: int = 12288
    rope_theta: float = 5_000_000.0
    rope_axes_dim: Tuple[int, int, int] = (24, 20, 20)
    rms_norm_eps: float = 1e-6
    attention_bias: bool = False

    @classmethod
    def tiny(cls) -> "Cosmos3ReasonerConfig":
        return cls(
            vocab_size=64, hidden_size=32, head_dim=16, num_heads=2, num_kv_heads=1,
            num_layers=2, intermediate_size=64, rope_axes_dim=(4, 2, 2),
        )

    def as_transformer_config(self) -> Cosmos3Config:
        """The matching MoT config (shared rope and head geometry) for replay."""
        return Cosmos3Config(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            head_dim=self.head_dim, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, num_layers=self.num_layers,
            intermediate_size=self.intermediate_size, rope_theta=self.rope_theta,
            rope_axes_dim=self.rope_axes_dim, rms_norm_eps=self.rms_norm_eps,
            attention_bias=self.attention_bias,
        )


_NORMS = ("input_layernorm", "post_attention_layernorm", "norm_q", "norm_k")


class Cosmos3ReasonerLayer(nn.Module):
    """One causal GQA layer; returns ``(x, (roped k, raw v))``."""

    def __init__(self, config: Cosmos3ReasonerConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, hd = config.hidden_size, config.head_dim
        common = dict(use_bias=config.attention_bias, dtype=dtype)
        self.to_q = LoRADense(dim, config.num_heads * hd, **common)
        self.to_k = LoRADense(dim, config.num_kv_heads * hd, **common)
        self.to_v = LoRADense(dim, config.num_kv_heads * hd, **common)
        self.to_out = LoRADense(config.num_heads * hd, dim, **common)
        self.gate_proj = LoRADense(dim, config.intermediate_size, **common)
        self.up_proj = LoRADense(dim, config.intermediate_size, **common)
        self.down_proj = LoRADense(config.intermediate_size, dim, **common)
        for name in _NORMS:
            size = hd if name.startswith("norm_") else dim
            self.register_parameter(name, nn.Parameter(torch.empty(size, dtype=torch.float32)))

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for name in _NORMS:
            getattr(self, name).fill_(1.0)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
        cfg = self.config
        eps, hd = cfg.rms_norm_eps, cfg.head_dim
        batch, seq = x.shape[:2]
        x_n = rms(x, self.input_layernorm, eps)
        q = self.to_q(x_n).reshape(batch, seq, cfg.num_heads, hd)
        k = self.to_k(x_n).reshape(batch, seq, cfg.num_kv_heads, hd)
        v = self.to_v(x_n).reshape(batch, seq, cfg.num_kv_heads, hd)
        q = _apply_mrope(rms(q, self.norm_q, eps), cos, sin)
        k = _apply_mrope(rms(k, self.norm_k, eps), cos, sin)
        n_rep = cfg.num_heads // cfg.num_kv_heads
        attn = prefix_attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep), None)
        x = x + self.to_out(attn.reshape(batch, seq, cfg.num_heads * hd).to(self.dtype))
        x_n = rms(x, self.post_attention_layernorm, eps)
        x = x + self.down_proj(F.silu(self.gate_proj(x_n)) * self.up_proj(x_n))
        return x, (k, v)


class Cosmos3Reasoner(nn.Module):
    """``text_ids`` (B, S) and ``position_ids`` (B, 3, S) -> a tuple of
    ``num_layers`` (k, v) pairs, k roped (B, S, kv_heads, head_dim)."""

    def __init__(self, config: Cosmos3ReasonerConfig = Cosmos3ReasonerConfig(),
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        self.embed_tokens = nn.Parameter(torch.empty(config.vocab_size, config.hidden_size, dtype=torch.float32))
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", Cosmos3ReasonerLayer(config, dtype))

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.embed_tokens.normal_(0.0, 0.02, generator=generator)

    def forward(self, text_ids: torch.Tensor, position_ids: torch.Tensor):
        cfg = self.config
        x = take_rows(self.embed_tokens, text_ids).to(self.dtype)
        cos, sin = cosmos3_mrope(cfg.as_transformer_config(), position_ids)
        memory = []
        for i in range(cfg.num_layers):
            x, kv = getattr(self, f"layer_{i}")(x, cos, sin)
            memory.append(kv)
        return tuple(memory)


def cosmos3_reasoner_params(w: Mapping[str, torch.Tensor], config: Cosmos3ReasonerConfig) -> Dict[str, Any]:
    """A ``Cosmos3Reasoner`` state dict (``layers.N.self_attn.to_q``,
    ``layers.N.mlp.gate_proj``, ``layers.N.input_layernorm``) as the Flax
    ``{"params": ...}`` tree of :class:`Cosmos3Reasoner`."""
    from ..weight_import import _float, _linear

    params: Dict[str, Any] = {"embed_tokens": _float(w["embed_tokens.weight"])}
    for i in range(config.num_layers):
        src = f"layers.{i}"
        params[f"layer_{i}"] = {
            "to_q": _linear(w, f"{src}.self_attn.to_q"),
            "to_k": _linear(w, f"{src}.self_attn.to_k"),
            "to_v": _linear(w, f"{src}.self_attn.to_v"),
            "to_out": _linear(w, f"{src}.self_attn.to_out"),
            "norm_q": _float(w[f"{src}.self_attn.norm_q.weight"]),
            "norm_k": _float(w[f"{src}.self_attn.norm_k.weight"]),
            "input_layernorm": _float(w[f"{src}.input_layernorm.weight"]),
            "post_attention_layernorm": _float(w[f"{src}.post_attention_layernorm.weight"]),
            "gate_proj": _linear(w, f"{src}.mlp.gate_proj"),
            "up_proj": _linear(w, f"{src}.mlp.up_proj"),
            "down_proj": _linear(w, f"{src}.mlp.down_proj"),
        }
    return {"params": params}


def load_cosmos3_reasoner(config: Cosmos3ReasonerConfig, path: str) -> Dict[str, Any]:
    """The ``{"params": ...}`` tree of a reasoner component file (or the MoT
    file, whose understanding pathway has the same names)."""
    from ..weight_import import read_safetensors

    return cosmos3_reasoner_params(read_safetensors(path), config)
