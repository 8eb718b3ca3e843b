"""T5 encoder (T5-XXL for Flux, Pile-T5-XL for AuraFlow, the tiny test config), the port's own module.

Counterpart of ``transformers``' ``FlaxT5EncoderModel``, which the JAX
package runs (``simpletuner_tpu/models/text_encoders.py:85-95``), so that
encoding needs no ``transformers``.  Submodule names are those of the HF
torch ``T5EncoderModel``, so an HF torch-layout checkpoint (``shared.weight``,
``encoder.block.N.layer.0.SelfAttention.q.weight``, ...) loads by name
(:func:`load_t5_encoder`), and :func:`t5_state_dict_from_flax` maps the Flax
params onto the same names.

What the module keeps of the Flax model: attention takes no scaling; the
relative position bias is bidirectional (32 buckets, max distance 128),
computed in layer 0 only, with the padding mask folded in, and shared by the
later layers; the RMS ``T5LayerNorm`` keeps its variance in f32, and a final
layer norm closes the stack; the feed-forward is ``relu`` (``wi``, ``wo``),
``gated-gelu`` (``wi_0``, ``wi_1``, ``wo``, the tanh gelu) or ``gated-silu``
(the same with silu: Pile-T5).  A ``umt5`` checkpoint (AuraFlow's
``text_encoder``, read through the ``t5-xxl`` family as the JAX package reads
it with ``FlaxT5EncoderModel.from_pretrained``) carries a relative attention
bias in every layer; the Flax model has one in layer 0 only and drops the
others as unused weights, so :func:`load_t5_encoder` drops them too and every
layer takes layer 0's bias (ROADMAP Queue 3).  Products run in
the weights' dtype (bf16 or f32) with norms, the position bias and the
softmax in f32.  The JAX package with ``text_encoder_precision=bf16`` keeps
bf16 weights but computes in f32; the port computes in bf16.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"

    @classmethod
    def xxl(cls) -> "T5Config":
        """google/t5-v1_1-xxl's encoder, Flux's ``text_encoder_2`` (4.76B parameters)."""
        return cls()

    @classmethod
    def pile_xl(cls) -> "T5Config":
        """EleutherAI's Pile-T5-XL encoder, AuraFlow's ``text_encoder`` (a
        ``umt5`` config.json: d_model 2048, 32 heads of 64, d_ff 5120,
        gated-silu; 1.2B parameters)."""
        return cls(d_model=2048, d_ff=5120, num_heads=32, feed_forward_proj="gated-silu")

    @classmethod
    def tiny(cls, feed_forward_proj: str = "relu") -> "T5Config":
        """The JAX package's tiny test encoder (text_encoders.py:89)."""
        return cls(vocab_size=1000, d_model=32, d_ff=64, num_layers=2, num_heads=2, d_kv=16,
                   feed_forward_proj=feed_forward_proj)

    @classmethod
    def from_hf(cls, values: Mapping[str, Any]) -> "T5Config":
        """From an HF ``config.json`` dict."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in values.items() if k in names})

    @property
    def gated(self) -> bool:
        """True for ``gated-gelu`` and ``gated-silu``, False for ``relu``;
        other forms raise."""
        if self.feed_forward_proj not in ("relu", "gated-gelu", "gated-silu"):
            raise NotImplementedError(f"feed_forward_proj={self.feed_forward_proj!r} is not ported "
                                      "(relu, gated-gelu, gated-silu)")
        return self.feed_forward_proj != "relu"


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional bucket of ``memory - query`` positions (the Flax
    ``_relative_position_bucket`` with ``bidirectional=True``)."""
    num_buckets //= 2
    buckets = (relative_position > 0).to(torch.int64) * num_buckets
    distance = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = distance < max_exact
    scaled = torch.log(distance.to(torch.float32) / max_exact) / math.log(max_distance / max_exact)
    large = (max_exact + scaled * (num_buckets - max_exact)).clamp(max=num_buckets - 1)
    return buckets + torch.where(is_small, distance.to(torch.float32), large).to(torch.int64)


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_f = x.to(torch.float32)
        variance = x_f.square().mean(dim=-1, keepdim=True)
        return (self.weight.to(torch.float32) * (x_f / torch.sqrt(variance + self.eps))).to(self.weight.dtype)


class T5Attention(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.config = config
        inner = config.num_heads * config.d_kv
        self.q = nn.Linear(config.d_model, inner, bias=False, dtype=dtype)
        self.k = nn.Linear(config.d_model, inner, bias=False, dtype=dtype)
        self.v = nn.Linear(config.d_model, inner, bias=False, dtype=dtype)
        self.o = nn.Linear(inner, config.d_model, bias=False, dtype=dtype)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(config.relative_attention_num_buckets, config.num_heads,
                                                        dtype=dtype)

    def compute_bias(self, length: int, device: torch.device) -> torch.Tensor:
        """(1, heads, length, length) f32 relative position bias."""
        position = torch.arange(length, device=device)
        buckets = relative_position_bucket(position[None, :] - position[:, None],
                                           self.config.relative_attention_num_buckets,
                                           self.config.relative_attention_max_distance)
        return self.relative_attention_bias(buckets).to(torch.float32).permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        batch, length, _ = x.shape
        heads, d_kv = self.config.num_heads, self.config.d_kv

        def split(t: torch.Tensor) -> torch.Tensor:
            return t.view(batch, length, heads, d_kv).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        scores = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32) + bias  # no 1/sqrt(d) in T5
        weights = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(batch, length, heads * d_kv)
        return self.o(out)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.SelfAttention = T5Attention(config, has_relative_bias, dtype)
        self.layer_norm = T5LayerNorm(config.d_model, config.layer_norm_epsilon, dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return x + self.SelfAttention(self.layer_norm(x), bias)


class T5DenseActDense(nn.Module):
    def __init__(self, config: T5Config, dtype: torch.dtype) -> None:
        super().__init__()
        self.wi = nn.Linear(config.d_model, config.d_ff, bias=False, dtype=dtype)
        self.wo = nn.Linear(config.d_ff, config.d_model, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.relu(self.wi(x)))


class T5DenseGatedActDense(nn.Module):
    def __init__(self, config: T5Config, dtype: torch.dtype) -> None:
        super().__init__()
        self.silu = config.feed_forward_proj == "gated-silu"
        self.wi_0 = nn.Linear(config.d_model, config.d_ff, bias=False, dtype=dtype)
        self.wi_1 = nn.Linear(config.d_model, config.d_ff, bias=False, dtype=dtype)
        self.wo = nn.Linear(config.d_ff, config.d_model, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = self.wi_0(x)
        gate = F.silu(gate) if self.silu else F.gelu(gate, approximate="tanh")
        return self.wo(gate * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, config: T5Config, dtype: torch.dtype) -> None:
        super().__init__()
        # the HF attribute name, whatever the activation
        self.DenseReluDense = T5DenseGatedActDense(config, dtype) if config.gated else T5DenseActDense(config, dtype)
        self.layer_norm = T5LayerNorm(config.d_model, config.layer_norm_epsilon, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(config, has_relative_bias, dtype), T5LayerFF(config, dtype)])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.layer[1](self.layer[0](x, bias))


class T5Stack(nn.Module):
    def __init__(self, config: T5Config, dtype: torch.dtype) -> None:
        super().__init__()
        self.block = nn.ModuleList([T5Block(config, i == 0, dtype) for i in range(config.num_layers)])
        self.final_layer_norm = T5LayerNorm(config.d_model, config.layer_norm_epsilon, dtype)


class T5EncoderModel(nn.Module):
    def __init__(self, config: T5Config, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model, dtype=dtype)
        self.encoder = T5Stack(config, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded weights at HF's T5 initialisation scale (``_init_weights``,
        factor 1): the attention logits and the residual stream keep unit
        scale, as in a trained T5."""
        c = self.config
        inner = c.num_heads * c.d_kv
        self.shared.weight.normal_(0.0, 1.0, generator=generator)
        for sub in self.modules():
            if isinstance(sub, T5Attention):
                sub.q.weight.normal_(0.0, (c.d_model * c.d_kv) ** -0.5, generator=generator)
                sub.k.weight.normal_(0.0, c.d_model ** -0.5, generator=generator)
                sub.v.weight.normal_(0.0, c.d_model ** -0.5, generator=generator)
                sub.o.weight.normal_(0.0, inner ** -0.5, generator=generator)
                if hasattr(sub, "relative_attention_bias"):
                    sub.relative_attention_bias.weight.normal_(0.0, c.d_model ** -0.5, generator=generator)
            elif isinstance(sub, (T5DenseActDense, T5DenseGatedActDense)):
                for name in ("wi", "wi_0", "wi_1"):
                    if hasattr(sub, name):
                        getattr(sub, name).weight.normal_(0.0, c.d_model ** -0.5, generator=generator)
                sub.wo.weight.normal_(0.0, c.d_ff ** -0.5, generator=generator)
            elif isinstance(sub, T5LayerNorm):
                sub.weight.fill_(1.0)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``last_hidden_state`` (B, S, d_model) in the weights' dtype."""
        hidden = self.shared(input_ids.to(torch.int64))
        bias = self.encoder.block[0].layer[0].SelfAttention.compute_bias(input_ids.shape[1], input_ids.device)
        if attention_mask is not None:
            masked = torch.finfo(torch.float32).min
            bias = bias + torch.where(attention_mask[:, None, None, :] > 0, 0.0, masked)
        for block in self.encoder.block:
            hidden = block(hidden, bias)
        return {"last_hidden_state": self.encoder.final_layer_norm(hidden)}


def t5_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``FlaxT5EncoderModel``'s params (nested dicts of arrays) as the
    port's state dict: dense ``kernel`` (in, out) -> ``weight`` (out, in),
    ``embedding`` -> ``weight``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            array = torch.from_numpy(np.array(value, dtype=np.float32))
            if key == "kernel":
                out[f"{prefix}weight"] = array.t().contiguous()
            elif key == "embedding":
                out[f"{prefix}weight"] = array
            else:
                out[f"{prefix}{key}"] = array

    walk(params, "")
    return out


def load_t5_encoder(path: str, dtype: torch.dtype = torch.float32, device=None) -> T5EncoderModel:
    """An HF torch-layout T5 or UMT5 encoder directory (``config.json`` and
    ``*.safetensors`` shards, e.g. Flux's ``text_encoder_2/`` or AuraFlow's
    ``text_encoder/``).  A UMT5 file's relative attention biases of layers
    1 and up are dropped, as the Flax model drops them."""
    from .weight_import import read_safetensors

    with open(os.path.join(path, "config.json")) as handle:
        config = T5Config.from_hf(json.load(handle))
    weights = read_safetensors(path)
    weights.pop("encoder.embed_tokens.weight", None)  # tied to shared.weight
    for layer in range(1, config.num_layers):
        weights.pop(f"encoder.block.{layer}.layer.0.SelfAttention.relative_attention_bias.weight", None)
    with torch.device(device or "cpu"):
        model = T5EncoderModel(config, dtype)
    model.load_state_dict(weights)
    return model.eval()
