"""CLIP text model (CLIP-L, CLIP-G, the tiny test config), the port's own module.

Counterpart of ``transformers``' ``FlaxCLIPTextModel``, which the JAX package
runs (``simpletuner_tpu/models/text_encoders.py:65-82``), so that encoding
needs no ``transformers``.  Submodule names are those of the HF torch
``CLIPTextModel`` (``text_model.encoder.layers.N.self_attn.q_proj.weight``,
...), so an HF torch-layout checkpoint loads by name (:func:`load_clip_text`),
and :func:`clip_state_dict_from_flax` maps the Flax params onto the same
names.

Pre-LN blocks with ``quick_gelu`` (CLIP-L) or the exact erf ``gelu``
(OpenCLIP bigG, SD3's CLIP-G), attention scaled by head_dim^-0.5 under a
causal mask combined with the padding mask, and a final layer norm (eps
1e-5).  The pooled output copies HF's rule exactly: with ``eos_token_id ==
2`` (configs written before HF fixed CLIP's eos id, Flux's CLIP-L among them)
it takes the position of ``argmax(input_ids)``; otherwise the first position
where ``input_ids == eos_token_id``, and position 0 when no token matches (the
JAX tiny tokenizer against the default eos id 49407).  Products run in the
weights' dtype, layer norms and the softmax in f32.  CLIP-G is a plain text
model here, as the JAX package builds it (a ``FlaxCLIPTextModel``): its
pooled output is ``pooler_output``, and an HF ``CLIPTextModelWithProjection``
file's ``text_projection`` is not read.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    eos_token_id: int = 2

    @classmethod
    def clip_l(cls) -> "CLIPTextConfig":
        """openai/clip-vit-large-patch14's text tower, Flux's ``text_encoder`` (123M parameters)."""
        return cls()

    @classmethod
    def clip_g(cls) -> "CLIPTextConfig":
        """OpenCLIP ViT-bigG/14's text tower in the HF layout, SD3's ``text_encoder_2`` (695M parameters)."""
        return cls(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32, num_attention_heads=20,
                   hidden_act="gelu")

    @classmethod
    def open_clip_h(cls) -> "CLIPTextConfig":
        """OpenCLIP ViT-H/14's text tower in the HF layout, SD 2.x's ``text_encoder`` (340M parameters)."""
        return cls(hidden_size=1024, intermediate_size=4096, num_hidden_layers=23, num_attention_heads=16,
                   hidden_act="gelu")

    @classmethod
    def tiny(cls, hidden_size: int = 32, max_position_embeddings: int = 77) -> "CLIPTextConfig":
        """The JAX package's tiny test encoder (text_encoders.py:69-76; HF's default eos id)."""
        return cls(vocab_size=1000, hidden_size=hidden_size, intermediate_size=64, num_hidden_layers=2,
                   num_attention_heads=2, max_position_embeddings=max_position_embeddings, eos_token_id=49407)

    @classmethod
    def from_hf(cls, values: Mapping[str, Any]) -> "CLIPTextConfig":
        """From an HF ``config.json`` dict (HF's defaults where it is silent)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{"eos_token_id": 49407, **{k: v for k, v in values.items() if k in names}})


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.to(torch.float32), norm.normalized_shape, norm.weight.to(torch.float32),
                        norm.bias.to(torch.float32), norm.eps).to(norm.weight.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, config: CLIPTextConfig, dtype: torch.dtype) -> None:
        super().__init__()
        dim = config.hidden_size
        self.heads = config.num_attention_heads
        self.q_proj = nn.Linear(dim, dim, dtype=dtype)
        self.k_proj = nn.Linear(dim, dim, dtype=dtype)
        self.v_proj = nn.Linear(dim, dim, dtype=dtype)
        self.out_proj = nn.Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        batch, length, dim = x.shape
        head_dim = dim // self.heads

        def split(t: torch.Tensor) -> torch.Tensor:
            return t.view(batch, length, self.heads, head_dim).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        scores = torch.matmul(q * head_dim ** -0.5, k.transpose(-1, -2)).to(torch.float32) + bias
        weights = torch.softmax(scores, dim=-1).to(v.dtype)
        return self.out_proj(torch.matmul(weights, v).transpose(1, 2).reshape(batch, length, dim))


# HF ACT2FN: quick_gelu x * sigmoid(1.702 x), gelu the exact erf form
_ACTIVATIONS = {
    "quick_gelu": lambda h: h * torch.sigmoid(1.702 * h),
    "gelu": lambda h: F.gelu(h, approximate="none"),
}


class CLIPMLP(nn.Module):
    def __init__(self, config: CLIPTextConfig, dtype: torch.dtype) -> None:
        super().__init__()
        if config.hidden_act not in _ACTIVATIONS:
            raise NotImplementedError(f"hidden_act={config.hidden_act!r} is not ported ({', '.join(_ACTIVATIONS)})")
        self.act = _ACTIVATIONS[config.hidden_act]
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size, dtype=dtype)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, config: CLIPTextConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.self_attn = CLIPAttention(config, dtype)
        self.layer_norm1 = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps, dtype=dtype)
        self.mlp = CLIPMLP(config, dtype)
        self.layer_norm2 = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps, dtype=dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(_layer_norm(self.layer_norm1, x), bias)
        return x + self.mlp(_layer_norm(self.layer_norm2, x))


class CLIPEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(config, dtype) for _ in range(config.num_hidden_layers)])


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, config: CLIPTextConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.token_embedding = nn.Embedding(config.vocab_size, config.hidden_size, dtype=dtype)
        self.position_embedding = nn.Embedding(config.max_position_embeddings, config.hidden_size, dtype=dtype)


class CLIPTextTransformer(nn.Module):
    def __init__(self, config: CLIPTextConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(config, dtype)
        self.encoder = CLIPEncoder(config, dtype)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps, dtype=dtype)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config, dtype)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``last_hidden_state`` (B, S, hidden) and ``pooler_output`` (B, hidden)."""
        text = self.text_model
        ids = input_ids.to(torch.int64)
        length = ids.shape[1]
        positions = torch.arange(length, device=ids.device)
        hidden = text.embeddings.token_embedding(ids) + text.embeddings.position_embedding(positions)[None]
        allowed = (positions[None, :] <= positions[:, None])[None, None]  # causal
        if attention_mask is not None:
            allowed = allowed & (attention_mask[:, None, None, :] > 0)
        bias = torch.where(allowed, 0.0, torch.finfo(torch.float32).min)
        for layer in text.encoder.layers:
            hidden = layer(hidden, bias)
        hidden = _layer_norm(text.final_layer_norm, hidden)
        if self.config.eos_token_id == 2:
            pool_at = ids.argmax(dim=-1)
        else:
            pool_at = (ids == self.config.eos_token_id).to(torch.int32).argmax(dim=-1)
        pooled = hidden[torch.arange(hidden.shape[0], device=ids.device), pool_at]
        return {"last_hidden_state": hidden, "pooler_output": pooled}


def clip_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``FlaxCLIPTextModel``'s params as the port's state dict: dense
    ``kernel`` (in, out) -> ``weight`` (out, in), ``embedding`` -> ``weight``,
    layer norm ``scale`` -> ``weight``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            array = torch.from_numpy(np.array(value, dtype=np.float32))
            if key == "kernel":
                out[f"{prefix}weight"] = array.t().contiguous()
            elif key in ("embedding", "scale"):
                out[f"{prefix}weight"] = array
            else:
                out[f"{prefix}{key}"] = array

    walk(params, "")
    return out


def load_clip_text(path: str, dtype: torch.dtype = torch.float32, device=None) -> CLIPTextModel:
    """An HF torch-layout CLIP text model directory (``config.json`` and
    ``*.safetensors``, e.g. Flux's ``text_encoder/`` or SD3's ``text_encoder_2/``)."""
    from .weight_import import read_safetensors

    with open(os.path.join(path, "config.json")) as handle:
        config = CLIPTextConfig.from_hf(json.load(handle))
    weights = read_safetensors(path)
    weights.pop("text_model.embeddings.position_ids", None)  # a buffer older files carry
    # a CLIPTextModelWithProjection file (SD3's text_encoder_2): the JAX
    # package reads it as a plain FlaxCLIPTextModel, without the projection
    weights.pop("text_projection.weight", None)
    with torch.device(device or "cpu"):
        model = CLIPTextModel(config, dtype)
    model.load_state_dict(weights)
    return model.eval()
