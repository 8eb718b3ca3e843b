"""Decoder-LLM text encoders (Gemma-2, Qwen2.5, Llama-3, Mistral-3, ChatGLM) in PyTorch.

Counterpart of ``simpletuner_tpu/models/llm_encoder.py``: one pre-norm RoPE
causal trunk covers every layout, which differ only in

* the RMSNorm placement (Gemma-2 sandwiches attention and the feed-forward
  with pre and post norms) and parameterisation (Gemma stores the scale as
  an offset from 1, zero at init),
* the activation (silu or tanh-gelu) and qkv biases (Qwen2, ChatGLM),
* the grouped-query sizes, the RoPE theta, and ChatGLM's partial rotary
  over interleaved (even, odd) pairs of the first half of each head,
* Gemma's ``sqrt(hidden)`` embedding scale (cast to the compute dtype
  first) and Gemma-2's tanh softcap of 50 on the attention logits with its
  ``query_pre_attn_scalar ** -0.5`` scale.

Submodules keep the JAX names (``layers_{i}.q_proj``, ``input_norm``,
``final_norm``, the ``embed_tokens`` table), so the bridge maps a Flax tree
by name.  As in the JAX module the products run in the compute dtype (bf16
by default) with the norms in f32; the linear weights and the embedding
table are held in the compute dtype (the JAX module casts its f32 params at
use, so the arithmetic is the same) and the norm scales in f32.  The
attention is the JAX module's dense f32 einsum: scores in f32 with the
causal x padding mask at -1e30, softmax, then the f32 product with v; it
never reaches the flash kernels.  The RoPE tables are made in float64 on
the host, once per sequence length and device.  The module returns the
final-norm hidden states (not the penultimate layer's: ROADMAP Queue 3),
and with ``output_hidden_states`` also the embeddings and each block's
output.  :func:`llm_params_from_hf` reads the HF torch layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import LoRADense
from .weight_import import _float


@dataclasses.dataclass(frozen=True)
class LLMEncoderConfig:
    arch: str = "llama"  # llama | qwen2 | mistral | gemma2 | chatglm
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    qkv_bias: bool = False
    act: str = "silu"  # silu | gelu_tanh
    embed_scale: bool = False        # gemma: embeddings * sqrt(hidden)
    sandwich_norms: bool = False     # gemma2 pre+post attention/FFN norms
    rms_unit_offset: bool = False    # gemma RMSNorm: x * (1 + weight)
    attn_softcap: float = 0.0        # gemma2: 50.0
    query_scale: Optional[float] = None  # gemma2: query_pre_attn_scalar ** -0.5
    partial_rotary: float = 1.0      # chatglm: 0.5
    rope_interleaved: bool = False   # chatglm pairs even/odd dims
    fused_qkv: bool = False          # chatglm query_key_value

    # the published HF configs' sizes
    @classmethod
    def gemma2_2b(cls) -> "LLMEncoderConfig":
        return cls(
            arch="gemma2", vocab_size=256000, hidden_size=2304, intermediate_size=9216,
            num_layers=26, num_heads=8, num_kv_heads=4, head_dim=256, rope_theta=10000.0,
            rms_eps=1e-6, act="gelu_tanh", embed_scale=True, sandwich_norms=True,
            rms_unit_offset=True, attn_softcap=50.0, query_scale=256.0 ** -0.5,
        )

    @classmethod
    def qwen25_7b(cls) -> "LLMEncoderConfig":
        return cls(
            arch="qwen2", vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
            rope_theta=1000000.0, rms_eps=1e-6, qkv_bias=True,
        )

    @classmethod
    def llama3_8b(cls) -> "LLMEncoderConfig":
        return cls()

    @classmethod
    def mistral3_24b(cls) -> "LLMEncoderConfig":
        return cls(
            arch="mistral", vocab_size=131072, hidden_size=5120, intermediate_size=32768,
            num_layers=40, num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=100000000.0, rms_eps=1e-5,
        )

    @classmethod
    def chatglm3_6b(cls) -> "LLMEncoderConfig":
        return cls(
            arch="chatglm", vocab_size=65024, hidden_size=4096, intermediate_size=13696,
            num_layers=28, num_heads=32, num_kv_heads=2, head_dim=128,
            rope_theta=10000.0, rms_eps=1e-5, qkv_bias=True, fused_qkv=True,
            partial_rotary=0.5, rope_interleaved=True,
        )

    @classmethod
    def tiny(cls, arch: str = "llama") -> "LLMEncoderConfig":
        base = dict(
            vocab_size=1000, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=2, num_kv_heads=1, head_dim=16, rope_theta=10000.0,
        )
        if arch == "gemma2":
            return cls(
                arch=arch, act="gelu_tanh", embed_scale=True, sandwich_norms=True,
                rms_unit_offset=True, attn_softcap=50.0, query_scale=16.0 ** -0.5,
                rms_eps=1e-6, **base,
            )
        if arch == "qwen2":
            return cls(arch=arch, qkv_bias=True, rms_eps=1e-6, **base)
        if arch == "chatglm":
            return cls(
                arch=arch, qkv_bias=True, fused_qkv=True, partial_rotary=0.5,
                rope_interleaved=True, **base,
            )
        return cls(arch=arch, **base)


def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float, unit_offset: bool) -> torch.Tensor:
    xf = x.to(torch.float32)
    norm = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    w = weight.to(torch.float32)
    if unit_offset:
        w = 1.0 + w
    return (norm * w).to(x.dtype)


class _Norm(nn.Module):
    """RMSNorm in f32, back in the input's dtype; Gemma's scale is an offset
    from 1 (zero at init)."""

    def __init__(self, dim: int, eps: float, unit_offset: bool = False) -> None:
        super().__init__()
        self.eps, self.unit_offset = eps, unit_offset
        self.scale = nn.Parameter(torch.empty(dim, dtype=torch.float32))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale.fill_(0.0 if self.unit_offset else 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _rms(x, self.scale, self.eps, self.unit_offset)


def _rope_tables(cfg: LLMEncoderConfig, seq: int) -> Tuple[np.ndarray, np.ndarray]:
    """(S, rot/2) cos and sin tables, made in float64 and rounded to f32 once."""
    rot = int(cfg.head_dim * cfg.partial_rotary)
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    freqs = np.outer(np.arange(seq, dtype=np.float64), inv)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, cfg: LLMEncoderConfig) -> torch.Tensor:
    """x: (B, S, H, D).  Half-split (HF llama) or interleaved pairs (chatglm),
    in f32, on the first ``head_dim * partial_rotary`` dims."""
    rot = int(cfg.head_dim * cfg.partial_rotary)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    xf = x_rot.to(torch.float32)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    if cfg.rope_interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(xf.shape)
    else:
        half = rot // 2
        rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
        out = xf * torch.cat([c, c], dim=-1) + rotated * torch.cat([s, s], dim=-1)
    out = out.to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < cfg.head_dim else out


class LLMBlock(nn.Module):
    def __init__(self, config: LLMEncoderConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        dim, dh = cfg.hidden_size, cfg.head_dim
        dense = dict(dtype=dtype)
        self.input_norm = _Norm(dim, cfg.rms_eps, cfg.rms_unit_offset)
        if cfg.fused_qkv:
            self.qkv_proj = LoRADense(dim, (cfg.num_heads + 2 * cfg.num_kv_heads) * dh, cfg.qkv_bias, **dense)
        else:
            self.q_proj = LoRADense(dim, cfg.num_heads * dh, cfg.qkv_bias, **dense)
            self.k_proj = LoRADense(dim, cfg.num_kv_heads * dh, cfg.qkv_bias, **dense)
            self.v_proj = LoRADense(dim, cfg.num_kv_heads * dh, cfg.qkv_bias, **dense)
        self.o_proj = LoRADense(cfg.num_heads * dh, dim, False, **dense)
        if cfg.sandwich_norms:
            self.post_attn_norm = _Norm(dim, cfg.rms_eps, cfg.rms_unit_offset)
            self.pre_ff_norm = _Norm(dim, cfg.rms_eps, cfg.rms_unit_offset)
            self.post_ff_norm = _Norm(dim, cfg.rms_eps, cfg.rms_unit_offset)
        else:
            self.post_input_norm = _Norm(dim, cfg.rms_eps, cfg.rms_unit_offset)
        if cfg.arch == "chatglm":
            self.gate_up_proj = LoRADense(dim, 2 * cfg.intermediate_size, False, **dense)
        else:
            self.gate_proj = LoRADense(dim, cfg.intermediate_size, False, **dense)
            self.up_proj = LoRADense(dim, cfg.intermediate_size, False, **dense)
        self.down_proj = LoRADense(cfg.intermediate_size, dim, False, **dense)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        batch, seq = x.shape[:2]
        h = self.input_norm(x)
        if cfg.fused_qkv:
            q, k, v = self.qkv_proj(h).split(
                [cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim],
                dim=-1)
        else:
            q, k, v = self.q_proj(h), self.k_proj(h), self.v_proj(h)
        q = _apply_rope(q.reshape(batch, seq, cfg.num_heads, cfg.head_dim), cos, sin, cfg)
        k = _apply_rope(k.reshape(batch, seq, cfg.num_kv_heads, cfg.head_dim), cos, sin, cfg)
        v = v.reshape(batch, seq, cfg.num_kv_heads, cfg.head_dim)
        repeat = cfg.num_heads // cfg.num_kv_heads
        if repeat > 1:
            k = k.repeat_interleave(repeat, dim=2)
            v = v.repeat_interleave(repeat, dim=2)

        scale = cfg.query_scale if cfg.query_scale is not None else cfg.head_dim ** -0.5
        logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
        if cfg.attn_softcap:
            logits = torch.tanh(logits / cfg.attn_softcap) * cfg.attn_softcap
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
        attn_out = self.o_proj(attn.reshape(batch, seq, cfg.num_heads * cfg.head_dim).to(self.dtype))
        if cfg.sandwich_norms:
            attn_out = self.post_attn_norm(attn_out)
        x = x + attn_out

        pre_ff = self.pre_ff_norm(x) if cfg.sandwich_norms else self.post_input_norm(x)
        if cfg.arch == "chatglm":
            gate, up = self.gate_up_proj(pre_ff).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(pre_ff), self.up_proj(pre_ff)
        act = F.silu(gate) if cfg.act == "silu" else F.gelu(gate, approximate="tanh")
        ff = self.down_proj(act * up)
        if cfg.sandwich_norms:
            ff = self.post_ff_norm(ff)
        return x + ff


class LLMEncoder(nn.Module):
    """Causal LM trunk; ``forward`` returns the final-norm hidden states (B, S, hidden)."""

    def __init__(self, config: LLMEncoderConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        self.embed_tokens = nn.Parameter(torch.empty(config.vocab_size, config.hidden_size, dtype=dtype))
        for i in range(config.num_layers):
            self.add_module(f"layers_{i}", LLMBlock(config, dtype))
        self.final_norm = _Norm(config.hidden_size, config.rms_eps, config.rms_unit_offset)
        self._rope: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded weights with the Flax initialisers: N(0, 0.02) embeddings,
        lecun-normal kernels, zero biases, the norms' ones (zeros for Gemma's
        unit offset)."""
        draw = torch.empty(self.embed_tokens.shape, dtype=torch.float32, device=self.embed_tokens.device)
        self.embed_tokens.copy_(draw.normal_(0.0, 0.02, generator=generator))
        for sub in self.modules():
            if isinstance(sub, (LoRADense, _Norm)):
                sub.reset_parameters(generator)

    def rope(self, seq: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (seq, device)
        if key not in self._rope:
            self._rope[key] = tuple(torch.from_numpy(t).to(device) for t in _rope_tables(self.config, seq))
        return self._rope[key]

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                output_hidden_states: bool = False):
        """Final-norm hidden states; with ``output_hidden_states`` also the
        (num_layers + 1) taps: the scaled embeddings, then each block's output."""
        cfg = self.config
        batch, seq = input_ids.shape
        x = self.embed_tokens[input_ids.long()].to(self.dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=self.dtype, device=x.device)
        cos, sin = self.rope(seq, x.device)
        mask = torch.ones((seq, seq), dtype=torch.bool, device=x.device).tril()[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask.to(torch.bool)[:, None, None, :]
        taps = [x]
        for i in range(cfg.num_layers):
            x = getattr(self, f"layers_{i}")(x, cos, sin, mask)
            taps.append(x)
        out = self.final_norm(x)
        if output_hidden_states:
            return out, tuple(taps)
        return out


def llm_params_from_hf(weights: Mapping[str, torch.Tensor], cfg: LLMEncoderConfig) -> Dict[str, Any]:
    """The Flax-layout tree of an HF causal LM's torch state (``model.*`` for
    the llama / qwen2 / mistral / gemma2 layouts, ``transformer.*`` for
    ChatGLM), leaves as the port's importer reads them (kernels as transposed
    views; f32, bf16 and e4m3 in the file's dtype, the rest through f32)."""
    def lin(key: str, bias_key: Optional[str] = None) -> Dict[str, torch.Tensor]:
        out = {"kernel": _float(weights[key]).t()}
        if bias_key and bias_key in weights:
            out["bias"] = _float(weights[bias_key])
        return out

    def scale(key: str) -> Dict[str, torch.Tensor]:
        return {"scale": _float(weights[key])}

    if cfg.arch == "chatglm":
        p = "transformer.encoder.layers"
        params: Dict[str, Any] = {
            "embed_tokens": _float(weights["transformer.embedding.word_embeddings.weight"]),
            "final_norm": scale("transformer.encoder.final_layernorm.weight"),
        }
        for i in range(cfg.num_layers):
            src = f"{p}.{i}"
            params[f"layers_{i}"] = {
                "input_norm": scale(f"{src}.input_layernorm.weight"),
                "qkv_proj": lin(f"{src}.self_attention.query_key_value.weight",
                                f"{src}.self_attention.query_key_value.bias"),
                "o_proj": lin(f"{src}.self_attention.dense.weight"),
                "post_input_norm": scale(f"{src}.post_attention_layernorm.weight"),
                "gate_up_proj": lin(f"{src}.mlp.dense_h_to_4h.weight"),
                "down_proj": lin(f"{src}.mlp.dense_4h_to_h.weight"),
            }
        return params

    params = {
        "embed_tokens": _float(weights["model.embed_tokens.weight"]),
        "final_norm": scale("model.norm.weight"),
    }
    for i in range(cfg.num_layers):
        src = f"model.layers.{i}"
        layer: Dict[str, Any] = {
            "input_norm": scale(f"{src}.input_layernorm.weight"),
            "q_proj": lin(f"{src}.self_attn.q_proj.weight", f"{src}.self_attn.q_proj.bias"),
            "k_proj": lin(f"{src}.self_attn.k_proj.weight", f"{src}.self_attn.k_proj.bias"),
            "v_proj": lin(f"{src}.self_attn.v_proj.weight", f"{src}.self_attn.v_proj.bias"),
            "o_proj": lin(f"{src}.self_attn.o_proj.weight"),
            "gate_proj": lin(f"{src}.mlp.gate_proj.weight"),
            "up_proj": lin(f"{src}.mlp.up_proj.weight"),
            "down_proj": lin(f"{src}.mlp.down_proj.weight"),
        }
        if cfg.sandwich_norms:
            layer["post_attn_norm"] = scale(f"{src}.post_attention_layernorm.weight")
            layer["pre_ff_norm"] = scale(f"{src}.pre_feedforward_layernorm.weight")
            layer["post_ff_norm"] = scale(f"{src}.post_feedforward_layernorm.weight")
        else:
            layer["post_input_norm"] = scale(f"{src}.post_attention_layernorm.weight")
        params[f"layers_{i}"] = layer
    return params
