"""Ideogram packed-sequence DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/ideogram/transformer.py``
(``Ideogram4Transformer``): one packed sequence carries the conditioning and
the image tokens, tagged by an ``indicator`` (``LLM_TOKEN_INDICATOR`` 3,
``OUTPUT_IMAGE_INDICATOR`` 2); the LLM features are zeroed on image
positions and the noise tokens on text positions, and a 2-row indicator
embedding is added.  The conditioning is 13 tapped Qwen3-VL states
concatenated on the feature axis (53,248 features at the published size),
RMS-normed after the cast to the compute dtype (``llm_cond_norm``, eps 1e-6)
and projected (``llm_cond_proj``).  The time (t = 1 - sigma, per sample (B,)
or tokenwise (B, L)) is scaled by 1e4 into a sin-first sinusoid with the
frequency denominator half - 1, an f32 SiLU MLP (``t_in`` / ``t_out``), then
``adaln_input = silu(adaln_proj(t))``, shared by every block and passed
through ``silu`` once more by the final layer.  Blocks: the per-block f32
``adaln_modulation`` to [scale, tanh gate, scale, tanh gate], a fused
bias-free ``qkv``, per-head q/k RMS norms (eps 1e-5), the interleaved mRoPE
(sections (24, 20, 20) at theta 5e6, ``inv_freq`` made in float64 and
rounded to f32, rotate-half), RMS norms on the attention and FFN *outputs*
and the SwiGLU ``w2(silu(w1) * w3)``.  Final: a LayerNorm without affine
(eps 1e-6) scaled by ``1 + final_adaln(silu(adaln_input))``, then
``final_linear``.

The joint attention goes through :func:`dot_product_attention` (the flash
kernels' head dim 256 instances on the card; the JAX module computes a
dense f32 softmax): the segment ids pass straight through (text pads at 0,
valid text and image at 1), so pads attend to pads only and every row sees
at least itself.  After the rope the JAX module holds q and k in f32 (a
bf16 tensor times f32 tables); the kernels take bf16, so q and k are
rounded to the compute dtype before the op (exact in f32).  Submodules keep
the JAX names (``layer_{i}.qkv``, ``layer_{i}.attention_norm2``); remat
checkpoints every block whole, as ``nn.remat`` wraps ``IdeogramBlock``.
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

from ...ops import dot_product_attention
from ..cosmos1.transformer import rms
from ..layers import LoRADense

OUTPUT_IMAGE_INDICATOR = 2
LLM_TOKEN_INDICATOR = 3
IMAGE_POSITION_OFFSET = 65536
QWEN3_VL_ACTIVATION_LAYERS = (0, 3, 6, 9, 12, 15, 18, 21, 24, 27, 30, 33, 35)


@dataclasses.dataclass(frozen=True)
class IdeogramConfig:
    emb_dim: int = 4608
    num_layers: int = 34
    num_heads: int = 18
    intermediate_size: int = 12288
    adanln_dim: int = 512
    in_channels: int = 128  # 32-channel latents, 2x2-packed
    llm_hidden: int = 4096
    llm_taps: int = len(QWEN3_VL_ACTIVATION_LAYERS)
    rope_theta: float = 5_000_000.0
    mrope_section: Tuple[int, int, int] = (24, 20, 20)
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.emb_dim // self.num_heads

    @property
    def llm_features_dim(self) -> int:
        return self.llm_hidden * self.llm_taps

    @classmethod
    def tiny(cls) -> "IdeogramConfig":
        return cls(
            emb_dim=32, num_layers=2, num_heads=2, intermediate_size=64,
            adanln_dim=16, in_channels=16, llm_hidden=32, llm_taps=3,
            mrope_section=(4, 2, 2),
        )


def mrope_constants(config: IdeogramConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``inv_freq`` (hd/2,) made in float64 and rounded to f32, and the H and W
    selections of the interleaved sections (every third index within each)."""
    hd = config.head_dim
    inv_freq = 1.0 / (config.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    idx = np.arange(hd // 2)
    h_sel = (idx % 3 == 1) & (idx < config.mrope_section[1] * 3)
    w_sel = (idx % 3 == 2) & (idx < config.mrope_section[2] * 3)
    return inv_freq.astype(np.float32), h_sel, w_sel


def ideogram_mrope(position_ids: torch.Tensor, inv: torch.Tensor, h_sel: torch.Tensor,
                   w_sel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L, 3) ids -> cos, sin (B, L, head_dim) f32: the interleaved mRoPE
    in the rotate-half convention, from :func:`mrope_constants` on the ids' device."""
    freqs = position_ids.to(torch.float32).permute(2, 0, 1)[..., None] * inv  # (3, B, L, hd/2)
    mixed = torch.where(h_sel, freqs[1], freqs[0])
    mixed = torch.where(w_sel, freqs[2], mixed)
    emb = torch.cat([mixed, mixed], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


class IdeogramBlock(nn.Module):
    def __init__(self, config: IdeogramConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, hd = config.emb_dim, config.head_dim
        lora = dict(use_bias=False, dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.adaln_modulation = LoRADense(config.adanln_dim, 4 * dim, dtype=torch.float32)
        self.attention_norm1 = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.qkv = LoRADense(dim, 3 * dim, **lora)
        self.norm_q = nn.Parameter(torch.empty(hd, dtype=torch.float32))
        self.norm_k = nn.Parameter(torch.empty(hd, dtype=torch.float32))
        self.o = LoRADense(dim, dim, **lora)
        self.attention_norm2 = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.ffn_norm1 = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.w1 = LoRADense(dim, config.intermediate_size, **lora)
        self.w3 = LoRADense(dim, config.intermediate_size, **lora)
        self.w2 = LoRADense(config.intermediate_size, dim, **lora)
        self.ffn_norm2 = nn.Parameter(torch.empty(dim, dtype=torch.float32))

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for param in (self.attention_norm1, self.norm_q, self.norm_k, self.attention_norm2, self.ffn_norm1,
                      self.ffn_norm2):
            param.fill_(1.0)

    def forward(self, x: torch.Tensor, segment_ids: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                adaln_input: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        heads, hd, eps = cfg.num_heads, cfg.head_dim, cfg.norm_eps
        batch, seq = x.shape[:2]
        scale_msa, gate_msa, scale_mlp, gate_mlp = self.adaln_modulation(adaln_input.to(torch.float32)).chunk(4, -1)
        gate_msa, gate_mlp = torch.tanh(gate_msa), torch.tanh(gate_mlp)

        h = (rms(x, self.attention_norm1, eps).to(torch.float32) * (1.0 + scale_msa)).to(x.dtype)
        q, k, v = self.qkv(h).reshape(batch, seq, 3, heads, hd).unbind(dim=2)
        q, k = rms(q, self.norm_q, 1e-5), rms(k, self.norm_k, 1e-5)
        c, s = cos[:, :, None], sin[:, :, None]
        q = (q * c + _rotate_half(q) * s).to(v.dtype)
        k = (k * c + _rotate_half(k) * s).to(v.dtype)
        attn = dot_product_attention(q, k, v, q_segment_ids=segment_ids, kv_segment_ids=segment_ids)
        attn = rms(self.o(attn.reshape(batch, seq, cfg.emb_dim).to(self.dtype)), self.attention_norm2, eps)
        x = (x.to(torch.float32) + gate_msa * attn.to(torch.float32)).to(x.dtype)

        h = (rms(x, self.ffn_norm1, eps).to(torch.float32) * (1.0 + scale_mlp)).to(x.dtype)
        ff = rms(self.w2(F.silu(self.w1(h)) * self.w3(h)), self.ffn_norm2, eps)
        return (x.to(torch.float32) + gate_mlp * ff.to(torch.float32)).to(x.dtype)


class IdeogramTransformer(nn.Module):
    """The Ideogram DiT over the packed sequence: ``llm_features`` (B, L,
    llm_features_dim), ``x`` (B, L, in_channels) noise tokens, ``t`` (B,) or
    (B, L) flow time, ``position_ids`` (B, L, 3), ``segment_ids`` (B, L),
    ``indicator`` (B, L); returns (B, L, in_channels) f32."""

    def __init__(self, config: IdeogramConfig = IdeogramConfig(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim = config.emb_dim
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.input_proj = LoRADense(config.in_channels, dim, dtype=dtype, **lora)
        self.t_in = LoRADense(dim, dim, dtype=torch.float32)
        self.t_out = LoRADense(dim, dim, dtype=torch.float32)
        self.adaln_proj = LoRADense(dim, config.adanln_dim, dtype=torch.float32)
        self.llm_cond_norm = nn.Parameter(torch.empty(config.llm_features_dim, dtype=torch.float32))
        self.llm_cond_proj = LoRADense(config.llm_features_dim, dim, dtype=dtype, **lora)
        self.embed_image_indicator = nn.Parameter(torch.empty(2, dim, dtype=torch.float32))
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", IdeogramBlock(config, dtype, **lora))
        self.final_adaln = LoRADense(config.adanln_dim, dim, dtype=torch.float32)
        self.final_linear = LoRADense(dim, config.in_channels, dtype=dtype, **lora)
        self._rope: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def rope_constants(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """:func:`mrope_constants` on ``device``, made there once (a captured step copies nothing)."""
        if device not in self._rope:
            self._rope[device] = tuple(torch.from_numpy(a).to(device) for a in mrope_constants(self.config))
        return self._rope[device]

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.llm_cond_norm.fill_(1.0)
        self.embed_image_indicator.normal_(0.0, 0.02, generator=generator)

    def _run(self, name: str, *args):
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, llm_features: torch.Tensor, x: torch.Tensor, t: torch.Tensor, position_ids: torch.Tensor,
                segment_ids: torch.Tensor, indicator: torch.Tensor) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        llm_mask = (indicator == LLM_TOKEN_INDICATOR).to(dtype)[..., None]
        is_image = indicator == OUTPUT_IMAGE_INDICATOR
        img_mask = is_image.to(dtype)[..., None]
        x = self.input_proj(x.to(dtype) * img_mask) * img_mask

        # the sin-first sinusoid of 1e4 t with the (half - 1) denominator, in f32
        half = cfg.emb_dim // 2
        freq = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device) * (-math.log(1e4) / (half - 1)))
        args = (1e4 * t.to(torch.float32))[..., None] * freq
        t_cond = self.t_out(F.silu(self.t_in(torch.cat([torch.sin(args), torch.cos(args)], dim=-1))))
        if t.dim() == 1:
            t_cond = t_cond[:, None]
        adaln_input = F.silu(self.adaln_proj(t_cond))

        llm = rms(llm_features.to(dtype) * llm_mask, self.llm_cond_norm, 1e-6)
        h = x + self.llm_cond_proj(llm) * llm_mask
        h = h + self.embed_image_indicator[is_image.to(torch.int64)].to(dtype)

        cos, sin = ideogram_mrope(position_ids, *self.rope_constants(position_ids.device))
        segment_ids = segment_ids.to(torch.int32)
        for i in range(cfg.num_layers):
            h = self._run(f"layer_{i}", h, segment_ids, cos, sin, adaln_input)

        h_f = F.layer_norm(h.to(torch.float32), (cfg.emb_dim,), eps=1e-6)
        final_scale = 1.0 + self.final_adaln(F.silu(adaln_input))
        return self.final_linear((h_f * final_scale).to(dtype)).to(torch.float32)
