"""OmniGen: a Phi-3 decoder used as a DiT, in PyTorch.

Counterpart of ``simpletuner_tpu/models/omnigen/transformer.py``
(``OmniGenTransformer2DModel``): one joint sequence ``[prompt token embeds |
time token | image patch tokens]`` through Phi-3 blocks (RMSNorm, bias-free
GQA attention with rotate-half RoPE over the flat positions at theta 10000,
RMSNorm, the fused ``gate_up_proj`` SwiGLU).  The prompt is the model's own
embedding table over Phi-3 token ids (read as ``jnp.take``: an id past the
table reads NaN); the 2 x 2 patchify is a Dense over (ph, pw, c) features
plus the fixed 2-D sincos table, made in float64 once per bucket and device
and cropped about its centre; the timestep (the cleanliness t = 1 - sigma)
enters through a cos-first sinusoid at ``time_factor`` 1000 twice: as a
sequence token (``time_token``) and as the final AdaLN's embedding
(``t_embedder``).  The final RMSNorm, then the image rows, a parameter-free
LayerNorm (eps 1e-6) with ``shift, scale`` from ``norm_out_linear``, then
``proj_out`` and the unpatchify.

The JAX module masks one dense softmax: causal over the sequence, with a
bidirectional island over the image tokens and the text pads masked as
keys.  The port splits the queries.  The image rows see every valid key
(causal covers the prefix, the island the image), so they are one call of
:func:`dot_product_attention` (the flash kernels on the card): query ids 1,
key ids 1, or ``SEGMENT_PAD_ID`` for a text pad; head dim 96 is zero-padded
to the kernels' 128 there.  The prefix rows (text and the time token) see
only prefix keys, causally, which no segment-id mask expresses: that block
(121 x 121 a head at the published 120 tokens) stays a plain f32 masked
softmax in :func:`prefix_attention` (its time on the card stands beside
the image rows' kernel in PERF.md §6).  Both parts read the same K and V,
so autograd sums their gradients.  A prefix row whose keys are all masked
(the pads before a left-padded caption's first token) is 0 here where the
JAX softmax averages every key uniformly; no valid row reads a pad as a key, so the image output and the
gradients do not change (ROADMAP Queue 3).

Submodules keep the JAX names (``layers_{i}.to_q``, ``t_embedder.linear_1``,
``embed_tokens.embedding``); LoRA adapters sit on the blocks' projections
only, as in the JAX module; remat (``gradient_checkpointing``) checkpoints
every block whole, as ``nn.remat`` wraps ``OmniGenBlock``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import dot_product_attention, key_mask_segments
from ..cosmos1.transformer import rms
from ..layers import LoRADense, lecun_normal_, take_rows, timestep_embedding


@dataclasses.dataclass(frozen=True)
class OmniGenConfig:
    in_channels: int = 4
    patch_size: int = 2
    hidden_size: int = 3072
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 8192
    num_layers: int = 32
    vocab_size: int = 32064
    rope_base: float = 10000.0
    pos_embed_max_size: int = 192
    time_step_dim: int = 256
    rms_norm_eps: float = 1e-5

    @classmethod
    def tiny(cls) -> "OmniGenConfig":
        return cls(
            in_channels=4, hidden_size=64, num_heads=2, num_kv_heads=1,
            intermediate_size=128, num_layers=2, vocab_size=128,
            pos_embed_max_size=32, time_step_dim=32,
        )


def sincos_2d(dim: int, size: int) -> np.ndarray:
    """(size^2, dim) fixed 2-D sin-cos table in float64, rounded to f32 (w fastest)."""
    def axis(d, pos):
        omega = 1.0 / (10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2)))
        out = np.einsum("m,d->md", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid = np.meshgrid(np.arange(size, dtype=np.float64), np.arange(size, dtype=np.float64))
    emb_h = axis(dim // 2, grid[1].reshape(-1))
    emb_w = axis(dim // 2, grid[0].reshape(-1))
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


class OmniGenRMSNorm(nn.Module):
    """Phi-3's RMSNorm: f32 statistics, the f32 ``weight``, back to the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=torch.float32))

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms(x, self.weight, self.eps)


class TimestepMLP(nn.Module):
    """diffusers' TimestepEmbedding: Dense, silu, Dense (no adapters)."""

    def __init__(self, in_features: int, hidden_size: int, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dtype = dtype
        self.linear_1 = LoRADense(in_features, hidden_size, dtype=dtype)
        self.linear_2 = LoRADense(hidden_size, hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x.to(self.dtype))))


class Embedding(nn.Module):
    """The token table (``embedding``, f32) read as ``jnp.take``: negative ids
    wrap once, ids past the table read NaN."""

    def __init__(self, vocab_size: int, features: int) -> None:
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab_size, features, dtype=torch.float32))

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.embedding, self.embedding.shape[1], generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return take_rows(self.embedding, ids)


def prefix_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_ok: Optional[torch.Tensor]) -> torch.Tensor:
    """The prefix rows' attention: (B, P, H, D) queries against the P prefix
    keys, causal, the text pads masked as keys (``key_ok`` (B, P) bool or
    None), a plain f32 softmax; a row with no key gives 0 (the kernels'
    convention).  Output in q's dtype."""
    batch, length, _, dim = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dim ** -0.5
    mask = torch.ones((length, length), dtype=torch.bool, device=q.device).tril()[None, None]
    if key_ok is not None:
        mask = mask & key_ok[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, torch.zeros_like(p))
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0, torch.ones_like(denom), denom)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


class OmniGenBlock(nn.Module):
    def __init__(self, config: OmniGenConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config = config
        hidden, hd = config.hidden_size, config.hidden_size // config.num_heads
        lora = dict(use_bias=False, dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.input_layernorm = OmniGenRMSNorm(hidden, config.rms_norm_eps)
        self.to_q = LoRADense(hidden, config.num_heads * hd, **lora)
        self.to_k = LoRADense(hidden, config.num_kv_heads * hd, **lora)
        self.to_v = LoRADense(hidden, config.num_kv_heads * hd, **lora)
        self.to_out = LoRADense(config.num_heads * hd, hidden, **lora)
        self.post_attention_layernorm = OmniGenRMSNorm(hidden, config.rms_norm_eps)
        self.gate_up_proj = LoRADense(hidden, 2 * config.intermediate_size, **lora)
        self.down_proj = LoRADense(config.intermediate_size, hidden, **lora)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, n_img: int,
                key_ok: Optional[torch.Tensor], key_ids: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.config
        batch, seq = x.shape[:2]
        hd = cfg.hidden_size // cfg.num_heads
        h = self.input_layernorm(x)
        q = self.to_q(h).reshape(batch, seq, cfg.num_heads, hd)
        k = self.to_k(h).reshape(batch, seq, cfg.num_kv_heads, hd)
        v = self.to_v(h).reshape(batch, seq, cfg.num_kv_heads, hd)

        def rope(t):
            half = t.shape[-1] // 2
            return t * cos + torch.cat([-t[..., half:], t[..., :half]], dim=-1) * sin

        q, k = rope(q), rope(k)
        repeat = cfg.num_heads // cfg.num_kv_heads
        if repeat > 1:  # jnp.repeat on the head axis: head h reads key/value head h // repeat
            k = k.repeat_interleave(repeat, dim=2)
            v = v.repeat_interleave(repeat, dim=2)
        prefix = seq - n_img
        q_ids = None if key_ids is None else torch.ones((batch, n_img), dtype=torch.int32, device=x.device)
        image = dot_product_attention(q[:, prefix:], k, v, q_segment_ids=q_ids, kv_segment_ids=key_ids)
        head = prefix_attention(q[:, :prefix], k[:, :prefix], v[:, :prefix],
                                None if key_ok is None else key_ok[:, :prefix])
        attn = torch.cat([head, image], dim=1).reshape(batch, seq, cfg.num_heads * hd)
        x = x + self.to_out(attn)
        gate, up = self.gate_up_proj(self.post_attention_layernorm(x)).chunk(2, dim=-1)
        return x + self.down_proj(up * F.silu(gate))


class OmniGenTransformer(nn.Module):
    """The OmniGen DiT.  ``latents`` (B, H, W, C) noisy latents,
    ``timesteps`` (B,) the cleanliness t = 1 - sigma, ``input_ids`` (B, L)
    Phi-3 token ids, ``text_mask`` (B, L) 1 for a real token or None;
    returns (B, H, W, C) f32."""

    def __init__(self, config: OmniGenConfig = OmniGenConfig(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        hidden, p = config.hidden_size, config.patch_size
        self.output_image_proj = LoRADense(p * p * config.in_channels, hidden, dtype=dtype)
        self.t_embedder = TimestepMLP(config.time_step_dim, hidden, dtype)
        self.time_token = TimestepMLP(config.time_step_dim, hidden, dtype)
        self.embed_tokens = Embedding(config.vocab_size, hidden)
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        for i in range(config.num_layers):
            self.add_module(f"layers_{i}", OmniGenBlock(config, dtype, **lora))
        self.norm = OmniGenRMSNorm(hidden, config.rms_norm_eps)
        self.norm_out_linear = LoRADense(hidden, 2 * hidden, dtype=dtype)
        self.proj_out = LoRADense(hidden, p * p * config.in_channels, dtype=dtype)
        self._tables: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def position_table(self, gh: int, gw: int, device: torch.device) -> torch.Tensor:
        """The sincos table cropped about its centre to the (gh, gw) grid, (gh * gw, hidden) f32,
        made once per grid and device."""
        key = (gh, gw, device)
        if key not in self._tables:
            size = self.config.pos_embed_max_size
            table = sincos_2d(self.config.hidden_size, size).reshape(size, size, -1)
            top, left = (size - gh) // 2, (size - gw) // 2
            crop = np.ascontiguousarray(table[top:top + gh, left:left + gw].reshape(gh * gw, -1))
            self._tables[key] = torch.from_numpy(crop).to(device)
        return self._tables[key]

    def _run(self, name: str, *args):
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, input_ids: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        p = cfg.patch_size
        batch, height, width, channels = latents.shape
        gh, gw = height // p, width // p
        n_img = gh * gw
        device = latents.device

        patches = latents.reshape(batch, gh, p, gw, p, channels).permute(0, 1, 3, 2, 4, 5)
        img = self.output_image_proj(patches.reshape(batch, n_img, p * p * channels).to(dtype))
        img = img + self.position_table(gh, gw, device)[None].to(img.dtype)

        t_proj = timestep_embedding(timesteps, cfg.time_step_dim)
        temb = self.t_embedder(t_proj)
        time_tok = self.time_token(t_proj)[:, None, :]
        cond = self.embed_tokens(input_ids).to(dtype)
        x = torch.cat([cond, time_tok, img], dim=1)
        seq = x.shape[1]

        # rotate-half RoPE over the flat positions, cos and sin in the compute dtype
        head_dim = cfg.hidden_size // cfg.num_heads
        inv = 1.0 / (cfg.rope_base ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
        freqs = torch.outer(torch.arange(seq, dtype=torch.float32, device=device), inv)
        emb = torch.cat([freqs, freqs], dim=-1)
        cos = torch.cos(emb)[None, :, None, :].to(dtype)
        sin = torch.sin(emb)[None, :, None, :].to(dtype)

        key_ok = key_ids = None
        if text_mask is not None:
            key_ok = torch.cat([text_mask.to(torch.bool),
                                torch.ones((batch, 1 + n_img), dtype=torch.bool, device=device)], dim=1)
            key_ids = key_mask_segments(key_ok)
        for i in range(cfg.num_layers):
            x = self._run(f"layers_{i}", x, cos, sin, n_img, key_ok, key_ids)

        x = self.norm(x)[:, -n_img:]
        shift, scale = self.norm_out_linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        x_f = x.to(torch.float32)
        mean = x_f.mean(dim=-1, keepdim=True)
        var = x_f.var(dim=-1, keepdim=True, unbiased=False)
        x = ((x_f - mean) * torch.rsqrt(var + 1e-6)).to(x.dtype) * (1 + scale) + shift
        out = self.proj_out(x).reshape(batch, gh, gw, p, p, cfg.in_channels)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(batch, height, width, cfg.in_channels).to(torch.float32)
