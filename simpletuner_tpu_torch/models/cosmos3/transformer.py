"""Cosmos3 omni Mixture-of-Transformers in PyTorch.

Counterpart of ``simpletuner_tpu/models/cosmos3/transformer.py``
(``Cosmos3OmniTransformer``): a Qwen3-VL backbone (4096 wide, 36 layers, 32
query and 8 key/value heads of 128, SwiGLU 12,288, a 151,936-row token table
and ``lm_head`` at the published size) whose every layer holds two
parameter pathways over one attention field.  The understanding pathway
(the text prefix: ``attn_und_*``, ``norm_q`` / ``norm_k``, ``mlp``) runs
causal GQA self-attention with no padding mask; the generation pathway (the
patchified video latents: ``attn_gen_*``, ``norm_added_q`` / ``norm_added_k``,
``mlp_moe_gen``) attends unmasked over the concatenated [und, gen] keys and
values.  Within a layer the generation update is computed first and the
understanding residual after it, both from the layer's input.  Per-head
affine RMS q/k norms (eps 1e-6, f32) precede the interleaved Qwen2-VL mRoPE
(theta 5e6, sections (24, 20, 20), rotate-half; :func:`mrope_constants`
shared with Ideogram, whose ids are laid out (B, L, 3) where these are
(B, 3, S)).  The per-token timestep (sigma x 1000 from the family) is scaled
by 1e-3 into a cos-first 256 sinusoid and the ``time_in_1`` / ``time_in_2``
SiLU MLP (no adapters), added to every generation token or gated by
``noisy_mask``.  The module returns the vision prediction and the
``lm_head`` logits, both f32.

With ``reasoner_kv`` (one (roped k, raw v) pair per layer from
``reasoner.py``) the understanding pathway is skipped (the generator-only
replay): the generation tokens attend over [reasoner k, gen k] and no
logits are made.

The generation attention (and its replay) goes through
:func:`dot_product_attention` (the flash kernels on the card; the JAX module
computes a dense f32 softmax), unmasked, with K and V repeated to the query
heads as ``jnp.repeat`` does; after the rope the JAX module holds q and k
in f32 (a bf16 tensor times f32 tables), the kernels take bf16, so q and k
are rounded to the compute dtype before the op (exact in f32).  The causal
understanding attention (64 tokens) stays a plain f32 block
(:func:`~simpletuner_tpu_torch.models.omnigen.transformer.prefix_attention`,
no key mask): the kernels have no causal mode.  The token table is read as
``jnp.take`` (ids past the table read NaN).  Submodules keep the JAX names
(``layer_{i}.attn_gen_q``, ``layer_{i}.mlp_moe_gen.gate_proj``); remat
checkpoints every layer whole, as ``nn.remat`` wraps ``Cosmos3MoTLayer``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import dot_product_attention
from ..cosmos1.transformer import rms
from ..ideogram.transformer import _rotate_half, ideogram_mrope, mrope_constants
from ..layers import LoRADense, take_rows, timestep_embedding
from ..omnigen.transformer import prefix_attention

TEMPORAL_MARGIN = 15000


@dataclasses.dataclass(frozen=True)
class Cosmos3Config:
    vocab_size: int = 151936
    hidden_size: int = 4096
    head_dim: int = 128
    num_heads: int = 32
    num_kv_heads: int = 8
    num_layers: int = 36
    intermediate_size: int = 12288
    latent_channel: int = 48
    latent_patch_size: int = 2
    rope_theta: float = 5_000_000.0
    rope_axes_dim: Tuple[int, int, int] = (24, 20, 20)
    rms_norm_eps: float = 1e-6
    timestep_scale: float = 0.001
    attention_bias: bool = False

    @property
    def patch_latent_dim(self) -> int:
        return self.latent_channel * self.latent_patch_size ** 2

    @property
    def mrope_section(self) -> Tuple[int, int, int]:
        """The mRoPE sections under Ideogram's name (``mrope_constants`` reads it)."""
        return self.rope_axes_dim

    @classmethod
    def tiny(cls) -> "Cosmos3Config":
        return cls(
            vocab_size=64, hidden_size=32, head_dim=16, num_heads=2, num_kv_heads=1,
            num_layers=2, intermediate_size=64, latent_channel=2,
            rope_axes_dim=(4, 2, 2),
        )


def cosmos3_mrope(config, position_ids: torch.Tensor,
                  constants: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3, S) mRoPE ids -> cos, sin (B, S, head_dim) f32 in the rotate-half
    convention; ``constants`` (:func:`mrope_constants` on the ids' device) are
    made here when not given."""
    if constants is None:
        constants = tuple(torch.from_numpy(a).to(position_ids.device) for a in mrope_constants(config))
    return ideogram_mrope(position_ids.transpose(1, 2), *constants)


def _apply_mrope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos / sin (B, S, D) broadcast over heads (f32 out for a bf16 x)."""
    return x * cos[:, :, None] + _rotate_half(x) * sin[:, :, None]


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, kv, D) -> (B, S, kv * n_rep, D) as ``jnp.repeat(x, n_rep, axis=2)``."""
    return x.repeat_interleave(n_rep, dim=2) if n_rep > 1 else x


class Cosmos3MLP(nn.Module):
    """SwiGLU: ``down_proj(silu(gate_proj(x)) * up_proj(x))``."""

    def __init__(self, config: Cosmos3Config, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        common = dict(use_bias=False, dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.gate_proj = LoRADense(config.hidden_size, config.intermediate_size, **common)
        self.up_proj = LoRADense(config.hidden_size, config.intermediate_size, **common)
        self.down_proj = LoRADense(config.intermediate_size, config.hidden_size, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


_LAYER_NORMS = ("input_layernorm_moe_gen", "norm_added_q", "norm_added_k", "input_layernorm", "norm_q", "norm_k",
                "post_attention_layernorm_moe_gen", "post_attention_layernorm")


class Cosmos3MoTLayer(nn.Module):
    """One MoT decoder layer: both pathways, one attention field."""

    def __init__(self, config: Cosmos3Config, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, hd = config.hidden_size, config.head_dim
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        common = dict(use_bias=config.attention_bias, dtype=dtype, **lora)
        for prefix in ("attn_gen_", "attn_und_"):
            self.add_module(f"{prefix}q", LoRADense(dim, config.num_heads * hd, **common))
            self.add_module(f"{prefix}k", LoRADense(dim, config.num_kv_heads * hd, **common))
            self.add_module(f"{prefix}v", LoRADense(dim, config.num_kv_heads * hd, **common))
            self.add_module(f"{prefix}out", LoRADense(config.num_heads * hd, dim, **common))
        self.mlp_moe_gen = Cosmos3MLP(config, dtype, **lora)
        self.mlp = Cosmos3MLP(config, dtype, **lora)
        for name in _LAYER_NORMS:
            size = hd if name.startswith("norm_") else dim
            self.register_parameter(name, nn.Parameter(torch.empty(size, dtype=torch.float32)))

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for name in _LAYER_NORMS:
            getattr(self, name).fill_(1.0)

    def _qkv(self, x: torch.Tensor, prefix: str, q_norm: torch.Tensor, k_norm: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.config
        batch, seq = x.shape[:2]
        q = getattr(self, f"{prefix}q")(x).reshape(batch, seq, cfg.num_heads, cfg.head_dim)
        k = getattr(self, f"{prefix}k")(x).reshape(batch, seq, cfg.num_kv_heads, cfg.head_dim)
        v = getattr(self, f"{prefix}v")(x).reshape(batch, seq, cfg.num_kv_heads, cfg.head_dim)
        q = _apply_mrope(rms(q, q_norm, cfg.rms_norm_eps), cos, sin)
        k = _apply_mrope(rms(k, k_norm, cfg.rms_norm_eps), cos, sin)
        return q, k, v

    def forward(self, und: Optional[torch.Tensor], gen: torch.Tensor, cos_u: torch.Tensor, sin_u: torch.Tensor,
                cos_g: torch.Tensor, sin_g: torch.Tensor, reasoner_k: Optional[torch.Tensor] = None,
                reasoner_v: Optional[torch.Tensor] = None) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        cfg, dtype = self.config, self.dtype
        eps, n_rep = cfg.rms_norm_eps, cfg.num_heads // cfg.num_kv_heads
        batch, gen_len = gen.shape[:2]
        width = cfg.num_heads * cfg.head_dim
        replay = reasoner_k is not None

        q_g, k_g, v_g = self._qkv(rms(gen, self.input_layernorm_moe_gen, eps), "attn_gen_", self.norm_added_q,
                                  self.norm_added_k, cos_g, sin_g)
        if replay:
            k_u, v_u = reasoner_k, reasoner_v  # roped k / raw v of the frozen reasoner
        else:
            q_u, k_u, v_u = self._qkv(rms(und, self.input_layernorm, eps), "attn_und_", self.norm_q, self.norm_k,
                                      cos_u, sin_u)
            und_attn = prefix_attention(q_u, repeat_kv(k_u, n_rep), repeat_kv(v_u, n_rep), None)
            und_attn = und_attn.reshape(batch, und.shape[1], width).to(dtype)

        all_k = torch.cat([k_u.to(k_g.dtype), k_g], dim=1)
        all_v = torch.cat([v_u.to(v_g.dtype), v_g], dim=1)
        gen_attn = dot_product_attention(q_g.to(v_g.dtype), repeat_kv(all_k.to(v_g.dtype), n_rep),
                                         repeat_kv(all_v, n_rep))
        gen = gen + self.attn_gen_out(gen_attn.reshape(batch, gen_len, width).to(dtype))
        gen = gen + self.mlp_moe_gen(rms(gen, self.post_attention_layernorm_moe_gen, eps))

        if not replay:
            und = und + self.attn_und_out(und_attn)
            und = und + self.mlp(rms(und, self.post_attention_layernorm, eps))
        return und, gen


class Cosmos3OmniTransformer(nn.Module):
    """``text_ids`` (B, S_und) int ids, ``vision_tokens`` (B, S_gen,
    patch_latent_dim), ``position_ids`` (B, 3, S_und + S_gen), ``timesteps``
    (B, S_gen) (sigma x 1000), optional ``noisy_mask`` (B, S_gen) and
    ``reasoner_kv`` -> (vision prediction (B, S_gen, patch_latent_dim),
    logits (B, S_und, vocab) or None in replay), both f32."""

    def __init__(self, config: Cosmos3Config = Cosmos3Config(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim = config.hidden_size
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.embed_tokens = nn.Parameter(torch.empty(config.vocab_size, dim, dtype=torch.float32))
        self.proj_in = LoRADense(config.patch_latent_dim, dim, dtype=dtype, **lora)
        self.time_in_1 = LoRADense(256, dim, dtype=dtype)
        self.time_in_2 = LoRADense(dim, dim, dtype=dtype)
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", Cosmos3MoTLayer(config, dtype, **lora))
        self.norm_moe_gen = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.proj_out = LoRADense(dim, config.patch_latent_dim, dtype=dtype, **lora)
        self.norm = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.lm_head = LoRADense(dim, config.vocab_size, use_bias=False, dtype=dtype)
        self._rope: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def rope_constants(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """:func:`mrope_constants` on ``device``, made there once (a captured step copies nothing)."""
        if device not in self._rope:
            self._rope[device] = tuple(torch.from_numpy(a).to(device) for a in mrope_constants(self.config))
        return self._rope[device]

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.embed_tokens.normal_(0.0, 0.02, generator=generator)
        self.norm_moe_gen.fill_(1.0)
        self.norm.fill_(1.0)

    def _run(self, name: str, *args):
        layer = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a layer draws no random numbers: the recompute needs no RNG state
            return checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)
        return layer(*args)

    def forward(self, text_ids: Optional[torch.Tensor], vision_tokens: torch.Tensor, position_ids: torch.Tensor,
                timesteps: torch.Tensor, noisy_mask: Optional[torch.Tensor] = None,
                reasoner_kv: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None):
        cfg, dtype = self.config, self.dtype
        batch, gen_len = vision_tokens.shape[:2]
        und_len = position_ids.shape[2] - gen_len
        replay = reasoner_kv is not None
        if replay and len(reasoner_kv) != cfg.num_layers:
            raise ValueError(f"reasoner replay needs {cfg.num_layers} (k, v) pairs, got {len(reasoner_kv)}")

        und = None
        if not replay:
            if text_ids is None:
                raise ValueError("text_ids required unless reasoner_kv replay is given")
            und = take_rows(self.embed_tokens, text_ids).to(dtype)

        gen = self.proj_in(vision_tokens.to(dtype))
        t_flat = (timesteps.to(torch.float32) * cfg.timestep_scale).reshape(-1)
        sinusoid = timestep_embedding(t_flat, 256, time_factor=1.0).to(dtype)
        temb = self.time_in_2(F.silu(self.time_in_1(sinusoid))).reshape(batch, gen_len, cfg.hidden_size)
        gen = gen + (temb if noisy_mask is None else temb * noisy_mask.to(dtype)[:, :, None])

        cos, sin = cosmos3_mrope(cfg, position_ids, self.rope_constants(position_ids.device))
        rope = (cos[:, :und_len], sin[:, :und_len], cos[:, und_len:], sin[:, und_len:])
        for i in range(cfg.num_layers):
            memory = tuple(reasoner_kv[i]) if replay else (None, None)
            und, gen = self._run(f"layer_{i}", und, gen, *rope, *memory)

        vision_pred = self.proj_out(rms(gen, self.norm_moe_gen, cfg.rms_norm_eps)).to(torch.float32)
        if replay:
            return vision_pred, None
        logits = self.lm_head(rms(und, self.norm, cfg.rms_norm_eps))
        return vision_pred, logits.to(torch.float32)


def cosmos3_patchify(latents: torch.Tensor, patch: int = 2) -> torch.Tensor:
    """(B, T, H, W, C) video latents -> (B, T * H/p * W/p, p^2 C) tokens in the
    reference (t, h, w, p, q, c) feature order."""
    b, t, h, w, c = latents.shape
    x = latents.reshape(b, t, h // patch, patch, w // patch, patch, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t * (h // patch) * (w // patch), patch * patch * c)


def cosmos3_unpatchify(tokens: torch.Tensor, t: int, h: int, w: int, patch: int = 2) -> torch.Tensor:
    b = tokens.shape[0]
    c = tokens.shape[-1] // (patch * patch)
    x = tokens.reshape(b, t, h // patch, w // patch, patch, patch, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t, h, w, c)


def cosmos3_position_ids(config: Cosmos3Config, und_len: int, t: int, h: int, w: int,
                         temporal_margin: int = TEMPORAL_MARGIN) -> np.ndarray:
    """(3, S_und + S_gen) mRoPE ids: the text counts all three axes together;
    the vision grid restarts the spatial axes and offsets the temporal one by
    ``und_len + temporal_margin``."""
    p = config.latent_patch_size
    hh, ww = h // p, w // p
    text = np.tile(np.arange(und_len), (3, 1))
    t_ids = np.repeat(np.arange(t), hh * ww) + und_len + temporal_margin
    h_ids = np.tile(np.repeat(np.arange(hh), ww), t)
    w_ids = np.tile(np.arange(ww), t * hh)
    return np.concatenate([text, np.stack([t_ids, h_ids, w_ids])], axis=1)
