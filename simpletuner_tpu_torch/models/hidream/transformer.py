"""HiDream-I1 MMDiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/hidream/transformer.py`` (the
``HiDreamImageTransformer2DModel``): ``depth_double`` double-stream and
``depth_single`` single-stream blocks at 20 heads of 128 (inner 2560);
Flux-style axial rope (``ops.rope``) over the image ids first, with every
text id zero; q / k RMS norms over the whole 2560-wide projection (eps
1e-5); a DeepSeek-style MoE feed-forward on the image stream (``E`` routed
SwiGLU experts, top-k with un-normalised gate scores, a half-width shared
expert) and a SwiGLU feed-forward on the text stream.  The text stream of a
double block is ``[T5, llama[last], llama[block]]``: the per-block llama
segment is appended and cut off after the block, while ``[T5,
llama[last]]`` carries the residual; the single blocks run on the merged
``[image, T5 + llama[last]]`` stream with the per-block llama segment
appended and cut off the same way.  The time and pooled CLIP embedders add
up to the adaLN input; every adaLN linear (``ada``, ``final_mod``) starts at
zero.  Submodules keep the JAX names (``double_{i}.ff_i.experts_w1``,
``caption_proj_{i}``), so the bridge maps a Flax tree by name.

Mirrored as the JAX module computes it: the gate is an f32 softmax over the
f32 projection; the top-k mask is ``scores >= top_vals[..., -1:]``, so ties
select more than k experts; every expert is computed densely as stacked
``(E, d, h)`` einsums in the compute dtype and weighted by the routed
scores; the load-balance term ``sum_e mean(score_e) * E * count_e / (B S k)``
is returned beside the output (the JAX ``sow("intermediates", "moe_aux")``).
The experts' weights are plain parameters in the compute dtype and carry no
adapter (the shared experts and ``ff_t`` are ``LoRADense`` and do).  Remat
(``gradient_checkpointing``) checkpoints every block whole, as ``nn.remat``
wraps the blocks.  The JAX module's per-block ``intermediates`` hidden-state
taps (CREPA) are not ported (ROADMAP Queue 1 item 4h).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import apply_rope, axial_rope, dot_product_attention
from ..layers import LoRADense, MLPEmbedder, layer_norm, lecun_normal_, timestep_embedding


@dataclasses.dataclass(frozen=True)
class HiDreamConfig:
    in_channels: int = 16
    patch_size: int = 2
    num_heads: int = 20
    head_dim: int = 128
    depth_double: int = 16
    depth_single: int = 32
    t5_dim: int = 4096
    llama_dim: int = 4096
    pooled_dim: int = 2048
    num_experts: int = 4
    top_k: int = 2
    multiple_of: int = 256
    axes_dim: Tuple[int, int, int] = (64, 32, 32)
    rope_theta: float = 10000.0

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def ffn_inner(self) -> int:
        # the reference FeedForward(dim, 4 * dim): 2/3 scaling, rounded up to multiple_of
        inner = int(2 * (4 * self.hidden_size) / 3)
        return self.multiple_of * ((inner + self.multiple_of - 1) // self.multiple_of)

    @property
    def shared_ffn_inner(self) -> int:
        # the shared expert's hidden_dim // 2
        inner = int(2 * (2 * self.hidden_size) / 3)
        return self.multiple_of * ((inner + self.multiple_of - 1) // self.multiple_of)

    @classmethod
    def tiny(cls) -> "HiDreamConfig":
        return cls(in_channels=4, num_heads=2, head_dim=24, depth_double=1, depth_single=2, t5_dim=32, llama_dim=32,
                   pooled_dim=32, num_experts=2, top_k=1, multiple_of=16, axes_dim=(12, 6, 6))


class HiDreamFFN(nn.Module):
    """Bias-free SwiGLU feed-forward ``w2(silu(w1(x)) * w3(x))`` (the text stream, the shared expert)."""

    def __init__(self, config: HiDreamConfig, inner: int, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        lora = dict(dtype=dtype, use_bias=False, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        dim = config.hidden_size
        self.w1 = LoRADense(dim, inner, **lora)
        self.w2 = LoRADense(inner, dim, **lora)
        self.w3 = LoRADense(dim, inner, **lora)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class HiDreamMoE(nn.Module):
    """The MoE feed-forward: an f32 softmax ``gate`` (E, dim), the routed
    SwiGLU experts as stacked (E, dim, h) / (E, h, dim) parameters computed
    densely, the half-width ``shared_experts``.  Returns the output and the
    0-d f32 load-balance term."""

    def __init__(self, config: HiDreamConfig, dtype: torch.dtype = torch.bfloat16, **lora) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        e, dim, hidden = config.num_experts, config.hidden_size, config.ffn_inner
        self.gate = nn.Parameter(torch.empty(e, dim, dtype=torch.float32))
        self.experts_w1 = nn.Parameter(torch.empty(e, dim, hidden, dtype=dtype))
        self.experts_w2 = nn.Parameter(torch.empty(e, hidden, dim, dtype=dtype))
        self.experts_w3 = nn.Parameter(torch.empty(e, dim, hidden, dtype=dtype))
        self.shared_experts = HiDreamFFN(config, config.shared_ffn_inner, dtype, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        # flax lecun_normal: fan_in is the in axis (-2) times the leading (batch) axes
        for param in (self.gate, self.experts_w1, self.experts_w2, self.experts_w3):
            lecun_normal_(param, param.numel() // param.shape[-1], generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, dtype = self.config, self.dtype
        e = cfg.num_experts
        scores = torch.softmax(torch.einsum("bsd,ed->bse", x.to(torch.float32), self.gate), dim=-1)
        top_vals = torch.topk(scores, cfg.top_k, dim=-1).values
        mask = (scores >= top_vals[..., -1:]).to(torch.float32)  # ties select more than k
        routed = scores * mask  # raw scores, not renormalised

        # the token-level load-balance term (the trainer applies its weight)
        scores_mean = scores.reshape(-1, e).mean(dim=0)
        ce = mask.sum(dim=(0, 1)) / (mask.shape[0] * mask.shape[1] * cfg.top_k)
        aux = torch.sum(scores_mean * ce * e)

        xd = x.to(dtype)
        h1 = torch.einsum("bsd,edh->besh", xd, self.experts_w1)
        h3 = torch.einsum("bsd,edh->besh", xd, self.experts_w3)
        y = torch.einsum("besh,ehd->besd", F.silu(h1) * h3, self.experts_w2)
        out = torch.einsum("besd,bse->bsd", y, routed.to(dtype))
        return out + self.shared_experts(xd), aux


def _rms_full(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the whole projection width, in f32."""
    x_f = x.to(torch.float32)
    return (x_f * torch.rsqrt(x_f.square().mean(dim=-1, keepdim=True) + eps) * scale).to(x.dtype)


def _add_attention(block: nn.Module, config: HiDreamConfig, suffix: str, lora: dict) -> None:
    """The q / k / v / out projections of one stream (``suffix`` "" or "_t")
    and their full-width RMS scales, on ``block``."""
    dim = config.hidden_size
    for name in ("q", "k", "v"):
        block.add_module(f"attn_{name}{suffix}", LoRADense(dim, dim, **lora))
    block.add_module(f"attn_proj{suffix}", LoRADense(dim, dim, **lora))
    block.register_parameter(f"q_rms{suffix}", nn.Parameter(torch.empty(dim, dtype=torch.float32)))
    block.register_parameter(f"k_rms{suffix}", nn.Parameter(torch.empty(dim, dtype=torch.float32)))


def _qkv(block: nn.Module, x: torch.Tensor, suffix: str):
    q = _rms_full(getattr(block, f"attn_q{suffix}")(x), getattr(block, f"q_rms{suffix}"))
    k = _rms_full(getattr(block, f"attn_k{suffix}")(x), getattr(block, f"k_rms{suffix}"))
    return q, k, getattr(block, f"attn_v{suffix}")(x)


class HiDreamDoubleBlock(nn.Module):
    """Double-stream block: 12-way zero-initialised adaLN, the image and
    text projections into one joint attention (image first), the MoE on the
    image stream and SwiGLU on the text stream.  Returns (img, txt, aux)."""

    def __init__(self, config: HiDreamConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim = config.hidden_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.ada = LoRADense(dim, 12 * dim, dtype=dtype, zero_init=True)
        _add_attention(self, config, "", lora)
        _add_attention(self, config, "_t", lora)
        self.ff_i = HiDreamMoE(config, **lora)
        self.ff_t = HiDreamFFN(config, config.ffn_inner, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for name in ("q_rms", "k_rms", "q_rms_t", "k_rms_t"):
            getattr(self, name).fill_(1.0)

    def forward(self, img: torch.Tensor, txt: torch.Tensor, adaln: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor):
        cfg, dtype = self.config, self.dtype
        batch, img_len = img.shape[:2]
        mods = [m[:, None] for m in self.ada(F.silu(adaln.to(torch.float32)).to(dtype)).chunk(12, dim=-1)]
        sh_i, sc_i, g_i, shm_i, scm_i, gm_i, sh_t, sc_t, g_t, shm_t, scm_t, gm_t = mods

        q_i, k_i, v_i = _qkv(self, layer_norm(img, dtype) * (1 + sc_i) + sh_i, "")
        q_t, k_t, v_t = _qkv(self, layer_norm(txt, dtype) * (1 + sc_t) + sh_t, "_t")
        heads = lambda a: a.reshape(batch, a.shape[1], cfg.num_heads, cfg.head_dim)  # noqa: E731
        q = apply_rope(heads(torch.cat([q_i, q_t], dim=1)), cos, sin)  # image first
        k = apply_rope(heads(torch.cat([k_i, k_t], dim=1)), cos, sin)
        attn = dot_product_attention(q, k, heads(torch.cat([v_i, v_t], dim=1))).reshape(batch, -1, cfg.hidden_size)
        img = img + g_i * self.attn_proj(attn[:, :img_len])
        txt = txt + g_t * self.attn_proj_t(attn[:, img_len:])

        moe, aux = self.ff_i(layer_norm(img, dtype) * (1 + scm_i) + shm_i)
        img = img + gm_i * moe
        txt = txt + gm_t * self.ff_t(layer_norm(txt, dtype) * (1 + scm_t) + shm_t)
        return img, txt, aux


class HiDreamSingleBlock(nn.Module):
    """Single-stream block: 6-way zero-initialised adaLN, one projection set
    over the merged stream, the MoE.  Returns (x, aux)."""

    def __init__(self, config: HiDreamConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim = config.hidden_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.ada = LoRADense(dim, 6 * dim, dtype=dtype, zero_init=True)
        _add_attention(self, config, "", lora)
        self.ff_i = HiDreamMoE(config, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.q_rms.fill_(1.0)
        self.k_rms.fill_(1.0)

    def forward(self, x: torch.Tensor, adaln: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
        cfg, dtype = self.config, self.dtype
        batch, seq = x.shape[:2]
        sh, sc, g, shm, scm, gm = (m[:, None] for m in
                                   self.ada(F.silu(adaln.to(torch.float32)).to(dtype)).chunk(6, dim=-1))
        q, k, v = _qkv(self, layer_norm(x, dtype) * (1 + sc) + sh, "")
        shape = (batch, seq, cfg.num_heads, cfg.head_dim)
        attn = dot_product_attention(apply_rope(q.reshape(shape), cos, sin), apply_rope(k.reshape(shape), cos, sin),
                                     v.reshape(shape)).reshape(batch, seq, cfg.hidden_size)
        x = x + g * self.attn_proj(attn)
        moe, aux = self.ff_i(layer_norm(x, dtype) * (1 + scm) + shm)
        return x + gm * moe, aux


class HiDreamTransformer(nn.Module):
    """The HiDream-I1 DiT.  ``latents`` (B, H, W, C), ``timesteps`` (B,)
    sigma in (0, 1) (embedded at sigma x 1000), ``t5_embeds`` (B, S_t5,
    t5_dim), ``llama_embeds`` (B, L_sel, S_llama, llama_dim) (block ``i``
    reads layer ``i % L_sel``), ``pooled`` (B, pooled_dim); returns (B, H,
    W, C) in f32, and with ``with_aux`` also the list of every MoE's
    load-balance term, in block order."""

    def __init__(self, config: HiDreamConfig = HiDreamConfig(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim, p = config.hidden_size, config.patch_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.time_in = MLPEmbedder(256, dim, dtype=dtype)
        self.pooled_in = MLPEmbedder(config.pooled_dim, dim, dtype=dtype)
        self.patch_in = LoRADense(p * p * config.in_channels, dim, **lora)
        self.caption_proj_t5 = LoRADense(config.t5_dim, dim, use_bias=False, **lora)
        for i in range(config.depth_double + config.depth_single):
            self.add_module(f"caption_proj_{i}", LoRADense(config.llama_dim, dim, use_bias=False, **lora))
        for layer in range(config.depth_double):
            self.add_module(f"double_{layer}", HiDreamDoubleBlock(config, **lora))
        for layer in range(config.depth_single):
            self.add_module(f"single_{layer}", HiDreamSingleBlock(config, **lora))
        self.final_mod = LoRADense(dim, 2 * dim, dtype=dtype, zero_init=True)
        self.final_proj = LoRADense(dim, p * p * config.in_channels, **lora)
        self._rope: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(self, hh: int, ww: int, txt_len: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (cos, sin) tables of [image (0, row, col), text (0, 0, 0)] on
        ``device``, made in f32 there once per grid and text length (before a
        captured step needs them)."""
        key = (hh, ww, txt_len, device)
        if key not in self._rope:
            rows = torch.arange(hh, dtype=torch.float32, device=device).repeat_interleave(ww)
            cols = torch.arange(ww, dtype=torch.float32, device=device).repeat(hh)
            img_ids = torch.stack([torch.zeros_like(rows), rows, cols], dim=-1)
            ids = torch.cat([img_ids, torch.zeros((txt_len, 3), dtype=torch.float32, device=device)], dim=0)
            self._rope[key] = axial_rope(self.config.axes_dim, ids[None], self.config.rope_theta)
        return self._rope[key]

    def _run(self, name: str, *args):
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, t5_embeds: torch.Tensor,
                llama_embeds: torch.Tensor, pooled: torch.Tensor, with_aux: bool = False):
        cfg, dtype = self.config, self.dtype
        p = cfg.patch_size
        batch, height, width, channels = latents.shape
        hh, ww = height // p, width // p
        img_len = hh * ww

        adaln = self.time_in(timestep_embedding(timesteps.to(torch.float32), 256).to(dtype))
        adaln = adaln + self.pooled_in(pooled.to(dtype))
        x = latents.to(dtype).reshape(batch, hh, p, ww, p, channels).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_in(x.reshape(batch, img_len, p * p * channels))

        n_blocks, n_sel = cfg.depth_double + cfg.depth_single, llama_embeds.shape[1]
        last = getattr(self, f"caption_proj_{n_blocks - 1}")(llama_embeds[:, (n_blocks - 1) % n_sel].to(dtype))

        def llama(i: int) -> torch.Tensor:  # block i's caption projection (the last one computed once)
            if i == n_blocks - 1:
                return last
            return getattr(self, f"caption_proj_{i}")(llama_embeds[:, i % n_sel].to(dtype))

        # the persistent text stream [T5, llama[last]]
        txt = torch.cat([self.caption_proj_t5(t5_embeds.to(dtype)), last], dim=1)
        txt_base_len = txt.shape[1]
        cos, sin = self.rope(hh, ww, txt_base_len + llama_embeds.shape[2], latents.device)

        aux: List[torch.Tensor] = []
        for layer in range(cfg.depth_double):
            x, txt_out, block_aux = self._run(f"double_{layer}", x, torch.cat([txt, llama(layer)], dim=1), adaln,
                                              cos, sin)
            txt = txt_out[:, :txt_base_len]  # the per-block llama segment is cut off
            aux.append(block_aux)

        stream = torch.cat([x, txt], dim=1)  # [image, T5 + llama[last]]
        stream_len = stream.shape[1]
        for layer in range(cfg.depth_single):
            merged, block_aux = self._run(f"single_{layer}", torch.cat([stream, llama(cfg.depth_double + layer)], dim=1),
                                          adaln, cos, sin)
            stream = merged[:, :stream_len]
            aux.append(block_aux)

        shift, scale = self.final_mod(F.silu(adaln.to(torch.float32)).to(dtype)).chunk(2, dim=-1)
        x = layer_norm(stream[:, :img_len], dtype) * (1 + scale[:, None]) + shift[:, None]
        x = self.final_proj(x).reshape(batch, hh, ww, p, p, channels).permute(0, 1, 3, 2, 4, 5)
        out = x.reshape(batch, height, width, channels).to(torch.float32)
        return (out, aux) if with_aux else out
