"""ACE-Step text-to-music transformer in PyTorch.

Counterpart of ``simpletuner_tpu/models/ace_step/transformer.py`` (the
vendored ``ACEStepTransformer2DModel``): mel-layout latents (B, H_mel, T, C)
through the patch embed (the (H_mel, 1) patch conv, GroupNorm(32) with f32
statistics, the 1 x 1 projection) into T tokens; adaLN-single (the shared
``t_block`` 6-way modulation plus each block's (6, dim) table, in f32, cast to
the compute dtype at each use); blocks of ReLU linear self-attention
(``lite_la_attention``: f32 products with the ones column padded onto V and
eps 1e-15, masked multiplicatively), softmax cross-attention over the
conditioning sequence and the GLUMBConv FFN (a 1 x 1 conv, silu, the
depthwise k = 3 conv, the GLU with the value first, the bias-free 1 x 1
point conv).  Qwen2 RoPE at theta 1e6 (``qwen2_rope_tables``: cos / sin of
cat(freqs, freqs) made on the host in float64 once per length, head dim and
device; ``qwen2_apply_rope``: rotate-half on interleaved pairs) on the self
q / k and on the cross q (self positions) and k (conditioning positions).

The conditioning (``encode_conditioning``) is [speaker (1), genre / caption
(text), lyrics]: the lyric ids read from ``lyric_embs`` as ``jnp.take``
reads them (``layers.take_rows``), the linear embed with its LayerNorm and
the x sqrt(d) scale, the 6-layer wenet Conformer (pre-LN ESPnet relative-
position self-attention with ``pos_bias_u`` / ``pos_bias_v`` and the shift
trick, ``_rel_shift``; the swish FFN; affine LayerNorms at eps 1e-5) and its
after-norm, then ``lyric_proj``; the mask is [1, text mask, lyric mask].

The cross-attention goes through :func:`dot_product_attention` (the Hopper
flash kernels on the card): query ids from ``latent_mask`` (1 valid, 0
otherwise; all 1 without it), key ids from the conditioning mask (1 valid,
-1 pad), so a query that sees no key gives 0, as the JAX ``nan_to_num`` of
its fully masked softmax rows does; the rope is applied to q and k before
the call.  The conformer's attention carries a relative-position term that
the kernels cannot take, so it stays a plain f32 block (softmax over masked
keys, NaN rows to 0), as OmniGen's prefix block does; so do the Lite-LA
products and the convolutions (``torch.nn.functional``, as ``nn.Conv`` is XLA
in JAX).  The SSL projector heads (``projector_{head}_{j}``) are parameters
of the module, as the checkpoint holds them, and run in no forward: the
per-block intermediates tap that reads them is refused by the family.
Submodules keep the JAX names (``block_{i}.cross_q``, ``block_{i}.ff.depth``,
``lyric_encoder.layer_{i}.norm_mha.LayerNorm_0``), so a Flax tree maps onto
the state dict by name; remat checkpoints every block whole, as ``nn.remat``
wraps ``ACEStepBlock``.
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
from ..layers import LoRADense, MLPEmbedder, take_rows, timestep_embedding
from ..ltxvideo2.transformer import rms_plain
from ..wan.transformer import AffineLayerNorm


@dataclasses.dataclass(frozen=True)
class ACEStepConfig:
    in_channels: int = 8
    latent_height: int = 16  # mel bins (patch covers the full height)
    patch_mult: int = 256  # early-conv expansion (reference in_channels*256)
    num_layers: int = 28
    num_heads: int = 24
    head_dim: int = 64
    mlp_ratio: float = 4.0
    rope_theta: float = 1_000_000.0
    speaker_dim: int = 512
    text_dim: int = 768
    lyric_vocab: int = 6681
    lyric_hidden: int = 1024
    lyric_depth: int = 6
    lyric_heads: int = 16
    lyric_ffn: int = 4096
    ssl_dims: Tuple[int, ...] = (1024, 768)
    ssl_depths: Tuple[int, ...] = (9, 9)
    ssl_names: Tuple[str, ...] = ("mert", "m-hubert")

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.head_dim

    @classmethod
    def tiny(cls) -> "ACEStepConfig":
        return cls(
            in_channels=4, latent_height=1, patch_mult=8, num_layers=2,
            num_heads=2, head_dim=16, speaker_dim=16, text_dim=16,
            lyric_vocab=64, lyric_hidden=32, lyric_depth=1, lyric_heads=2,
            lyric_ffn=64, ssl_dims=(24,), ssl_depths=(1,), ssl_names=("mert",),
        )


_TABLES: Dict[tuple, object] = {}


def qwen2_rope_tables(seq_len: int, dim: int, theta: float, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos / sin (S, D) f32 of the half-dim frequencies repeated as
    cat(freqs, freqs), made on the host in float64 once per length, head dim,
    theta and device."""
    key = ("qwen2", seq_len, dim, theta, str(torch.device(device) if device is not None else "cpu"))
    if key not in _TABLES:
        inv = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
        emb = np.outer(np.arange(seq_len, dtype=np.float64), inv)
        emb = np.concatenate([emb, emb], axis=-1)
        _TABLES[key] = (torch.from_numpy(np.cos(emb).astype(np.float32)).to(device),
                        torch.from_numpy(np.sin(emb).astype(np.float32)).to(device))
    return _TABLES[key]


def qwen2_apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D): rotate-half on interleaved pairs with full-dim cos / sin, in f32, back to x's dtype."""
    x_f = x.to(torch.float32)
    rotated = torch.stack([-x_f[..., 1::2], x_f[..., 0::2]], dim=-1).reshape(x.shape)
    return (x_f * cos[None, :, None, :] + rotated * sin[None, :, None, :]).to(x.dtype)


def lite_la_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None,
                      eps: float = 1e-15, pad_val: float = 1.0) -> torch.Tensor:
    """ReLU linear attention over (B, S, H, D) in f32: ``mask`` (B, S)
    multiplies q, k and v; a column of ``pad_val`` on V gives the normaliser."""
    q = F.relu(q.to(torch.float32))
    k = F.relu(k.to(torch.float32))
    v = v.to(torch.float32)
    if mask is not None:
        m = mask.to(torch.float32)[:, :, None, None]
        q, k, v = q * m, k * m, v * m
    v = torch.cat([v, torch.full(v.shape[:-1] + (1,), pad_val, dtype=torch.float32, device=v.device)], dim=-1)
    vk = torch.einsum("bshe,bshd->bhed", v, k)
    out = torch.einsum("bhed,bshd->bshe", vk, q)
    return out[..., :-1] / (out[..., -1:] + eps)


class GLUMBConv(nn.Module):
    """The inverted 1 x 1 conv -> silu -> depthwise k = 3 conv -> GLU (value
    first, silu gate second) -> bias-free 1 x 1 point conv, over (B, S, dim);
    the 1 x 1s as dense products over the features, the depthwise one as a
    grouped ``conv1d``."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.inverted = nn.Conv1d(dim, 2 * hidden, 1, dtype=dtype)
        self.depth = nn.Conv1d(2 * hidden, 2 * hidden, 3, padding=1, groups=2 * hidden, dtype=dtype)
        self.point = nn.Conv1d(hidden, dim, 1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(F.linear(x, self.inverted.weight.flatten(1), self.inverted.bias))
        h = self.depth(h.transpose(1, 2)).transpose(1, 2)
        value, gate = h.chunk(2, dim=-1)
        return F.linear(value * F.silu(gate), self.point.weight.flatten(1))


class ACEStepBlock(nn.Module):
    """LinearTransformerBlock: Lite-LA self-attention -> cross-attention ->
    GLUMBConv, adaLN-single with the block's ``scale_shift_table``."""

    def __init__(self, config: ACEStepConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim = config.inner_dim
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.scale_shift_table = nn.Parameter(torch.empty(6, dim, dtype=torch.float32))
        for name in ("attn_q", "attn_k", "attn_v", "attn_proj", "cross_q", "cross_k", "cross_v", "cross_proj"):
            self.add_module(name, LoRADense(dim, dim, **lora))
        self.ff = GLUMBConv(dim, int(dim * config.mlp_ratio), dtype)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale_shift_table.normal_(0.0, 1.0 / math.sqrt(self.config.inner_dim), generator=generator)

    def forward(self, x: torch.Tensor, context: torch.Tensor, temb6: torch.Tensor, rope_self, rope_cross,
                mask: Optional[torch.Tensor], q_seg: torch.Tensor, kv_seg: torch.Tensor) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        batch, seq = x.shape[:2]
        mods = self.scale_shift_table[None] + temb6.to(torch.float32).reshape(batch, 6, -1)
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = (mods[:, i][:, None] for i in range(6))

        # Lite-LA self-attention (biased projections, rope on q and k)
        x_n = (rms_plain(x).to(torch.float32) * (1 + sc_msa) + sh_msa).to(dtype)
        heads = (batch, -1, cfg.num_heads, cfg.head_dim)
        cos_s, sin_s = rope_self
        q = qwen2_apply_rope(self.attn_q(x_n).reshape(heads), cos_s, sin_s)
        k = qwen2_apply_rope(self.attn_k(x_n).reshape(heads), cos_s, sin_s)
        attn = lite_la_attention(q, k, self.attn_v(x_n).reshape(heads), mask).reshape(batch, seq, -1).to(dtype)
        x = x + g_msa.to(dtype) * self.attn_proj(attn)

        # cross-attention over the conditioning (q at self positions, k at the conditioning's)
        cos_c, sin_c = rope_cross
        qc = qwen2_apply_rope(self.cross_q(x).reshape(heads), cos_s, sin_s)
        kc = qwen2_apply_rope(self.cross_k(context).reshape(heads), cos_c, sin_c)
        cross = dot_product_attention(qc, kc, self.cross_v(context).reshape(heads), q_segment_ids=q_seg,
                                      kv_segment_ids=kv_seg)
        x = x + self.cross_proj(cross.reshape(batch, seq, -1).to(dtype))

        # GLUMBConv FFN
        x_f = (rms_plain(x).to(torch.float32) * (1 + sc_mlp) + sh_mlp).to(dtype)
        return x + g_mlp.to(dtype) * self.ff(x_f)


def espnet_rel_pos(seq_len: int, dim: int, device=None) -> torch.Tensor:
    """(2T - 1, D) f32 relative position table, positions T - 1 ... 0 ... -(T - 1)
    (ESPnet's ``extend_pe``), made on the host in float64 once per length, width and device."""
    key = ("espnet", seq_len, dim, str(torch.device(device) if device is not None else "cpu"))
    if key not in _TABLES:
        position = np.arange(seq_len, dtype=np.float64)[:, None]
        div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(math.log(10000.0) / dim))
        pos, neg = np.zeros((seq_len, dim)), np.zeros((seq_len, dim))
        pos[:, 0::2], pos[:, 1::2] = np.sin(position * div), np.cos(position * div)
        neg[:, 0::2], neg[:, 1::2] = np.sin(-position * div), np.cos(-position * div)
        table = np.concatenate([pos[::-1], neg[1:]], axis=0).astype(np.float32)
        _TABLES[key] = torch.from_numpy(np.ascontiguousarray(table)).to(device)
    return _TABLES[key]


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T - 1) -> (B, H, T, T): ESPnet's shifting trick."""
    b, h, t1, t2 = x.shape
    padded = torch.cat([torch.zeros((b, h, t1, 1), dtype=x.dtype, device=x.device), x], dim=-1)
    return padded.reshape(b, h, t2 + 1, t1)[:, :, 1:].reshape(b, h, t1, t2)[..., : (t2 + 1) // 2]


class ConformerLayer(nn.Module):
    """Pre-LN relative-position MHSA + pre-LN swish FFN; the attention a plain f32 block."""

    def __init__(self, hidden: int, heads: int, ffn: int, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.hidden, self.heads, self.dtype = hidden, heads, dtype
        self.norm_mha = AffineLayerNorm(hidden, dtype, eps=1e-5)
        for name in ("attn_q", "attn_k", "attn_v", "attn_out"):
            self.add_module(name, LoRADense(hidden, hidden, dtype=dtype))
        self.linear_pos = LoRADense(hidden, hidden, use_bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.empty(heads, hidden // heads, dtype=torch.float32))
        self.pos_bias_v = nn.Parameter(torch.empty(heads, hidden // heads, dtype=torch.float32))
        self.norm_ff = AffineLayerNorm(hidden, dtype, eps=1e-5)
        self.ff_1 = LoRADense(hidden, ffn, dtype=dtype)
        self.ff_2 = LoRADense(ffn, hidden, dtype=dtype)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = math.sqrt(6.0 / (self.heads + self.hidden // self.heads))  # flax xavier_uniform of (H, dk)
        self.pos_bias_u.uniform_(-bound, bound, generator=generator)
        self.pos_bias_v.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        batch, seq = x.shape[:2]
        dk = self.hidden // self.heads
        h = self.norm_mha(x)
        q, k, v = (getattr(self, name)(h).reshape(batch, seq, self.heads, dk).to(torch.float32).transpose(1, 2)
                   for name in ("attn_q", "attn_k", "attn_v"))
        p = self.linear_pos(pos_emb.to(self.dtype)).reshape(-1, self.heads, dk).to(torch.float32)
        ac = (q + self.pos_bias_u[None, :, None]) @ k.transpose(2, 3)
        bd = _rel_shift((q + self.pos_bias_v[None, :, None]) @ p.permute(1, 2, 0)[None])
        scores = (ac + bd) / math.sqrt(dk)
        if mask is not None:
            scores = scores.masked_fill(~mask.to(torch.bool)[:, None, None, :], float("-inf"))
        probs = torch.nan_to_num(torch.softmax(scores, dim=-1))
        attn = (probs @ v).transpose(1, 2).reshape(batch, seq, self.hidden).to(self.dtype)
        x = x + self.attn_out(attn)
        return x + self.ff_2(F.silu(self.ff_1(self.norm_ff(x))))


class LyricEncoder(nn.Module):
    """wenet ConformerEncoder with ACE-Step's settings: the linear embed, ESPnet
    relative positions, attention over every valid key, the after-norm."""

    def __init__(self, config: ACEStepConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        d = config.lyric_hidden
        self.lyric_embs = nn.Parameter(torch.empty(config.lyric_vocab, d, dtype=torch.float32))
        self.embed_out = LoRADense(d, d, dtype=dtype)
        self.embed_norm = AffineLayerNorm(d, dtype, eps=1e-5)
        for i in range(config.lyric_depth):
            self.add_module(f"layer_{i}", ConformerLayer(d, config.lyric_heads, config.lyric_ffn, dtype))
        self.after_norm = AffineLayerNorm(d, dtype, eps=1e-5)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.lyric_embs.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        d = self.config.lyric_hidden
        x = self.embed_norm(self.embed_out(take_rows(self.lyric_embs, tokens).to(self.dtype))) * math.sqrt(d)
        pos_emb = espnet_rel_pos(x.shape[1], d, x.device)
        for i in range(self.config.lyric_depth):
            x = getattr(self, f"layer_{i}")(x, pos_emb, mask)
        return self.after_norm(x)


class ACEStepTransformer(nn.Module):
    """The ACE-Step DiT.  ``latents`` (B, H_mel, T, C) mel-layout latents,
    ``timesteps`` (B,) flow sigmas, ``text_embeds`` (B, L, text_dim), the
    optional speaker embeds (B, speaker_dim), lyric ids and mask (B, L_lyric),
    text mask (B, L) and latent mask (B, T); returns (B, H_mel, T, C) f32."""

    def __init__(self, config: ACEStepConfig = ACEStepConfig(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim, channels = config.inner_dim, config.in_channels
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.speaker_embedder = LoRADense(config.speaker_dim, dim, dtype=dtype)
        self.genre_embedder = LoRADense(config.text_dim, dim, dtype=dtype)
        self.lyric_encoder = LyricEncoder(config, dtype)
        self.lyric_proj = LoRADense(config.lyric_hidden, dim, dtype=dtype)
        self.time_in = MLPEmbedder(256, dim, dtype=dtype)
        self.t_block = LoRADense(dim, 6 * dim, dtype=dtype)
        patch = channels * config.patch_mult
        self.patch_conv = nn.Conv2d(channels, patch, (config.latent_height, 1), stride=(config.latent_height, 1),
                                    dtype=dtype)
        self.patch_norm = nn.GroupNorm(min(32, patch), patch, eps=1e-6, dtype=torch.float32)
        self.patch_proj = nn.Conv2d(patch, dim, 1, dtype=dtype)
        for layer in range(config.num_layers):
            self.add_module(f"block_{layer}", ACEStepBlock(config, dtype, lora_rank, lora_alpha, lora_algo))
        for head, ssl_dim in enumerate(config.ssl_dims):
            for j, (fan_in, feat) in enumerate(((dim, 2 * dim), (2 * dim, 2 * dim), (2 * dim, ssl_dim))):
                self.add_module(f"projector_{head}_{j}", LoRADense(fan_in, feat, dtype=dtype))
        self.final_scale_shift_table = nn.Parameter(torch.empty(2, dim, dtype=torch.float32))
        self.final_proj = LoRADense(dim, config.latent_height * channels, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.final_scale_shift_table.normal_(0.0, 1.0 / math.sqrt(self.config.inner_dim), generator=generator)

    def encode_conditioning(self, text_embeds: torch.Tensor, speaker_embeds: torch.Tensor,
                            lyric_tokens: torch.Tensor, lyric_mask: torch.Tensor,
                            text_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The [speaker (1), genre (text), lyrics] sequence and its f32 mask."""
        dtype = self.dtype
        spk = self.speaker_embedder(speaker_embeds.to(dtype))[:, None]
        genre = self.genre_embedder(text_embeds.to(dtype))
        lyric = self.lyric_proj(self.lyric_encoder(lyric_tokens, lyric_mask))
        ones = torch.ones((text_embeds.shape[0], 1), dtype=torch.float32, device=text_embeds.device)
        t_mask = text_mask if text_mask is not None else torch.ones(
            text_embeds.shape[:2], dtype=torch.float32, device=text_embeds.device)
        mask = torch.cat([ones, t_mask.to(torch.float32), lyric_mask.to(torch.float32)], dim=1)
        return torch.cat([spk, genre, lyric], dim=1), mask

    def _run(self, name: str, *args):
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, text_embeds: torch.Tensor,
                speaker_embeds: Optional[torch.Tensor] = None, lyric_tokens: Optional[torch.Tensor] = None,
                lyric_mask: Optional[torch.Tensor] = None, text_mask: Optional[torch.Tensor] = None,
                latent_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        batch, _, t_len, channels = latents.shape
        device = latents.device
        if speaker_embeds is None:
            speaker_embeds = torch.zeros((batch, cfg.speaker_dim), dtype=torch.float32, device=device)
        if lyric_tokens is None:
            lyric_tokens = torch.zeros((batch, 1), dtype=torch.int32, device=device)
        if lyric_mask is None:
            lyric_mask = torch.ones(lyric_tokens.shape, dtype=torch.float32, device=device)
        context, context_mask = self.encode_conditioning(text_embeds, speaker_embeds, lyric_tokens, lyric_mask,
                                                         text_mask)

        # timestep: sinusoid(sigma x 1000) -> MLP -> the shared 6-way t_block
        embedded_t = self.time_in(timestep_embedding(timesteps, 256).to(dtype))
        temb6 = self.t_block(F.silu(embedded_t.to(torch.float32)).to(dtype))

        # patch embed: the (H_mel, 1) conv -> GroupNorm in f32 -> the 1 x 1 projection
        x = self.patch_conv(latents.to(dtype).permute(0, 3, 1, 2))
        norm = self.patch_norm
        x = F.group_norm(x.to(torch.float32), norm.num_groups, norm.weight, norm.bias, norm.eps).to(dtype)
        x = F.linear(x.permute(0, 2, 3, 1), self.patch_proj.weight.flatten(1), self.patch_proj.bias)
        x = x.reshape(batch, -1, cfg.inner_dim)

        rope_self = qwen2_rope_tables(x.shape[1], cfg.head_dim, cfg.rope_theta, device)
        rope_cross = qwen2_rope_tables(context.shape[1], cfg.head_dim, cfg.rope_theta, device)
        q_seg = (torch.ones((batch, x.shape[1]), dtype=torch.int32, device=device) if latent_mask is None
                 else (latent_mask == 1).to(torch.int32))
        kv_seg = torch.where(context_mask == 1, 1, -1).to(torch.int32)
        for layer in range(cfg.num_layers):
            x = self._run(f"block_{layer}", x, context, temb6, rope_self, rope_cross, latent_mask, q_seg, kv_seg)

        # the final layer: affine-free RMS norm, (2, dim) table + embedded t, then the unpatchify
        mods = self.final_scale_shift_table[None] + embedded_t.to(torch.float32)[:, None]
        x_n = rms_plain(x).to(torch.float32) * (1 + mods[:, 1][:, None]) + mods[:, 0][:, None]
        out = self.final_proj(x_n.to(dtype)).reshape(batch, t_len, cfg.latent_height, channels)
        return out.permute(0, 2, 1, 3).to(torch.float32)
