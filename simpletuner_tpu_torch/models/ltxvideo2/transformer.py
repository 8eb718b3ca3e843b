"""LTX-2 audiovisual DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/ltxvideo2/transformer.py`` (the
vendored ``LTX2VideoTransformer3DModel``): 48 dual-modal blocks, a video
stream of 32 heads x 128 and an audio stream of 32 heads x 64, each block
running video and audio self-attention, video and audio prompt
cross-attention, a2v (video queries, audio keys) and v2a (audio queries,
video keys) at 32 heads of 64, then a tanh-gelu FFN per stream.  Every
attention is ``LTX2Attention``: biased q / k / v, affine RMS q / k norms
across the whole projection width, interleaved RoPE at that width applied
before the head split, optional per-head ``2 sigmoid`` gates.  Modulation is
adaLN-single with tokenwise embeddings (``_TimestepAdaLN``: (B,) or (B, S)
sigma values give one (shift, scale, gate) set per token, a (B, 1, n dim)
tensor for a scalar sigma that broadcasts over the tokens); per-block tables
offset them in f32 (``_mod_params``), the six self / FFN tensors cast to the
compute dtype once, the a2v / v2a ones at each use.

The RoPE coordinates are fractional (seconds and pixels from patch-boundary
midpoints, the causal first-frame shift) and the tables float64 numpy on the
host, made once per grid and device (``LTX2Transformer.rope``), so a
captured step reads them and makes none.  IC-LoRA reference tokens go ahead
of the target tokens at per-token t (1 - strength), their coordinates
re-scaled into the target frame, and are dropped from the output.

Where the JAX module computes a dense f32 softmax, every attention here goes
through :func:`dot_product_attention` (the Hopper flash kernels on the card,
q / k / v in the compute dtype; the plain version on the CPU).  The text
mask's additive (1 - mask) x -10000 key bias becomes key ids -1 with query
ids 1: equal on every row with a valid key (exp(-10000) is 0 in f32); on a
fully masked caption the JAX bias shifts every logit alike, so its softmax
is the unmasked one, while the kernels give 0 (ROADMAP, "JAX behaviour the
port does not share").  Submodules keep the JAX names; remat checkpoints
every block whole, as ``nn.remat`` wraps ``LTX2Block``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import dot_product_attention, key_mask_segments
from ..cosmos1.transformer import rms
from ..layers import FeedForward, LoRADense, layer_norm, timestep_embedding

Rope = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LTX2Config:
    # video stream
    in_channels: int = 128
    patch_size: int = 1
    patch_size_t: int = 1
    num_heads: int = 32
    head_dim: int = 128
    cross_attention_dim: int = 4096
    vae_scale_factors: Tuple[int, int, int] = (8, 32, 32)
    pos_embed_max_pos: int = 20
    base_height: int = 2048
    base_width: int = 2048
    gated_attn: bool = False
    # audio stream
    audio_in_channels: int = 128
    audio_num_heads: int = 32
    audio_head_dim: int = 64
    audio_cross_attention_dim: int = 2048
    audio_scale_factor: int = 4
    audio_pos_embed_max_pos: int = 20
    audio_sampling_rate: int = 16000
    audio_hop_length: int = 160
    audio_gated_attn: bool = False
    # shared
    num_layers: int = 48
    caption_channels: int = 3840
    rope_theta: float = 10000.0
    causal_offset: int = 1
    norm_eps: float = 1e-6

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def audio_inner_dim(self) -> int:
        return self.audio_num_heads * self.audio_head_dim

    @classmethod
    def tiny(cls) -> "LTX2Config":
        return cls(
            in_channels=8, num_heads=2, head_dim=16, cross_attention_dim=24,
            audio_in_channels=6, audio_num_heads=2, audio_head_dim=8,
            audio_cross_attention_dim=16, num_layers=2, caption_channels=20,
        )


# ---- RoPE (LTX2AudioVideoRotaryPosEmbed) --------------------------------------------------


def ltx2_video_coords(config: LTX2Config, num_frames: int, height: int, width: int, fps: float = 25.0) -> np.ndarray:
    """Fractional (t seconds, h px, w px) patch midpoints, (S, 3) float64:
    pixel-space boundaries with the causal first-frame shift, the temporal
    axis over ``fps``."""
    sf = config.vae_scale_factors
    grid = np.stack(np.meshgrid(
        np.arange(0, num_frames, config.patch_size_t, dtype=np.float64),
        np.arange(0, height, config.patch_size, dtype=np.float64),
        np.arange(0, width, config.patch_size, dtype=np.float64),
        indexing="ij"), axis=0).reshape(3, -1)
    patch = np.asarray([config.patch_size_t, config.patch_size, config.patch_size], np.float64)
    start = grid * np.asarray(sf, np.float64)[:, None]
    end = (grid + patch[:, None]) * np.asarray(sf, np.float64)[:, None]
    for arr in (start, end):
        arr[0] = np.clip(arr[0] + config.causal_offset - sf[0], 0, None) / fps
    return ((start + end) / 2.0).T


def ltx2_audio_coords(config: LTX2Config, num_frames: int) -> np.ndarray:
    """Per-latent-frame (start + end) / 2 timestamps in seconds, (S, 1) float64."""
    sf = config.audio_scale_factor
    grid = np.arange(0, num_frames, config.patch_size_t, dtype=np.float64)
    start = np.clip(grid * sf + config.causal_offset - sf, 0, None)
    end = np.clip((grid + config.patch_size_t) * sf + config.causal_offset - sf, 0, None)
    to_s = config.audio_hop_length / config.audio_sampling_rate
    return ((start * to_s + end * to_s) / 2.0)[:, None]


def ltx2_rope_tables(coords: np.ndarray, max_positions: Sequence[float], dim: int,
                     theta: float) -> Tuple[np.ndarray, np.ndarray]:
    """(S, ndims) coordinates -> interleaved (S, dim) f32 cos / sin, built in
    float64: frequencies theta^linspace(0, 1) x pi / 2 per axis over the
    coordinates scaled to [-1, 1], each angle repeated for its pair, the
    ``dim % (2 ndims)`` leading channels padded with cos 1 / sin 0."""
    ndims = coords.shape[1]
    n_freq = dim // (2 * ndims)
    frac = coords / np.asarray(max_positions, np.float64)[None, :]
    freqs = theta ** np.linspace(0.0, 1.0, n_freq, dtype=np.float64) * math.pi / 2.0
    angles = (frac[:, :, None] * 2.0 - 1.0) * freqs[None, None]
    angles = np.swapaxes(angles, 1, 2).reshape(coords.shape[0], -1)
    cos = np.repeat(np.cos(angles), 2, axis=-1)
    sin = np.repeat(np.sin(angles), 2, axis=-1)
    pad = dim % (2 * ndims)
    if pad:
        cos = np.concatenate([np.ones_like(cos[:, :pad]), cos], axis=-1)
        sin = np.concatenate([np.zeros_like(sin[:, :pad]), sin], axis=-1)
    return cos.astype(np.float32), sin.astype(np.float32)


def apply_interleaved_rope(x: torch.Tensor, rope: Rope) -> torch.Tensor:
    """``x`` (B, S, C) rotated in interleaved pairs by full-width (S, C)
    tables, in f32, back to ``x``'s dtype."""
    cos, sin = rope
    x_f = x.to(torch.float32)
    rotated = torch.stack([-x_f[..., 1::2], x_f[..., 0::2]], dim=-1).reshape(x.shape)
    return (x_f * cos[None] + rotated * sin[None]).to(x.dtype)


def rms_plain(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free RMS norm in f32, back to ``x``'s dtype."""
    x_f = x.to(torch.float32)
    return (x_f * torch.rsqrt(x_f.square().mean(dim=-1, keepdim=True) + eps)).to(x.dtype)


class LTX2Attention(nn.Module):
    """Biased q / k / v from ``query_dim`` (and ``kv_dim`` for a context),
    affine RMS q / k norms over the ``heads x head_dim`` width, RoPE before
    the head split, the attention op, optional per-head ``2 sigmoid`` gates
    from an adapter-free ``to_gate_logits``, ``to_out`` to ``out_dim``."""

    def __init__(self, query_dim: int, heads: int, head_dim: int, out_dim: int, kv_dim: Optional[int] = None,
                 gated: bool = False, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.heads, self.head_dim, self.gated, self.dtype = heads, head_dim, gated, dtype
        inner, kv_dim = heads * head_dim, kv_dim or query_dim
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.to_q = LoRADense(query_dim, inner, **lora)
        self.to_k = LoRADense(kv_dim, inner, **lora)
        self.to_v = LoRADense(kv_dim, inner, **lora)
        self.norm_q = nn.Parameter(torch.empty(inner, dtype=torch.float32))
        self.norm_k = nn.Parameter(torch.empty(inner, dtype=torch.float32))
        if gated:
            self.to_gate_logits = LoRADense(query_dim, heads, dtype=dtype)
        self.to_out = LoRADense(inner, out_dim, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.norm_q.fill_(1.0)
        self.norm_k.fill_(1.0)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None, q_rope: Optional[Rope] = None,
                k_rope: Optional[Rope] = None, q_ids: Optional[torch.Tensor] = None,
                key_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = x if context is None else context
        batch, q_len = x.shape[:2]
        q = rms(self.to_q(x), self.norm_q, 1e-6)
        k = rms(self.to_k(kv), self.norm_k, 1e-6)
        v = self.to_v(kv)
        if q_rope is not None:
            q = apply_interleaved_rope(q, q_rope)
            k = apply_interleaved_rope(k, k_rope if k_rope is not None else q_rope)
        heads = (self.heads, self.head_dim)
        out = dot_product_attention(q.reshape(batch, q_len, *heads), k.reshape(batch, -1, *heads),
                                    v.reshape(batch, -1, *heads), q_segment_ids=q_ids, kv_segment_ids=key_ids)
        if self.gated:
            gates = 2.0 * torch.sigmoid(self.to_gate_logits(x).to(torch.float32))
            out = out.to(torch.float32) * gates[..., None]
        return self.to_out(out.reshape(batch, q_len, -1).to(self.dtype))


def _mod_params(table: torch.Tensor, temb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-block table (n, d) plus a (B, S, n d) or (B, 1, n d) embedding ->
    n f32 tensors (B, S or 1, d)."""
    n, d = table.shape
    values = table[None, None].to(torch.float32) + temb.to(torch.float32).reshape(temb.shape[0], -1, n, d)
    return values.unbind(dim=2)


class LTX2Block(nn.Module):
    """One dual-modal block over ``video`` (B, Sv, dim) and ``audio`` (B,
    Sa, a_dim): the four modulation embeddings, the (cos, sin) tables of the
    two self-attentions and the two cross-modal ones, and the prompt mask as
    query ids per stream and key ids (None: unmasked)."""

    def __init__(self, config: LTX2Config, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, a_dim = config.inner_dim, config.audio_inner_dim
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        video = (config.num_heads, config.head_dim)
        audio = (config.audio_num_heads, config.audio_head_dim)
        self.scale_shift_table = nn.Parameter(torch.empty(6, dim, dtype=torch.float32))
        self.audio_scale_shift_table = nn.Parameter(torch.empty(6, a_dim, dtype=torch.float32))
        self.video_ca_scale_shift_table = nn.Parameter(torch.empty(5, dim, dtype=torch.float32))
        self.audio_ca_scale_shift_table = nn.Parameter(torch.empty(5, a_dim, dtype=torch.float32))
        self.attn1 = LTX2Attention(dim, *video, dim, gated=config.gated_attn, **lora)
        self.audio_attn1 = LTX2Attention(a_dim, *audio, a_dim, gated=config.audio_gated_attn, **lora)
        self.attn2 = LTX2Attention(dim, *video, dim, gated=config.gated_attn, **lora)
        self.audio_attn2 = LTX2Attention(a_dim, *audio, a_dim, gated=config.audio_gated_attn, **lora)
        self.audio_to_video_attn = LTX2Attention(dim, *audio, dim, kv_dim=a_dim, gated=config.gated_attn, **lora)
        self.video_to_audio_attn = LTX2Attention(a_dim, *audio, a_dim, kv_dim=dim, gated=config.audio_gated_attn,
                                                 **lora)
        self.ff = FeedForward(dim, 4.0, **lora)
        self.audio_ff = FeedForward(a_dim, 4.0, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        cfg = self.config
        self.scale_shift_table.normal_(0.0, 1.0 / math.sqrt(cfg.inner_dim), generator=generator)
        self.audio_scale_shift_table.normal_(0.0, 1.0 / math.sqrt(cfg.audio_inner_dim), generator=generator)
        self.video_ca_scale_shift_table.normal_(0.0, 1.0, generator=generator)
        self.audio_ca_scale_shift_table.normal_(0.0, 1.0, generator=generator)

    def forward(self, video: torch.Tensor, audio: torch.Tensor, text_v: torch.Tensor, text_a: torch.Tensor,
                temb: torch.Tensor, temb_audio: torch.Tensor, temb_ca: torch.Tensor, temb_ca_audio: torch.Tensor,
                temb_ca_gate: torch.Tensor, temb_ca_audio_gate: torch.Tensor, video_rope: Rope, audio_rope: Rope,
                ca_video_rope: Rope, ca_audio_rope: Rope, video_ids: Optional[torch.Tensor],
                audio_ids: Optional[torch.Tensor], key_ids: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype, eps = self.dtype, self.config.norm_eps
        sh1, sc1, g1, sh2, sc2, g2 = (m.to(dtype) for m in _mod_params(self.scale_shift_table, temb))
        a_sh1, a_sc1, a_g1, a_sh2, a_sc2, a_g2 = (m.to(dtype) for m in
                                                  _mod_params(self.audio_scale_shift_table, temb_audio))

        # 1. self-attention
        video = video + g1 * self.attn1(rms_plain(video, eps) * (1 + sc1) + sh1, q_rope=video_rope)
        audio = audio + a_g1 * self.audio_attn1(rms_plain(audio, eps) * (1 + a_sc1) + a_sh1, q_rope=audio_rope)

        # 2. prompt cross-attention, the caption mask as key ids
        video = video + self.attn2(rms_plain(video, eps), context=text_v, q_ids=video_ids, key_ids=key_ids)
        audio = audio + self.audio_attn2(rms_plain(audio, eps), context=text_a, q_ids=audio_ids, key_ids=key_ids)

        # 3. a2v / v2a with the temporal cross rope, the f32 modulation cast at each use
        v_norm, a_norm = rms_plain(video, eps), rms_plain(audio, eps)
        v_a2v_sc, v_a2v_sh, v_v2a_sc, v_v2a_sh = _mod_params(self.video_ca_scale_shift_table[:4], temb_ca)
        (a2v_gate,) = _mod_params(self.video_ca_scale_shift_table[4:], temb_ca_gate)
        a_a2v_sc, a_a2v_sh, a_v2a_sc, a_v2a_sh = _mod_params(self.audio_ca_scale_shift_table[:4], temb_ca_audio)
        (v2a_gate,) = _mod_params(self.audio_ca_scale_shift_table[4:], temb_ca_audio_gate)
        q_v = v_norm * (1 + v_a2v_sc.to(dtype)) + v_a2v_sh.to(dtype)
        kv_a = a_norm * (1 + a_a2v_sc.to(dtype)) + a_a2v_sh.to(dtype)
        video = video + a2v_gate.to(dtype) * self.audio_to_video_attn(q_v, context=kv_a, q_rope=ca_video_rope,
                                                                       k_rope=ca_audio_rope)
        q_a = a_norm * (1 + a_v2a_sc.to(dtype)) + a_v2a_sh.to(dtype)
        kv_v = v_norm * (1 + v_v2a_sc.to(dtype)) + v_v2a_sh.to(dtype)
        audio = audio + v2a_gate.to(dtype) * self.video_to_audio_attn(q_a, context=kv_v, q_rope=ca_audio_rope,
                                                                       k_rope=ca_video_rope)

        # 4. feed-forward
        video = video + g2 * self.ff(rms_plain(video, eps) * (1 + sc2) + sh2)
        audio = audio + a_g2 * self.audio_ff(rms_plain(audio, eps) * (1 + a_sc2) + a_sh2)
        return video, audio


class _TimestepAdaLN(nn.Module):
    """LTX2AdaLayerNormSingle: the 256 sinusoid of sigma x 1000 through
    ``in_layer`` / ``out_layer`` and a SiLU ``mod`` to n x dim; returns (mod
    (B, S or 1, n dim), embedded t (B, S or 1, dim))."""

    def __init__(self, dim: int, n_params: int, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dim, self.n_params, self.dtype = dim, n_params, dtype
        self.in_layer = LoRADense(256, dim, dtype=dtype)
        self.out_layer = LoRADense(dim, dim, dtype=dtype)
        self.mod = LoRADense(dim, n_params * dim, dtype=dtype)

    def forward(self, timesteps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        batch = timesteps.shape[0]
        sinusoid = timestep_embedding(timesteps.reshape(-1).to(torch.float32), 256).to(self.dtype)
        emb = self.out_layer(F.silu(self.in_layer(sinusoid)))
        mod = self.mod(F.silu(emb.to(torch.float32)).to(self.dtype))
        return mod.reshape(batch, -1, self.n_params * self.dim), emb.reshape(batch, -1, self.dim)


class LTX2Transformer(nn.Module):
    """The LTX-2 DiT.  ``video_tokens`` (B, Sv, in_channels) packed latents
    of a ``num_frames x height x width`` grid, ``audio_tokens`` (B, Sa,
    audio_in_channels), ``text_embeds`` (B, L, caption_channels),
    ``timesteps`` (B,) or (B, Sv) sigma values (``audio_timesteps`` defaults
    to the first); ``text_mask`` (B, L) 1 = keep; IC-LoRA ``ref_tokens`` (B,
    Sr, in_channels) of the static ``ref_shape`` (F, H, W).  Returns the
    target tokens' (B, Sv, in_channels) and the audio (B, Sa,
    audio_in_channels) predictions in f32."""

    def __init__(self, config: LTX2Config = LTX2Config(), dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora", remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim, a_dim = config.inner_dim, config.audio_inner_dim
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.proj_in = LoRADense(config.in_channels, dim, **lora)
        self.audio_proj_in = LoRADense(config.audio_in_channels, a_dim, **lora)
        self.caption_proj_1 = LoRADense(config.caption_channels, dim, **lora)
        self.caption_proj_2 = LoRADense(dim, dim, **lora)
        self.audio_caption_proj_1 = LoRADense(config.caption_channels, a_dim, **lora)
        self.audio_caption_proj_2 = LoRADense(a_dim, a_dim, **lora)
        self.time_embed = _TimestepAdaLN(dim, 6, dtype)
        self.audio_time_embed = _TimestepAdaLN(a_dim, 6, dtype)
        self.av_ca_video_scale_shift = _TimestepAdaLN(dim, 4, dtype)
        self.av_ca_video_a2v_gate = _TimestepAdaLN(dim, 1, dtype)
        self.av_ca_audio_scale_shift = _TimestepAdaLN(a_dim, 4, dtype)
        self.av_ca_audio_v2a_gate = _TimestepAdaLN(a_dim, 1, dtype)
        for i in range(config.num_layers):
            self.add_module(f"block_{i}", LTX2Block(config, **lora))
        self.scale_shift_table = nn.Parameter(torch.empty(2, dim, dtype=torch.float32))
        self.audio_scale_shift_table = nn.Parameter(torch.empty(2, a_dim, dtype=torch.float32))
        self.proj_out = LoRADense(dim, config.in_channels, **lora)
        self.audio_proj_out = LoRADense(a_dim, config.audio_in_channels, **lora)
        self._rope: Dict[tuple, Tuple[Rope, Rope, Rope, Rope]] = {}

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        cfg = self.config
        self.scale_shift_table.normal_(0.0, 1.0 / math.sqrt(cfg.inner_dim), generator=generator)
        self.audio_scale_shift_table.normal_(0.0, 1.0 / math.sqrt(cfg.audio_inner_dim), generator=generator)

    def rope(self, grid: Tuple[int, int, int], audio_len: int, fps: float, ref: Optional[tuple],
             device: torch.device) -> Tuple[Rope, Rope, Rope, Rope]:
        """The video, audio and two cross-modal (cos, sin) tables of ``grid``
        (with the reference grid ``ref`` = (shape, spatial, temporal) ahead of
        it) on ``device``, made there the first time."""
        key = (grid, audio_len, fps, ref, device)
        if key not in self._rope:
            cfg = self.config
            v_coords = ltx2_video_coords(cfg, *grid, fps)
            if ref is not None:
                # the reference midpoints scaled up into the target's pixel
                # frame; the temporal axis shifted back by (temporal - 1) x the
                # first target patch's temporal end and clamped at 0
                shape, spatial, temporal = ref
                r_coords = ltx2_video_coords(cfg, *shape, fps)
                if temporal != 1:
                    sf_t = cfg.vae_scale_factors[0]
                    first_end = max(cfg.patch_size_t * sf_t + cfg.causal_offset - sf_t, 0.0) / fps
                    r_coords[:, 0] = np.clip(r_coords[:, 0] - (temporal - 1) * first_end, 0.0, None)
                if spatial != 1:
                    r_coords[:, 1:] *= spatial
                v_coords = np.concatenate([r_coords, v_coords], axis=0)
            a_coords = ltx2_audio_coords(cfg, audio_len)
            ca_max = (max(cfg.pos_embed_max_pos, cfg.audio_pos_embed_max_pos),)
            tables = (
                ltx2_rope_tables(v_coords, (cfg.pos_embed_max_pos, cfg.base_height, cfg.base_width), cfg.inner_dim,
                                 cfg.rope_theta),
                ltx2_rope_tables(a_coords, (cfg.audio_pos_embed_max_pos,), cfg.audio_inner_dim, cfg.rope_theta),
                ltx2_rope_tables(v_coords[:, :1], ca_max, cfg.audio_cross_attention_dim, cfg.rope_theta),
                ltx2_rope_tables(a_coords, ca_max, cfg.audio_cross_attention_dim, cfg.rope_theta),
            )
            self._rope[key] = tuple(tuple(torch.from_numpy(a).to(device) for a in pair) for pair in tables)
        return self._rope[key]

    def _run(self, name: str, *args):
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, video_tokens: torch.Tensor, audio_tokens: torch.Tensor, text_embeds: torch.Tensor,
                timesteps: torch.Tensor, num_frames: int, height: int, width: int,
                audio_timesteps: Optional[torch.Tensor] = None, text_mask: Optional[torch.Tensor] = None,
                fps: float = 25.0, ref_tokens: Optional[torch.Tensor] = None, ref_shape: Optional[tuple] = None,
                ref_spatial_scale: int = 1, ref_temporal_scale: int = 1,
                ref_strength: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, dtype = self.config, self.dtype
        batch = video_tokens.shape[0]
        timesteps = timesteps.to(torch.float32)
        if audio_timesteps is None:
            audio_timesteps = timesteps if timesteps.dim() == 1 else timesteps[:, 0]
        # the cross heads read the sigma of the first TARGET token, before any reference goes ahead
        scalar_v = timesteps if timesteps.dim() == 1 else timesteps[:, 0]
        scalar_a = audio_timesteps if audio_timesteps.dim() == 1 else audio_timesteps[:, 0]

        # IC-LoRA reference tokens ahead of the target at per-token t (1 - strength)
        ref, ref_len = None, 0
        if ref_tokens is not None:
            if ref_shape is None:
                raise ValueError("ref_tokens requires the static ref_shape (F, H, W)")
            ref_len = ref_tokens.shape[1]
            target_t = timesteps[:, None].expand(batch, video_tokens.shape[1]) if timesteps.dim() == 1 else timesteps
            strength = torch.ones((batch, ref_len), dtype=torch.float32, device=video_tokens.device) \
                if ref_strength is None else ref_strength.to(torch.float32)
            timesteps = torch.cat([scalar_v[:, None] * (1.0 - strength), target_t], dim=1)
            video_tokens = torch.cat([ref_tokens.to(video_tokens.dtype), video_tokens], dim=1)
            ref = (tuple(int(n) for n in ref_shape), int(ref_spatial_scale or 1), int(ref_temporal_scale or 1))
        video_rope, audio_rope, ca_video_rope, ca_audio_rope = self.rope(
            (num_frames, height, width), audio_tokens.shape[1], float(fps), ref, video_tokens.device)

        video = self.proj_in(video_tokens.to(dtype))
        audio = self.audio_proj_in(audio_tokens.to(dtype))
        text_v = self.caption_proj_2(F.gelu(self.caption_proj_1(text_embeds.to(dtype)), approximate="tanh"))
        text_a = self.audio_caption_proj_2(F.gelu(self.audio_caption_proj_1(text_embeds.to(dtype)),
                                                  approximate="tanh"))
        key_ids = key_mask_segments(text_mask)
        video_ids = audio_ids = None
        if key_ids is not None:
            video_ids = torch.ones(video.shape[:2], dtype=torch.int32, device=video.device)
            audio_ids = torch.ones(audio.shape[:2], dtype=torch.int32, device=audio.device)

        temb, embedded_t = self.time_embed(timesteps)
        temb_audio, audio_embedded_t = self.audio_time_embed(audio_timesteps)
        temb_ca, _ = self.av_ca_video_scale_shift(scalar_v)
        temb_ca_gate, _ = self.av_ca_video_a2v_gate(scalar_v)
        temb_ca_audio, _ = self.av_ca_audio_scale_shift(scalar_a)
        temb_ca_audio_gate, _ = self.av_ca_audio_v2a_gate(scalar_a)

        for i in range(cfg.num_layers):
            video, audio = self._run(f"block_{i}", video, audio, text_v, text_a, temb, temb_audio, temb_ca,
                                     temb_ca_audio, temb_ca_gate, temb_ca_audio_gate, video_rope, audio_rope,
                                     ca_video_rope, ca_audio_rope, video_ids, audio_ids, key_ids)

        # output heads: the (2, dim) tables plus the embedded t in both rows, an f32 LayerNorm
        shift, scale = _mod_params(self.scale_shift_table, torch.cat([embedded_t, embedded_t], dim=-1))
        video_out = self.proj_out((layer_norm(video, dtype).to(torch.float32) * (1 + scale) + shift).to(dtype))
        a_shift, a_scale = _mod_params(self.audio_scale_shift_table,
                                       torch.cat([audio_embedded_t, audio_embedded_t], dim=-1))
        audio_out = self.audio_proj_out((layer_norm(audio, dtype).to(torch.float32) * (1 + a_scale)
                                         + a_shift).to(dtype))
        return video_out[:, ref_len:].to(torch.float32), audio_out.to(torch.float32)
