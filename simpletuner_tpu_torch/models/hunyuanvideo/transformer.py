"""HunyuanVideo 1.5 MMDiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/hunyuanvideo/transformer.py`` (the
``HunyuanVideo15Transformer3DModel``): ``patch_in`` over the packed latent
channels (65 at the published size: 32 latents, 32 condition latents and a
mask; the (1, 1, 1) patch, so one dense); the timestep (x 1000) through a
256-dim sinusoid and ``time_in``; the Qwen2.5-VL states through the token
refiner (a masked mean pool and the timestep into ``time_in`` / ``text_in``,
``proj_in``, then ``refiner_depth`` blocks of affine-LayerNorm
self-attention and SiLU MLP with gates from ``adanorm_lin``); the ByT5
states through ``byt5_norm`` and ``byt5_in_1..3`` (2048, 2048, dim, exact
gelu); the optional SigLIP image embeds through their projection; each
conditioning stream plus its row of ``cond_type_embed``; then ``depth``
dual-stream blocks (AdaLayerNormZero on both streams from ``silu(temb)``,
per-head RMS q / k norms, the interleaved rope on the video tokens only,
one joint attention with the video tokens first, tanh-gelu MLPs) and the
scale-first AdaLayerNormContinuous head.  Submodules keep the JAX names
(``block_{i}.img_attn_q``, ``refiner.block_{i}.norm1.LayerNorm_0``), so the
bridge maps a Flax tree by name.

Mirrored as the JAX module computes it: the reference's valid-first
reordering of the text tokens is replaced by segment ids, so a padded Qwen
or ByT5 token carries segment id -1 (``SEGMENT_PAD_ID``) in the refiner and
in every joint layer: it neither attends nor is attended, and its row of
the op comes out 0.  All-zero image embeds (a t2v batch) have their
projection zeroed and their tokens masked at -1, decided on the device.
The rope tables (theta 256, axes (16, 56, 56), each frequency's pair
repeated) are made in float64 on the host and rounded to f32, once per
latent grid and device; the rope and every norm compute in f32.  Remat
(``gradient_checkpointing``) checkpoints every dual-stream block whole, as
``nn.remat`` wraps ``HunyuanBlock``; the refiner is not checkpointed.  The
JAX module's per-block ``intermediates`` tap (CREPA) is not ported (ROADMAP
Queue 1 item 4h).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import dot_product_attention
from ..layers import LoRADense, MLPEmbedder, RMSNorm, layer_norm, timestep_embedding
from ..wan.transformer import AffineLayerNorm


@dataclasses.dataclass(frozen=True)
class HunyuanVideo15Config:
    in_channels: int = 65  # 32 latents + 32 cond latents + 1 mask (the i2v packing)
    out_channels: int = 32
    num_heads: int = 16
    head_dim: int = 128
    depth: int = 54
    refiner_depth: int = 2
    mlp_ratio: float = 4.0
    patch: Tuple[int, int, int] = (1, 1, 1)
    text_dim: int = 3584  # Qwen2.5-VL
    text2_dim: int = 1472  # ByT5
    image_embed_dim: int = 1152  # SigLIP
    rope_theta: float = 256.0
    axes_dim: Tuple[int, ...] = (16, 56, 56)

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim

    @classmethod
    def tiny(cls) -> "HunyuanVideo15Config":
        return cls(in_channels=8, out_channels=8, num_heads=2, head_dim=32, depth=2, refiner_depth=1, text_dim=32,
                   text2_dim=24, image_embed_dim=16, axes_dim=(8, 12, 12))


# the ByT5 projection's hidden width (fixed in the reference module)
BYT5_HIDDEN = 2048


def hunyuan_rope(cfg: HunyuanVideo15Config, t: int, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(t * h * w, head_dim) cos and sin, float64 rounded to f32: per axis
    ``1 / theta^(2k / d)`` at the grid's positions, each pair repeated, the
    axes concatenated over (t, h, w)."""
    grids = np.meshgrid(np.arange(t, dtype=np.float64), np.arange(h, dtype=np.float64),
                        np.arange(w, dtype=np.float64), indexing="ij")
    parts_cos, parts_sin = [], []
    for axis, dim in enumerate(cfg.axes_dim):
        inv = 1.0 / (cfg.rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        freqs = np.outer(grids[axis].reshape(-1), inv)
        parts_cos.append(np.repeat(np.cos(freqs), 2, axis=1))
        parts_sin.append(np.repeat(np.sin(freqs), 2, axis=1))
    return (np.concatenate(parts_cos, axis=1).astype(np.float32),
            np.concatenate(parts_sin, axis=1).astype(np.float32))


def _apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """diffusers ``apply_rotary_emb`` on interleaved pairs of (B, S, H, D) ``x``, in f32."""
    xf = x.to(torch.float32)
    rotated = torch.stack([-xf[..., 1::2], xf[..., 0::2]], dim=-1).reshape(xf.shape)
    return (xf * cos[None, :, None, :] + rotated * sin[None, :, None, :]).to(x.dtype)


def _segments(mask: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """Segment ids of a conditioning stream: 0 where valid, -1 on pads (all 0 without a mask)."""
    if mask is None:
        return torch.zeros(like.shape[:2], dtype=torch.int32, device=like.device)
    return torch.where(mask.to(torch.int32) > 0, 0, -1).to(torch.int32)


class RefinerBlock(nn.Module):
    """The individual token refiner block: affine LayerNorms, self-attention
    over the caption (pads at -1), SiLU MLP, both gated from ``adanorm_lin``."""

    def __init__(self, config: HunyuanVideo15Config, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim = config.hidden_size
        self.adanorm_lin = LoRADense(dim, 2 * dim, dtype=dtype)
        self.norm1 = AffineLayerNorm(dim, dtype)
        for name in ("attn_q", "attn_k", "attn_v", "attn_proj"):
            self.add_module(name, LoRADense(dim, dim, dtype=dtype))
        self.norm2 = AffineLayerNorm(dim, dtype)
        self.ff_in = LoRADense(dim, int(dim * config.mlp_ratio), dtype=dtype)
        self.ff_out = LoRADense(int(dim * config.mlp_ratio), dim, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor, mask_seg: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.config
        batch, seq = x.shape[:2]
        gate_msa, gate_mlp = self.adanorm_lin(F.silu(temb.to(torch.float32)).to(self.dtype)).chunk(2, dim=-1)
        x_n = self.norm1(x)
        shape = (batch, seq, cfg.num_heads, cfg.head_dim)
        attn = dot_product_attention(self.attn_q(x_n).reshape(shape), self.attn_k(x_n).reshape(shape),
                                     self.attn_v(x_n).reshape(shape), q_segment_ids=mask_seg,
                                     kv_segment_ids=mask_seg).reshape(batch, seq, -1)
        x = x + gate_msa[:, None] * self.attn_proj(attn)
        return x + gate_mlp[:, None] * self.ff_out(F.silu(self.ff_in(self.norm2(x))))


class TokenRefiner(nn.Module):
    """The Qwen stream's refiner: pooled caption and timestep conditioning,
    ``proj_in``, then the blocks."""

    def __init__(self, config: HunyuanVideo15Config, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim = config.hidden_size
        self.time_in = MLPEmbedder(256, dim, dtype=dtype)
        self.text_in = MLPEmbedder(config.text_dim, dim, dtype=dtype)
        self.proj_in = LoRADense(config.text_dim, dim, dtype=dtype)
        for i in range(config.refiner_depth):
            self.add_module(f"block_{i}", RefinerBlock(config, dtype))

    def forward(self, text: torch.Tensor, timesteps: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        dtype = self.dtype
        if mask is None:
            pooled, mask_seg = text.mean(dim=1), None
        else:
            mf = mask.to(torch.float32)[..., None]
            pooled = ((text.to(torch.float32) * mf).sum(dim=1) / mf.sum(dim=1).clamp(min=1.0)).to(text.dtype)
            mask_seg = _segments(mask, text)  # pads neither attend nor are attended
        temb = self.time_in(timestep_embedding(timesteps, 256, time_factor=1.0).to(dtype)) + \
            self.text_in(pooled.to(dtype))
        x = self.proj_in(text)
        for i in range(self.config.refiner_depth):
            x = getattr(self, f"block_{i}")(x, temb, mask_seg)
        return x


class HunyuanBlock(nn.Module):
    """A dual-stream block: (B, S_img, dim) video and (B, S_txt, dim)
    conditioning tokens, ``temb`` (B, dim), the video rope (cos, sin) and
    the joint sequence's segment ids."""

    def __init__(self, config: HunyuanVideo15Config, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, mlp = config.hidden_size, int(config.hidden_size * config.mlp_ratio)
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.norm1_lin = LoRADense(dim, 6 * dim, dtype=dtype)
        self.norm1_context_lin = LoRADense(dim, 6 * dim, dtype=dtype)
        for stream in ("img", "txt"):
            for name in ("q", "k", "v", "proj"):
                self.add_module(f"{stream}_attn_{name}", LoRADense(dim, dim, **lora))
            self.add_module(f"{stream}_attn_norm_q", RMSNorm(config.head_dim, dtype=dtype))
            self.add_module(f"{stream}_attn_norm_k", RMSNorm(config.head_dim, dtype=dtype))
            self.add_module(f"{stream}_mlp_in", LoRADense(dim, mlp, **lora))
            self.add_module(f"{stream}_mlp_out", LoRADense(mlp, dim, **lora))

    def _qkv(self, stream: str, x: torch.Tensor):
        cfg = self.config
        shape = (x.shape[0], x.shape[1], cfg.num_heads, cfg.head_dim)
        q = getattr(self, f"{stream}_attn_norm_q")(getattr(self, f"{stream}_attn_q")(x).reshape(shape))
        k = getattr(self, f"{stream}_attn_norm_k")(getattr(self, f"{stream}_attn_k")(x).reshape(shape))
        return q, k, getattr(self, f"{stream}_attn_v")(x).reshape(shape)

    def forward(self, img: torch.Tensor, txt: torch.Tensor, temb: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, segment_ids: torch.Tensor):
        dtype = self.dtype
        batch, s_img = img.shape[:2]
        silu_t = F.silu(temb.to(torch.float32)).to(dtype)
        i_mods = [m[:, None] for m in self.norm1_lin(silu_t).chunk(6, dim=-1)]
        t_mods = [m[:, None] for m in self.norm1_context_lin(silu_t).chunk(6, dim=-1)]

        iq, ik, iv = self._qkv("img", layer_norm(img, dtype) * (1 + i_mods[1]) + i_mods[0])
        tq, tk, tv = self._qkv("txt", layer_norm(txt, dtype) * (1 + t_mods[1]) + t_mods[0])
        iq, ik = _apply_rope_interleaved(iq, cos, sin), _apply_rope_interleaved(ik, cos, sin)
        # video tokens first, then the conditioning tokens
        attn = dot_product_attention(torch.cat([iq, tq], dim=1), torch.cat([ik, tk], dim=1),
                                     torch.cat([iv, tv], dim=1), q_segment_ids=segment_ids,
                                     kv_segment_ids=segment_ids).reshape(batch, -1, self.config.hidden_size)
        img = img + i_mods[2] * self.img_attn_proj(attn[:, :s_img])
        txt = txt + t_mods[2] * self.txt_attn_proj(attn[:, s_img:])

        h = self.img_mlp_in(layer_norm(img, dtype) * (1 + i_mods[4]) + i_mods[3])
        img = img + i_mods[5] * self.img_mlp_out(F.gelu(h, approximate="tanh"))
        h = self.txt_mlp_in(layer_norm(txt, dtype) * (1 + t_mods[4]) + t_mods[3])
        txt = txt + t_mods[5] * self.txt_mlp_out(F.gelu(h, approximate="tanh"))
        return img, txt


class HunyuanVideo15Transformer(nn.Module):
    """The HunyuanVideo 1.5 DiT.  ``latents`` (B, T, H, W, in_channels),
    ``timesteps`` (B,) sigma in [0, 1], ``context`` (B, L1, text_dim) Qwen
    states with ``context_mask`` (B, L1), ``context_2`` (B, L2, text2_dim)
    ByT5 states with ``context_2_mask``, ``image_embeds`` (B, L3,
    image_embed_dim); returns (B, T, H, W, out_channels) in f32."""

    def __init__(self, config: HunyuanVideo15Config = HunyuanVideo15Config(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim = config.hidden_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.patch_in = LoRADense(int(np.prod(config.patch)) * config.in_channels, dim, **lora)
        self.time_in = MLPEmbedder(256, dim, dtype=dtype)
        self.cond_type_embed = nn.Parameter(torch.empty(3, dim, dtype=torch.float32))
        self.refiner = TokenRefiner(config, dtype)
        self.byt5_norm = AffineLayerNorm(config.text2_dim, dtype)
        self.byt5_in_1 = LoRADense(config.text2_dim, BYT5_HIDDEN, dtype=dtype)
        self.byt5_in_2 = LoRADense(BYT5_HIDDEN, BYT5_HIDDEN, dtype=dtype)
        self.byt5_in_3 = LoRADense(BYT5_HIDDEN, dim, dtype=dtype)
        self.img_embed_norm_in = AffineLayerNorm(config.image_embed_dim, dtype)
        self.img_embed_in_1 = LoRADense(config.image_embed_dim, config.image_embed_dim, dtype=dtype)
        self.img_embed_in_2 = LoRADense(config.image_embed_dim, dim, dtype=dtype)
        self.img_embed_norm_out = AffineLayerNorm(dim, dtype)
        for layer in range(config.depth):
            self.add_module(f"block_{layer}", HunyuanBlock(config, **lora))
        self.final_mod = LoRADense(dim, 2 * dim, dtype=dtype)
        self.final_proj = LoRADense(dim, config.out_channels, dtype=dtype)
        self._rope: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.cond_type_embed.normal_(0.0, 0.02, generator=generator)

    def rope(self, grid: Tuple[int, int, int], device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The video rope's (cos, sin) on ``device``, made once per grid (before a captured step needs it)."""
        key = (*grid, device)
        if key not in self._rope:
            self._rope[key] = tuple(torch.from_numpy(a).to(device) for a in hunyuan_rope(self.config, *grid))
        return self._rope[key]

    def _run(self, layer: int, *args):
        block = getattr(self, f"block_{layer}")
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None, context_2: Optional[torch.Tensor] = None,
                context_2_mask: Optional[torch.Tensor] = None,
                image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        batch, t, h, w, channels = latents.shape
        t1000 = timesteps * 1000.0
        x = self.patch_in(latents.reshape(batch, t * h * w, channels))
        temb = self.time_in(timestep_embedding(t1000, 256, time_factor=1.0).to(dtype))
        cond_type = self.cond_type_embed.to(dtype)

        streams = [self.refiner(context, t1000, context_mask) + cond_type[0]]
        seg_parts = [_segments(context_mask, streams[0])]
        if context_2 is not None:
            t2 = self.byt5_in_1(self.byt5_norm(context_2))
            t2 = self.byt5_in_3(F.gelu(self.byt5_in_2(F.gelu(t2))))
            streams.append(t2 + cond_type[1])
            seg_parts.append(_segments(context_2_mask, t2))
        if image_embeds is not None:
            im = self.img_embed_in_1(self.img_embed_norm_in(image_embeds))
            im = self.img_embed_norm_out(self.img_embed_in_2(F.gelu(im)))
            # t2v batches pass all-zero image embeds: the projection is zeroed
            # (the cond-type row still added) and the tokens masked out, on the device
            is_t2v = (image_embeds == 0.0).all()
            streams.append((~is_t2v).to(im.dtype) * im + cond_type[2])
            seg_parts.append(torch.where(is_t2v, -1, 0).to(torch.int32).expand(im.shape[:2]))
        txt = torch.cat(streams, dim=1)
        segment_ids = torch.cat([torch.zeros((batch, x.shape[1]), dtype=torch.int32, device=x.device),
                                 *seg_parts], dim=1)

        cos, sin = self.rope((t, h, w), latents.device)
        for layer in range(cfg.depth):
            x, txt = self._run(layer, x, txt, temb, cos, sin, segment_ids)

        # AdaLayerNormContinuous: (scale, shift), scale first
        scale, shift = self.final_mod(F.silu(temb.to(torch.float32)).to(dtype)).chunk(2, dim=-1)
        x = layer_norm(x, dtype) * (1 + scale[:, None]) + shift[:, None]
        return self.final_proj(x).reshape(batch, t, h, w, cfg.out_channels).to(torch.float32)
