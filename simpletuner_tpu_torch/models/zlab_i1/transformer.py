"""Zlab-i1 timestep-free U-ViT MMDiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/zlab_i1/transformer.py``
(``ZlabI1Transformer2DModel``): the forward takes no timestep (``del
timesteps``).  Image tokens come from the conv patch embed, flattened in
(c, ph, pw) order, plus a 2-D sincos table (the learned ``pos_embed`` at the
native grid, a table made on the host in float64 once per grid shape and
device elsewhere) whose meshgrid puts the column coordinate in the first
half of each row, verbatim.  Text goes through a two-round connector
(attention + SwiGLU, pre-RMSNorm residuals) with a learnable null caption
in place of a dropped one.

The U-ViT: depth // 2 in blocks, one mid block and depth // 2 out blocks,
each out block first merging the LIFO-popped in-block outputs through
``skip_image`` / ``skip_text``.  A block shares one RMSNorm over both
modalities before its separate fused qkv projections, shares the per-head
RMS q/k norms (eps 1e-6), and post-norms the attention and SwiGLU outputs
through shared norms.  The joint attention is [image | text] with query
segment ids 1 and key segment ids the text mask (image keys 1), so masked
text keys are excluded; masked rows are zeroed after the attention and the
text tokens again at the block's end.  RoPE: text token i at (i, 0, 0)
(masked: 0), image tokens at (valid text length, row, col) with the row and
column scaled by 256 / image size, consecutive pairs rotated in f32.  The
head is an RMSNorm and a linear, with no adaLN, unpatchified in (ph, pw, c)
order.  Submodules keep the JAX names (``in_{i}.qkv_image``,
``text_adapter.connector_attn.qkv``); remat (``gradient_checkpointing``)
checkpoints every block whole.
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
from ..layers import LoRADense, RMSNorm

Angles = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ZlabI1Config:
    input_size: int = 128  # latent pixels (1024 // 8)
    image_resolution: int = 1024
    patch_size: int = 2
    in_channels: int = 32
    hidden_size: int = 2016
    depth: int = 29
    num_heads: int = 28
    mlp_ratio: float = 4.0
    text_embed_dim: int = 2304
    text_num_tokens: int = 256
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6

    @classmethod
    def tiny(cls) -> "ZlabI1Config":
        return cls(
            input_size=16, image_resolution=128, in_channels=8, hidden_size=96,
            depth=3, num_heads=4, text_embed_dim=32, text_num_tokens=12,
        )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_in_blocks(self) -> int:
        return self.depth // 2

    @property
    def ffn_inner(self) -> int:
        return int(2 / 3 * int(self.hidden_size * self.mlp_ratio))

    @property
    def axes_dims(self) -> Tuple[int, int, int]:
        """(time, row, col) rotary dims: half the head to time, the rest split evenly, all even."""
        time_dim = self.head_dim // 2
        if time_dim % 2 != 0:
            time_dim -= 1
        remaining = self.head_dim - time_dim
        row_dim = remaining // 2
        col_dim = remaining - row_dim
        if row_dim % 2 != 0:
            row_dim -= 1
            col_dim += 1
        if col_dim % 2 != 0:
            col_dim -= 1
            row_dim += 1
        return time_dim, row_dim, col_dim


def _get_1d_pos_embed(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.outer(pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_pos_embed(embed_dim: int, grid_height: int, grid_width: int, image_height: int, image_width: int,
                     base_image_resolution: int = 256) -> np.ndarray:
    """(grid_height * grid_width, embed_dim) f32: the grid scaled by 256 /
    image size, meshgrid(w, h) in 'xy' indexing, so the first half encodes
    the column axis."""
    scale_h = float(base_image_resolution) / float(image_height)
    scale_w = float(base_image_resolution) / float(image_width)
    grid_h = np.arange(grid_height, dtype=np.float32) * scale_h
    grid_w = np.arange(grid_width, dtype=np.float32) * scale_w
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0).reshape([2, 1, grid_height, grid_width])
    emb_h = _get_1d_pos_embed(embed_dim // 2, grid[0])
    emb_w = _get_1d_pos_embed(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def rope_angles(positions: torch.Tensor, axes_dims: Tuple[int, int, int], axes_scales: Tuple[float, float, float],
                theta: float) -> Angles:
    """(B, S, 3) positions -> (cos, sin) of ``pos * scale * theta^(-2i/d)`` per axis, concatenated."""
    cos_parts, sin_parts = [], []
    for axis, (dim, scale) in enumerate(zip(axes_dims, axes_scales)):
        steps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device)
        base = 1.0 / (theta ** (steps / dim))
        angle = positions[..., axis].to(torch.float32)[..., None] * scale * base
        cos_parts.append(torch.cos(angle))
        sin_parts.append(torch.sin(angle))
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_rope(x: torch.Tensor, angles: Angles) -> torch.Tensor:
    """Rotate consecutive feature pairs of (B, S, H, D) ``x``, in f32."""
    cos, sin = angles
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x_f = x.to(torch.float32)
    x0, x1 = x_f[..., 0::2], x_f[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(x.shape).to(x.dtype)


class SwiGLUFFN(nn.Module):
    """``w3(silu_f32(x1) * x2)`` with ``(x1, x2) = chunk(w12 x)``."""

    def __init__(self, config: ZlabI1Config, **lora) -> None:
        super().__init__()
        self.dtype = lora["dtype"]
        self.w12 = LoRADense(config.hidden_size, 2 * config.ffn_inner, **lora)
        self.w3 = LoRADense(config.ffn_inner, config.hidden_size, **lora)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3((F.silu(x1.to(torch.float32)) * x2.to(torch.float32)).to(self.dtype))


class ConnectorAttention(nn.Module):
    """Unmasked self-attention with a fused qkv and per-head RMS q/k norms."""

    def __init__(self, config: ZlabI1Config, **lora) -> None:
        super().__init__()
        self.config = config
        dim, dtype = config.hidden_size, lora["dtype"]
        self.qkv = LoRADense(dim, 3 * dim, **lora)
        self.q_norm = RMSNorm(config.head_dim, eps=config.norm_eps, dtype=dtype)
        self.k_norm = RMSNorm(config.head_dim, eps=config.norm_eps, dtype=dtype)
        self.proj = LoRADense(dim, dim, **lora)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        batch, seq = x.shape[:2]
        q, k, v = self.qkv(x).reshape(batch, seq, 3, cfg.num_heads, cfg.head_dim).unbind(dim=2)
        out = dot_product_attention(self.q_norm(q), self.k_norm(k), v)
        return self.proj(out.reshape(batch, seq, cfg.hidden_size))


class TextAdapter(nn.Module):
    """Two residual attention + SwiGLU rounds over the caption, after the
    learnable null caption replaces the dropped ones."""

    def __init__(self, config: ZlabI1Config, **lora) -> None:
        super().__init__()
        dim, dtype = config.hidden_size, lora["dtype"]
        self.dtype = dtype
        self.null_caption = nn.Parameter(torch.empty(1, config.text_num_tokens, config.text_embed_dim,
                                                     dtype=torch.float32))
        self.connector_in = LoRADense(config.text_embed_dim, dim, **lora)
        for i in range(1, 5):
            self.add_module(f"connector_norm{i}", RMSNorm(dim, eps=config.norm_eps, dtype=dtype))
        self.connector_attn = ConnectorAttention(config, **lora)
        self.connector_mlp = SwiGLUFFN(config, **lora)
        self.connector_attn2 = ConnectorAttention(config, **lora)
        self.connector_mlp2 = SwiGLUFFN(config, **lora)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.null_caption.zero_()

    def forward(self, caption: torch.Tensor, dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if dropout_mask is not None:
            caption = torch.where(dropout_mask[:, None, None] > 0, self.null_caption.to(caption.dtype), caption)
        x = self.connector_in(caption.to(self.dtype))
        x = x + self.connector_attn(self.connector_norm1(x))
        x = x + self.connector_mlp(self.connector_norm2(x))
        x = x + self.connector_attn2(self.connector_norm3(x))
        return x + self.connector_mlp2(self.connector_norm4(x))


class I1Block(nn.Module):
    """One U-ViT block; ``use_skip`` gives an out block its skip linears."""

    def __init__(self, config: ZlabI1Config, use_skip: bool = False, dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.use_skip = config, use_skip
        dim = config.hidden_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        norm = dict(eps=config.norm_eps, dtype=dtype)
        if use_skip:
            self.skip_image = LoRADense(2 * dim, dim, **lora)
            self.skip_text = LoRADense(2 * dim, dim, **lora)
        self.norm1 = RMSNorm(dim, **norm)
        self.qkv_image = LoRADense(dim, 3 * dim, **lora)
        self.qkv_text = LoRADense(dim, 3 * dim, **lora)
        self.q_norm = RMSNorm(config.head_dim, **norm)
        self.k_norm = RMSNorm(config.head_dim, **norm)
        self.proj_image = LoRADense(dim, dim, **lora)
        self.proj_text = LoRADense(dim, dim, **lora)
        self.norm3 = RMSNorm(dim, **norm)
        self.norm2 = RMSNorm(dim, **norm)
        self.norm4 = RMSNorm(dim, **norm)
        self.mlp_image = SwiGLUFFN(config, **lora)
        self.mlp_text = SwiGLUFFN(config, **lora)

    def forward(self, image_tokens: torch.Tensor, text_tokens: torch.Tensor, image_angles: Angles,
                text_angles: Angles, text_mask: torch.Tensor, skip_image: Optional[torch.Tensor] = None,
                skip_text: Optional[torch.Tensor] = None):
        cfg = self.config
        batch, img_len = image_tokens.shape[:2]
        text_len = text_tokens.shape[1]
        if self.use_skip:
            image_tokens = self.skip_image(torch.cat([image_tokens, skip_image], dim=-1))
            text_tokens = self.skip_text(torch.cat([text_tokens, skip_text], dim=-1))

        def project(qkv: nn.Module, x: torch.Tensor):
            q, k, v = qkv(self.norm1(x)).reshape(batch, x.shape[1], 3, cfg.num_heads, cfg.head_dim).unbind(dim=2)
            return self.q_norm(q), self.k_norm(k), v

        q_i, k_i, v_i = project(self.qkv_image, image_tokens)
        q_t, k_t, v_t = project(self.qkv_text, text_tokens)
        q = torch.cat([apply_rope(q_i, image_angles), apply_rope(q_t, text_angles)], dim=1)
        k = torch.cat([apply_rope(k_i, image_angles), apply_rope(k_t, text_angles)], dim=1)
        v = torch.cat([v_i, v_t], dim=1)
        key_mask = torch.cat([torch.ones((batch, img_len), dtype=torch.int32, device=q.device),
                              text_mask.to(torch.int32)], dim=1)
        out = dot_product_attention(q, k, v, q_segment_ids=torch.ones_like(key_mask), kv_segment_ids=key_mask)
        out = out.reshape(batch, img_len + text_len, cfg.hidden_size) * key_mask[:, :, None].to(q.dtype)

        image_tokens = image_tokens + self.norm3(self.proj_image(out[:, :img_len]))
        text_tokens = text_tokens + self.norm3(self.proj_text(out[:, img_len:]))
        image_tokens = image_tokens + self.norm4(self.mlp_image(self.norm2(image_tokens)))
        text_tokens = text_tokens + self.norm4(self.mlp_text(self.norm2(text_tokens)))
        return image_tokens, text_tokens * text_mask[:, :, None].to(text_tokens.dtype)


class ZlabI1Transformer(nn.Module):
    """The Zlab-i1 DiT.  ``latents`` (B, H, W, C) noisy, ``timesteps`` taken
    and ignored, ``context`` (B, T, text_embed_dim), ``context_mask`` (B, T)
    with 1 on valid tokens (None: all valid), ``caption_dropout`` (B,) with 1
    where the null caption replaces the context; returns (B, H, W, C) f32."""

    def __init__(self, config: ZlabI1Config = ZlabI1Config(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim, p = config.hidden_size, config.patch_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        hw = config.input_size // p
        self.x_embedder = LoRADense(config.in_channels * p * p, dim, **lora)
        self.pos_embed = nn.Parameter(torch.empty(1, hw * hw, dim, dtype=torch.float32))
        self.text_adapter = TextAdapter(config, **lora)
        for i in range(config.num_in_blocks):
            self.add_module(f"in_{i}", I1Block(config, **lora))
        self.mid = I1Block(config, **lora)
        for i in range(config.num_in_blocks):
            self.add_module(f"out_{i}", I1Block(config, use_skip=True, **lora))
        self.final_norm = RMSNorm(dim, eps=config.norm_eps, dtype=dtype)
        self.final_linear = LoRADense(dim, p * p * config.in_channels, **lora)
        self._tables: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The native grid's sincos table, as the Flax initialiser."""
        cfg = self.config
        hw = cfg.input_size // cfg.patch_size
        table = sincos_pos_embed(cfg.hidden_size, hw, hw, cfg.image_resolution, cfg.image_resolution)
        self.pos_embed.copy_(torch.from_numpy(table).reshape(self.pos_embed.shape))

    def position_table(self, hh: int, ww: int, device: torch.device) -> torch.Tensor:
        """(1, hh * ww, dim) f32 for a grid other than the native one, made once
        per grid and device (before a captured step needs it)."""
        key = (hh, ww, device)
        if key not in self._tables:
            p = self.config.patch_size
            table = sincos_pos_embed(self.config.hidden_size, hh, ww, hh * p * 8, ww * p * 8)
            self._tables[key] = torch.from_numpy(table).reshape(1, hh * ww, -1).to(device)
        return self._tables[key]

    def _run(self, name: str, *args):
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, timesteps: Optional[torch.Tensor], context: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None,
                caption_dropout: Optional[torch.Tensor] = None) -> torch.Tensor:
        del timesteps  # the model is timestep-free
        cfg, dtype = self.config, self.dtype
        p = cfg.patch_size
        batch, height, width, channels = latents.shape
        hh, ww = height // p, width // p
        img_len, text_len = hh * ww, context.shape[1]
        device = latents.device
        if context_mask is None:
            context_mask = torch.ones((batch, text_len), dtype=torch.int32, device=device)
        context_mask = context_mask.to(torch.int32)

        x = latents.to(dtype).reshape(batch, hh, p, ww, p, channels).permute(0, 1, 3, 5, 2, 4)
        x = self.x_embedder(x.reshape(batch, img_len, channels * p * p))
        hw = cfg.input_size // p
        pos = self.pos_embed if hh == hw and ww == hw else self.position_table(hh, ww, device)
        x = x + pos.to(dtype)
        text_tokens = self.text_adapter(context, caption_dropout)

        # rope ids: text i at (i, 0, 0), masked at 0; the image at (valid text length, row, col)
        cap_pos0 = torch.where(context_mask > 0, torch.arange(text_len, device=device)[None], 0)
        zeros = torch.zeros_like(cap_pos0)
        rows = torch.arange(hh, device=device).repeat_interleave(ww)
        cols = torch.arange(ww, device=device).repeat(hh)
        img_positions = torch.stack([context_mask.sum(dim=1)[:, None].expand(batch, img_len),
                                     rows[None].expand(batch, img_len), cols[None].expand(batch, img_len)], dim=-1)
        scales = (1.0, 256.0 / float(hh * p * 8), 256.0 / float(ww * p * 8))
        text_angles = rope_angles(torch.stack([cap_pos0, zeros, zeros], dim=-1), cfg.axes_dims, scales,
                                  cfg.rope_theta)
        image_angles = rope_angles(img_positions, cfg.axes_dims, scales, cfg.rope_theta)

        skips = []
        image_tokens = x
        for i in range(cfg.num_in_blocks):
            image_tokens, text_tokens = self._run(f"in_{i}", image_tokens, text_tokens, image_angles, text_angles,
                                                  context_mask)
            skips.append((image_tokens, text_tokens))
        image_tokens, text_tokens = self._run("mid", image_tokens, text_tokens, image_angles, text_angles,
                                              context_mask)
        for i in range(cfg.num_in_blocks):
            skip_image, skip_text = skips.pop()  # LIFO: out block 0 pairs with the last in block
            image_tokens, text_tokens = self._run(f"out_{i}", image_tokens, text_tokens, image_angles, text_angles,
                                                  context_mask, skip_image, skip_text)

        out = self.final_linear(self.final_norm(image_tokens))
        out = out.reshape(batch, hh, ww, p, p, channels).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(batch, height, width, channels).to(torch.float32)
