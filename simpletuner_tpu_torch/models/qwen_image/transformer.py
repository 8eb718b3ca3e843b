"""Qwen-Image MMDiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/qwen_image/transformer.py`` (the
``QwenImageTransformer2DModel``): ``img_in`` over 2x2-packed latent tokens;
the raw Qwen2.5-VL features through an RMSNorm (``txt_norm``) and
``txt_in``; the timestep (sigma x 1000) through a 256-dim sinusoid and
``time_in``; ``depth`` double-stream blocks (per-stream SiLU modulation
linears ``img_mod`` / ``txt_mod`` of 6 x dim each, parameter-free
LayerNorms, per-head RMS q / k norms, Qwen's centred axial rope on
interleaved pairs, one joint attention with the text tokens first,
tanh-gelu MLPs) and the scale-first AdaLayerNormContinuous head
(``final_mod`` / ``final_proj``).  Submodules keep the JAX names
(``block_{i}.img_attn_q``), so the bridge maps a Flax tree by name.

Mirrored as the JAX module computes it: the rope tables (image h / w
coordinates from ``-(n - n // 2)``, one frame at coordinate 0, text
positions from ``max(hh // 2, ww // 2)`` on all three axes) are made in
float64 on the host and rounded to f32, once per grid, text length and
device; the rotation runs in f32.  MageFlow and Z-Image ride this DiT with
``txt_rope=False``: their text tokens are not rotated.  The grid comes in as
ints ``(hh, ww)`` where the JAX module reads the shape of a zeros array.
Remat (``gradient_checkpointing``) checkpoints every block whole, as
``nn.remat`` wraps ``QwenImageBlock``.  The JAX module's per-block
``intermediates`` tap (CREPA) is not ported (ROADMAP Queue 1 item 4h).
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


@dataclasses.dataclass(frozen=True)
class QwenImageConfig:
    in_channels: int = 64  # 2x2-packed 16-channel latents
    hidden_size: int = 3072
    num_heads: int = 24
    head_dim: int = 128
    mlp_ratio: float = 4.0
    depth: int = 60
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: float = 10000.0
    txt_in_features: int = 3584  # Qwen2.5-VL hidden
    # MageFlow / Z-Image ride this block layout but do not rotate the text tokens
    txt_rope: bool = True

    @classmethod
    def tiny(cls) -> "QwenImageConfig":
        return cls(in_channels=16, hidden_size=64, num_heads=2, head_dim=32, depth=2, axes_dim=(8, 12, 12),
                   txt_in_features=32)


def qwen_rope_angles(cfg: QwenImageConfig, hh: int, ww: int, txt_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token rotation angles, (hh * ww, head_dim / 2) for the image and
    (txt_len, head_dim / 2) for the text, float64 rounded to f32."""

    def axis_angles(coords: np.ndarray, dim: int) -> np.ndarray:
        inv = 1.0 / (cfg.theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        return np.outer(coords, inv)

    f_dim, h_dim, w_dim = cfg.axes_dim
    a_f = axis_angles(np.zeros(1), f_dim)  # one frame at coordinate 0
    a_h = axis_angles(np.arange(hh, dtype=np.float64) - (hh - hh // 2), h_dim)
    a_w = axis_angles(np.arange(ww, dtype=np.float64) - (ww - ww // 2), w_dim)
    img = np.concatenate([np.broadcast_to(a_f[0][None, None], (hh, ww, f_dim // 2)),
                          np.broadcast_to(a_h[:, None, :], (hh, ww, h_dim // 2)),
                          np.broadcast_to(a_w[None, :, :], (hh, ww, w_dim // 2))], axis=-1).reshape(hh * ww, -1)
    t_coords = max(hh // 2, ww // 2) + np.arange(txt_len, dtype=np.float64)
    txt = np.concatenate([axis_angles(t_coords, f_dim), axis_angles(t_coords, h_dim), axis_angles(t_coords, w_dim)],
                         axis=-1)
    return img.astype(np.float32), txt.astype(np.float32)


def apply_interleaved_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved (even, odd) pairs of (B, S, H, D) ``x`` by (S, D / 2) ``angles``, in f32."""
    xf = x.to(torch.float32)
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape).to(x.dtype)


class QwenImageBlock(nn.Module):
    """A double-stream block: (B, S_img, dim) image and (B, S_txt, dim) text
    tokens, ``temb`` (B, dim), the rope angles of each stream and the joint
    sequence's segment ids (None: unmasked)."""

    def __init__(self, config: QwenImageConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, inner = config.hidden_size, config.num_heads * config.head_dim
        mlp = int(dim * config.mlp_ratio)
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.img_mod = LoRADense(dim, 6 * dim, dtype=dtype)
        self.txt_mod = LoRADense(dim, 6 * dim, dtype=dtype)
        for stream in ("img", "txt"):
            for name in ("q", "k", "v"):
                self.add_module(f"{stream}_attn_{name}", LoRADense(dim, inner, **lora))
            self.add_module(f"{stream}_attn_norm_q", RMSNorm(config.head_dim, dtype=dtype))
            self.add_module(f"{stream}_attn_norm_k", RMSNorm(config.head_dim, dtype=dtype))
            self.add_module(f"{stream}_attn_proj", LoRADense(inner, dim, **lora))
            self.add_module(f"{stream}_mlp_in", LoRADense(dim, mlp, **lora))
            self.add_module(f"{stream}_mlp_out", LoRADense(mlp, dim, **lora))

    def _qkv(self, stream: str, x: torch.Tensor):
        cfg = self.config
        shape = (x.shape[0], x.shape[1], cfg.num_heads, cfg.head_dim)
        q = getattr(self, f"{stream}_attn_norm_q")(getattr(self, f"{stream}_attn_q")(x).reshape(shape))
        k = getattr(self, f"{stream}_attn_norm_k")(getattr(self, f"{stream}_attn_k")(x).reshape(shape))
        return q, k, getattr(self, f"{stream}_attn_v")(x).reshape(shape)

    def forward(self, img: torch.Tensor, txt: torch.Tensor, temb: torch.Tensor, rope_img: torch.Tensor,
                rope_txt: torch.Tensor, segment_ids: Optional[torch.Tensor] = None):
        dtype = self.dtype
        batch, txt_len = img.shape[0], txt.shape[1]
        silu_t = F.silu(temb.to(torch.float32)).to(dtype)
        i_mods = [m[:, None] for m in self.img_mod(silu_t).chunk(6, dim=-1)]
        t_mods = [m[:, None] for m in self.txt_mod(silu_t).chunk(6, dim=-1)]

        iq, ik, iv = self._qkv("img", layer_norm(img, dtype) * (1 + i_mods[1]) + i_mods[0])
        tq, tk, tv = self._qkv("txt", layer_norm(txt, dtype) * (1 + t_mods[1]) + t_mods[0])
        iq, ik = apply_interleaved_rope(iq, rope_img), apply_interleaved_rope(ik, rope_img)
        if self.config.txt_rope:
            tq, tk = apply_interleaved_rope(tq, rope_txt), apply_interleaved_rope(tk, rope_txt)
        # text tokens first, then the image tokens
        attn = dot_product_attention(torch.cat([tq, iq], dim=1), torch.cat([tk, ik], dim=1),
                                     torch.cat([tv, iv], dim=1), q_segment_ids=segment_ids,
                                     kv_segment_ids=segment_ids).reshape(batch, -1, tq.shape[2] * tq.shape[3])
        img = img + i_mods[2] * self.img_attn_proj(attn[:, txt_len:])
        txt = txt + t_mods[2] * self.txt_attn_proj(attn[:, :txt_len])

        h = self.img_mlp_in(layer_norm(img, dtype) * (1 + i_mods[4]) + i_mods[3])
        img = img + i_mods[5] * self.img_mlp_out(F.gelu(h, approximate="tanh"))
        h = self.txt_mlp_in(layer_norm(txt, dtype) * (1 + t_mods[4]) + t_mods[3])
        txt = txt + t_mods[5] * self.txt_mlp_out(F.gelu(h, approximate="tanh"))
        return img, txt


class QwenImageTransformer(nn.Module):
    """The Qwen-Image DiT.  ``img`` (B, hh * ww, in_channels) packed latent
    tokens on the ``(hh, ww)`` token grid, ``txt`` (B, S_txt,
    txt_in_features), ``timesteps`` (B,) sigma in [0, 1], ``segment_ids``
    (B, S_txt + S_img) or None; returns (B, hh * ww, in_channels) in f32."""

    def __init__(self, config: QwenImageConfig = QwenImageConfig(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim = config.hidden_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.img_in = LoRADense(config.in_channels, dim, **lora)
        self.txt_norm = RMSNorm(config.txt_in_features, dtype=dtype)
        self.txt_in = LoRADense(config.txt_in_features, dim, **lora)
        self.time_in = MLPEmbedder(256, dim, dtype=dtype)
        for layer in range(config.depth):
            self.add_module(f"block_{layer}", QwenImageBlock(config, **lora))
        self.final_mod = LoRADense(dim, 2 * dim, dtype=dtype)
        self.final_proj = LoRADense(dim, config.in_channels, dtype=dtype)
        self._rope: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(self, hh: int, ww: int, txt_len: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (image, text) angle tables on ``device``, made once per grid and
        text length (before a captured step needs them)."""
        key = (hh, ww, txt_len, device)
        if key not in self._rope:
            self._rope[key] = tuple(torch.from_numpy(a).to(device)
                                    for a in qwen_rope_angles(self.config, hh, ww, txt_len))
        return self._rope[key]

    def _run(self, layer: int, *args):
        block = getattr(self, f"block_{layer}")
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, img: torch.Tensor, img_hw: Tuple[int, int], txt: torch.Tensor, timesteps: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        hh, ww = img_hw
        x = self.img_in(img)
        t = self.txt_in(self.txt_norm(txt))
        temb = self.time_in(timestep_embedding(timesteps, 256).to(dtype))
        rope_img, rope_txt = self.rope(hh, ww, txt.shape[1], img.device)
        for layer in range(cfg.depth):
            x, t = self._run(layer, x, t, temb, rope_img, rope_txt, segment_ids)

        # AdaLayerNormContinuous: (scale, shift), scale first
        scale, shift = self.final_mod(F.silu(temb.to(torch.float32)).to(dtype)).chunk(2, dim=-1)
        x = layer_norm(x, dtype) * (1 + scale[:, None]) + shift[:, None]
        return self.final_proj(x).to(torch.float32)
