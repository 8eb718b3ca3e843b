"""AutoencoderKL image VAE, the decoder half.

Counterpart of ``simpletuner_tpu/models/vae.py``: GroupNorm+SiLU resnet
blocks, a mid attention block, nearest x2 upsampling, and ``decode`` with the
config's scaling/shift.  Public functions keep the JAX NHWC layout; inside,
tensors are NCHW.  flax ``GroupNorm`` uses eps=1e-6 (torch defaults to 1e-5)
and computes its statistics in f32 whatever the compute dtype.  The encoder
is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

GROUP_NORM_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    channel_multipliers: Tuple[int, ...] = (1, 2, 4, 4)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0

    @classmethod
    def flux(cls) -> "VAEConfig":
        return cls(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159)

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(base_channels=16, channel_multipliers=(1, 2), layers_per_block=1)

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.channel_multipliers) - 1)


def _groups(channels: int) -> int:
    return 32 if channels % 32 == 0 else math.gcd(channels, 32) or 1


def _group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(_groups(channels), channels, eps=GROUP_NORM_EPS, dtype=torch.float32)


def _norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """f32 statistics and affine, result in x's dtype (flax GroupNorm with a low dtype)."""
    return F.group_norm(x.to(torch.float32), norm.num_groups, norm.weight, norm.bias, norm.eps).to(x.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.norm1 = _group_norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.norm2 = _group_norm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1, dtype=dtype) if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(_norm(self.norm1, x)))
        h = self.conv2(F.silu(_norm(self.norm2, h)))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h + residual


class AttnBlock(nn.Module):
    """Single-head self-attention over the h*w positions (plain softmax, as in JAX)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.norm = _group_norm(channels)
        self.to_q = nn.Linear(channels, channels, dtype=dtype)
        self.to_k = nn.Linear(channels, channels, dtype=dtype)
        self.to_v = nn.Linear(channels, channels, dtype=dtype)
        self.to_out = nn.Linear(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, channels, height, width = x.shape
        flat = _norm(self.norm, x).permute(0, 2, 3, 1).reshape(batch, height * width, channels)
        q, k, v = self.to_q(flat), self.to_k(flat), self.to_v(flat)
        attn = torch.softmax(q @ k.transpose(1, 2) * channels ** -0.5, dim=-1)
        out = self.to_out(attn @ v)
        return x + out.reshape(batch, height, width, channels).permute(0, 3, 1, 2)


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config = config
        channels = config.base_channels * config.channel_multipliers[-1]
        self.conv_in = nn.Conv2d(config.latent_channels, channels, 3, padding=1, dtype=dtype)
        self.mid_block_1 = ResnetBlock(channels, channels, dtype)
        self.mid_attn = AttnBlock(channels, dtype)
        self.mid_block_2 = ResnetBlock(channels, channels, dtype)
        levels = list(reversed(config.channel_multipliers))
        for level, mult in enumerate(levels):
            out = config.base_channels * mult
            for block in range(config.layers_per_block + 1):
                self.add_module(f"up_{level}_block_{block}", ResnetBlock(channels, out, dtype))
                channels = out
            if level < len(levels) - 1:
                self.add_module(f"up_{level}_upsample", nn.Conv2d(channels, channels, 3, padding=1, dtype=dtype))
        self.norm_out = _group_norm(channels)
        self.conv_out = nn.Conv2d(channels, config.in_channels, 3, padding=1, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h = self.conv_in(z.to(self.conv_in.weight.dtype))
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        levels = len(cfg.channel_multipliers)
        for level in range(levels):
            for block in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{level}_block_{block}")(h)
            if level < levels - 1:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{level}_upsample")(h)
        return self.conv_out(F.silu(_norm(self.norm_out, h)))


class AutoencoderKL(nn.Module):
    """Decoder-only AutoencoderKL: ``post_quant_conv`` then :class:`Decoder`."""

    def __init__(self, config: VAEConfig = VAEConfig(), dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config = config
        self.decoder = Decoder(config, dtype)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1, dtype=dtype)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, h, w, C) -> image (B, H, W, 3), nominally in [-1, 1]."""
        latents = latents / self.config.scaling_factor + self.config.shift_factor
        z = latents.permute(0, 3, 1, 2).to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)
