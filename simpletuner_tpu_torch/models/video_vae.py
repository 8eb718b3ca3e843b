"""Causal 3-D video VAE (Wan/LTX style: 4x temporal, 8x spatial compression).

Counterpart of ``simpletuner_tpu/models/video_vae.py``: ``VideoVAEConfig``
(``wan``, ``tiny``), ``CausalConv3D`` (the front of the time axis padded by
repeating the first frame ``kt - 1`` times, H and W zero-padded by half the
kernel), ``ResBlock3D`` (f32 GroupNorm with 8 groups, or 1 when the channels
are not a multiple of 8, then SiLU and a causal conv, twice; a 1x1x1
``shortcut`` when the width changes), ``VideoEncoder``, ``VideoDecoder``
(temporal upsample ``repeat(2)[:, 1:]``, so 21 latent frames decode to 81;
spatial nearest x2) and ``VideoAutoencoderKL`` (``encode_moments``,
``encode``, ``decode``).  Submodules keep the Flax names (``stem.conv``,
``down_1_res_0.GroupNorm_0``, ``up_2_upconv.conv``), so the weight bridge
maps a Flax tree by name.

The interface keeps the JAX layout, (B, T, H, W, C) for frames and latents,
so caches written by one package read in the other; inside, tensors are
(B, C, T, H, W).  Compute runs in ``dtype`` (bf16 by default, as the JAX
module), norms in f32 with flax's ``epsilon`` 1e-6 and its variance
E[x^2] - E[x]^2.  At 81 x 480 x 832 frames the first level's activation
holds 3.1e9 elements, more than a 32-bit index reaches: the norms work one
run of frames at a time (no f32 copy of the whole activation), and every
convolution is split along its output frames so that no call reads or
writes more than ``CONV_CHUNK_ELEMENTS`` elements.  Both splits are exact:
a frame's output depends on the same inputs either way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

GROUP_NORM_EPS = 1e-6  # flax GroupNorm's epsilon
# the most elements one convolution call reads or writes, and one norm chunk holds
CONV_CHUNK_ELEMENTS = 2 ** 30
NORM_CHUNK_ELEMENTS = 2 ** 28


@dataclasses.dataclass(frozen=True)
class VideoVAEConfig:
    latent_channels: int = 16
    base_channels: int = 96
    channel_multipliers: Tuple[int, ...] = (1, 2, 4, 4)
    temporal_downsample: Tuple[bool, ...] = (False, True, True, False)  # 4x total
    num_res_blocks: int = 2

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.channel_multipliers) - 1)

    @property
    def temporal_factor(self) -> int:
        return 2 ** sum(self.temporal_downsample)

    @classmethod
    def wan(cls) -> "VideoVAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VideoVAEConfig":
        return cls(latent_channels=4, base_channels=8, channel_multipliers=(1, 2),
                   temporal_downsample=(True, True), num_res_blocks=1)


def _groups(channels: int) -> int:
    return 8 if channels % 8 == 0 else 1


def _group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(_groups(channels), channels, eps=GROUP_NORM_EPS, dtype=torch.float32)


def norm_silu(norm: nn.GroupNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``silu(GroupNorm(x))`` in f32, returned in ``dtype``: flax's GroupNorm
    on ``x.astype(f32)`` (mean and E[x^2] - mean^2 per sample and group), a
    run of frames at a time.  ``x`` is (B, C, T, H, W)."""
    batch, channels, frames = x.shape[:3]
    groups = norm.num_groups
    step = max(1, NORM_CHUNK_ELEMENTS // max(1, x[:, :, :1].numel()))
    total = torch.zeros((batch, groups), dtype=torch.float32, device=x.device)
    squares = torch.zeros_like(total)
    for start in range(0, frames, step):
        part = x[:, :, start:start + step].to(torch.float32).reshape(batch, groups, -1)
        total += part.sum(dim=-1)
        squares += part.square().sum(dim=-1)
    count = x[0].numel() // groups
    mean = total / count
    var = torch.clamp(squares / count - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + norm.eps)
    weight = norm.weight.to(torch.float32).reshape(1, groups, channels // groups, 1, 1, 1)
    bias = norm.bias.to(torch.float32).reshape(1, groups, channels // groups, 1, 1, 1)
    mean, rstd = mean.reshape(batch, groups, 1, 1, 1, 1), rstd.reshape(batch, groups, 1, 1, 1, 1)
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    for start in range(0, frames, step):
        part = x[:, :, start:start + step].to(torch.float32)
        grouped = part.reshape(batch, groups, channels // groups, *part.shape[2:])
        y = (grouped - mean) * (rstd * weight) + bias
        out[:, :, start:start + step] = F.silu(y).reshape(part.shape).to(dtype)
        del part, grouped, y
    return out


def conv3d(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` for an unpadded time axis, split along the output frames
    so that no call reads or writes more than ``CONV_CHUNK_ELEMENTS``."""
    kt, st = conv.kernel_size[0], conv.stride[0]
    frames_out = (x.shape[2] - kt) // st + 1
    sizes = [(n + 2 * p - k) // s + 1 for n, p, k, s in
             zip(x.shape[3:], conv.padding[1:], conv.kernel_size[1:], conv.stride[1:])]
    per_out = x.shape[0] * conv.out_channels * sizes[0] * sizes[1]
    per_in = x[:, :, :1].numel()
    step = max(1, CONV_CHUNK_ELEMENTS // max(per_out, per_in * max(st, kt)))
    if step >= frames_out:
        return conv(x)
    out = torch.empty((x.shape[0], conv.out_channels, frames_out, *sizes), dtype=x.dtype, device=x.device)
    for start in range(0, frames_out, step):
        stop = min(frames_out, start + step)
        out[:, :, start:stop] = conv(x[:, :, start * st:(stop - 1) * st + kt])
    return out


class CausalConv3D(nn.Module):
    """3-D conv with causal (replicate-front) temporal padding: the first
    frame repeated ``kt - 1`` times before the clip; H and W zero-padded by
    ``k // 2`` on each side."""

    def __init__(self, in_features: int, features: int, kernel: Tuple[int, int, int] = (3, 3, 3),
                 strides: Tuple[int, int, int] = (1, 1, 1), dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        kt, kh, kw = kernel
        self.pad_t = kt - 1
        self.conv = nn.Conv3d(in_features, features, kernel, stride=strides, padding=(0, kh // 2, kw // 2),
                              dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, T, H, W)
        if self.pad_t:
            x = torch.cat([x[:, :, :1].expand(-1, -1, self.pad_t, -1, -1), x], dim=2)
        return conv3d(self.conv, x)


class ResBlock3D(nn.Module):
    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dtype = dtype
        self.GroupNorm_0 = _group_norm(in_features)
        self.conv1 = CausalConv3D(in_features, features, dtype=dtype)
        self.GroupNorm_1 = _group_norm(features)
        self.conv2 = CausalConv3D(features, features, dtype=dtype)
        self.shortcut = nn.Conv3d(in_features, features, 1, dtype=dtype) if in_features != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(norm_silu(self.GroupNorm_0, x, self.dtype))
        h = self.conv2(norm_silu(self.GroupNorm_1, h, self.dtype))
        residual = x if self.shortcut is None else conv3d(self.shortcut, x)
        return residual + h


class VideoEncoder(nn.Module):
    def __init__(self, config: VideoVAEConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        channels = config.base_channels
        self.stem = CausalConv3D(3, channels, dtype=dtype)
        levels = len(config.channel_multipliers)
        for level, mult in enumerate(config.channel_multipliers):
            features = config.base_channels * mult
            for i in range(config.num_res_blocks):
                self.add_module(f"down_{level}_res_{i}", ResBlock3D(channels, features, dtype))
                channels = features
            st = 2 if config.temporal_downsample[level] else 1
            if level < levels - 1:
                self.add_module(f"down_{level}_pool", CausalConv3D(features, features, strides=(st, 2, 2), dtype=dtype))
            elif st == 2:
                self.add_module(f"down_{level}_pool", CausalConv3D(features, features, strides=(2, 1, 1), dtype=dtype))
        self.norm_out = _group_norm(channels)
        self.proj = CausalConv3D(channels, config.latent_channels * 2, kernel=(1, 1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, 3, T, H, W)
        cfg = self.config
        h = self.stem(x.to(self.dtype))
        for level in range(len(cfg.channel_multipliers)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_res_{i}")(h)
            pool = getattr(self, f"down_{level}_pool", None)
            if pool is not None:
                h = pool(h)
        return self.proj(norm_silu(self.norm_out, h, self.dtype))


class VideoDecoder(nn.Module):
    def __init__(self, config: VideoVAEConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        mults = list(reversed(config.channel_multipliers))
        tdown = list(reversed(config.temporal_downsample))
        channels = config.base_channels * mults[0]
        self.stem = CausalConv3D(config.latent_channels, channels, dtype=dtype)
        for level, mult in enumerate(mults):
            features = config.base_channels * mult
            for i in range(config.num_res_blocks):
                self.add_module(f"up_{level}_res_{i}", ResBlock3D(channels, features, dtype))
                channels = features
            if tdown[level] or level < len(mults) - 1:
                self.add_module(f"up_{level}_upconv", CausalConv3D(features, features, dtype=dtype))
        self.norm_out = _group_norm(channels)
        self.proj = CausalConv3D(channels, 3, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:  # (B, C, T', H', W')
        cfg = self.config
        mults = list(reversed(cfg.channel_multipliers))
        tdown = list(reversed(cfg.temporal_downsample))
        h = self.stem(z.to(self.dtype))
        for level in range(len(mults)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"up_{level}_res_{i}")(h)
            if tdown[level]:  # mirror of the encoder's temporal stride: causal, drop the lead duplicate
                h = torch.repeat_interleave(h, 2, dim=2)[:, :, 1:]
            if level < len(mults) - 1:  # mirror of its spatial stride: nearest x2
                h = torch.repeat_interleave(torch.repeat_interleave(h, 2, dim=3), 2, dim=4)
            upconv = getattr(self, f"up_{level}_upconv", None)
            if upconv is not None:
                h = upconv(h)
        return self.proj(norm_silu(self.norm_out, h, self.dtype)).to(torch.float32)


class VideoAutoencoderKL(nn.Module):
    """The encoder and the decoder; frames and latents (B, T, H, W, C)."""

    def __init__(self, config: VideoVAEConfig = VideoVAEConfig(), dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        self.encoder = VideoEncoder(config, dtype)
        self.decoder = VideoDecoder(config, dtype)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """Frames (B, T, H, W, 3) in [-1, 1] -> moments (B, T', H', W', 2C)
        (mean, then logvar), in the compute dtype."""
        return self.encoder(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               sample: bool = True) -> torch.Tensor:
        """The mean latents (B, T', H', W', C), or with ``generator`` (and
        ``sample``) a draw mean + std * N(0, 1), logvar clipped to [-30, 20];
        no scaling (the JAX module applies none)."""
        mean, logvar = self.encode_moments(x).chunk(2, dim=-1)
        if sample and generator is not None:
            std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
            return mean + std * torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
        return mean

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents (B, T', H', W', C) -> f32 frames (B, T, H, W, 3)."""
        return self.decoder(z.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decode(self.encode(x, generator))
