"""1-D waveform autoencoder for audio latents (ACE-Step).

Counterpart of ``simpletuner_tpu/models/audio_vae.py``: ``AudioVAEConfig``
(``ace()`` the stereo 44.1 kHz codec of strides (4, 4, 4, 8), 512x, and
``tiny()``), ``ResBlock1D`` (silu, the k = 7 conv, silu, the 1 x 1 conv, a 1 x 1
shortcut where the width changes), ``AudioEncoder`` (the stem, a residual
block and a strided conv of kernel 2 x stride per level (``_strided``: one
product over the unfolded windows for a bf16 input on the CPU, whose
``conv1d`` is wrong there), the widths doubling
to 16 x base, the middle block, the mean / log-variance projection),
``AudioDecoder`` (each level repeats every sample ``stride`` times, then an
odd-kernel conv of padding ``stride`` keeps the length exactly stride x) and
``AudioAutoencoderKL``.  It keeps the JAX (B, S, C) interface and runs every
``conv1d`` in NCL inside (one transpose in and one out); convolutions
compute in ``dtype`` (bf16 by default, as the Flax module), the SiLUs in
f32, and the decoder returns f32.  ``encode(sample=True)`` draws from the
caller's generator, the log-variance clipped to [-30, 20]; without a
generator it returns the mean, as the JAX module does without a key.
Submodules keep the JAX names (``encoder.down_0_res.conv1``), so a Flax tree
maps onto the state dict by name (``weight_bridge``: a 1-D conv kernel (k,
in, out) becomes (out, in, k)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class AudioVAEConfig:
    latent_channels: int = 8
    base_channels: int = 64
    strides: Tuple[int, ...] = (4, 4, 4, 8)  # 512x total compression
    in_channels: int = 2  # stereo

    @property
    def compression(self) -> int:
        out = 1
        for s in self.strides:
            out *= s
        return out

    @classmethod
    def ace(cls) -> "AudioVAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "AudioVAEConfig":
        return cls(latent_channels=4, base_channels=8, strides=(4, 4), in_channels=1)


def _conv(in_ch: int, out_ch: int, kernel: int, dtype: torch.dtype, stride: int = 1, padding: int = 0) -> nn.Conv1d:
    return nn.Conv1d(in_ch, out_ch, kernel, stride=stride, padding=padding, dtype=dtype)


def unfolded_conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (its kernel, stride and padding) over (B, C, L) as one product
    over the unfolded windows (the operands in ``x``'s dtype, f32 accumulation)."""
    pad = conv.padding[0]
    windows = F.pad(x, (pad, pad)).unfold(2, conv.kernel_size[0], conv.stride[0])  # (B, C, L', k)
    return torch.einsum("bclk,ock->bol", windows, conv.weight) + conv.bias[None, :, None]


def _strided(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A strided even-kernel ``conv`` over (B, C, L): torch's CPU ``conv1d``
    gives wrong values in bf16 at some of these shapes (8 -> 16 and 16 -> 32
    channels at kernel 8, stride 4), so a bf16 input on the CPU goes through
    ``unfolded_conv``; every other input through ``conv`` itself."""
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        return unfolded_conv(conv, x)
    return conv(x)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(torch.float32)).to(x.dtype)


class ResBlock1D(nn.Module):
    """x + conv2(silu(conv1(silu(x)))) over (B, C, L), the residual through a
    1 x 1 ``shortcut`` where ``in_features`` differs from ``features``."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.conv1 = _conv(in_features, features, 7, dtype, padding=3)
        self.conv2 = _conv(features, features, 1, dtype)
        self.shortcut = _conv(in_features, features, 1, dtype) if in_features != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(_silu(self.conv1(_silu(x))))
        residual = x if self.shortcut is None else self.shortcut(x)
        return residual + h


class AudioEncoder(nn.Module):
    def __init__(self, config: AudioVAEConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        features = config.base_channels
        self.stem = _conv(config.in_channels, features, 7, dtype, padding=3)
        for level, stride in enumerate(config.strides):
            self.add_module(f"down_{level}_res", ResBlock1D(features, features, dtype))
            out = min(features * 2, config.base_channels * 16)
            self.add_module(f"down_{level}_pool", _conv(features, out, 2 * stride, dtype, stride, stride // 2))
            features = out
        self.mid_res = ResBlock1D(features, features, dtype)
        self.proj = _conv(features, config.latent_channels * 2, 3, dtype, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, L) samples in ``dtype`` -> (B, 2 x latent, L') moments."""
        h = self.stem(x)
        for level in range(len(self.config.strides)):
            h = _strided(getattr(self, f"down_{level}_pool"), getattr(self, f"down_{level}_res")(h))
        return self.proj(self.mid_res(h))


class AudioDecoder(nn.Module):
    def __init__(self, config: AudioVAEConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        features = min(config.base_channels * 2 ** len(config.strides), config.base_channels * 16)
        self.stem = _conv(config.latent_channels, features, 3, dtype, padding=1)
        for level, stride in enumerate(reversed(config.strides)):
            self.add_module(f"up_{level}_res", ResBlock1D(features, features, dtype))
            out = max(features // 2, config.base_channels)
            # odd kernel + symmetric padding keeps the length exactly stride x
            self.add_module(f"up_{level}_conv", _conv(features, out, 2 * stride + 1, dtype, padding=stride))
            features = out
        self.final_res = ResBlock1D(features, features, dtype)
        self.proj = _conv(features, config.in_channels, 7, dtype, padding=3)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, latent, L') in ``dtype`` -> (B, C, L) samples in ``dtype``."""
        h = self.stem(z)
        for level, stride in enumerate(reversed(self.config.strides)):
            h = getattr(self, f"up_{level}_res")(h).repeat_interleave(stride, dim=2)
            h = getattr(self, f"up_{level}_conv")(h)
        return self.proj(self.final_res(h))


class AudioAutoencoderKL(nn.Module):
    """Waveforms (B, S, C) <-> latents (B, S / compression, latent_channels)."""

    def __init__(self, config: AudioVAEConfig = AudioVAEConfig(), dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        self.encoder = AudioEncoder(config, dtype)
        self.decoder = AudioDecoder(config, dtype)

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               sample: bool = True) -> torch.Tensor:
        """The posterior's mean, or with ``generator`` (and ``sample``) a draw
        from it; (B, S', latent_channels) in ``dtype``."""
        if x.shape[-1] != self.config.in_channels:
            raise ValueError(f"the audio VAE takes {self.config.in_channels}-channel waveforms (B, S, "
                             f"{self.config.in_channels}); got {tuple(x.shape)}")
        moments = self.encoder(x.to(self.dtype).transpose(1, 2)).transpose(1, 2)
        mean, logvar = moments.chunk(2, dim=-1)
        if sample and generator is not None:
            std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
            return mean + std * torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
        return mean

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, S', latent_channels) -> (B, S, in_channels) f32 samples."""
        return self.decoder(z.to(self.dtype).transpose(1, 2)).transpose(1, 2).to(torch.float32)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decode(self.encode(x, generator))
