"""LTX-2 latent upsampler in PyTorch.

Counterpart of ``simpletuner_tpu/models/ltxvideo2/latent_upsampler.py``
(``LTX2LatentUpsampler``), the second stage of the spatial-upscale
validation render: an initial 3-D conv, GroupNorm(32) and SiLU,
``num_blocks_per_stage`` res blocks (conv, GN, SiLU, conv, GN, the SiLU
after the residual add), the upsampling head, as many res blocks again and a
final 3-D conv back to ``in_channels``.  The heads: spatial (a per-frame 2-D
conv to 4 x mid and a 2 x pixel shuffle), spatiotemporal (a 3-D conv to 8 x
mid and a (2, 2, 2) shuffle), temporal (a 3-D conv to 2 x mid, a frame
shuffle and the first frame cropped) and rational (a 2-D conv to num^2 x
mid, a num shuffle and a depthwise 5 x 5 binomial blur at stride den, for the
scales 0.75, 1.5, 2 and 4).  Only ``dims=3`` checkpoints (the shipped
configuration) are read, as in the JAX module.

The interface is channels-last, (B, F, H, W, C), as the JAX module's; the
convolutions run in torch's channels-first layout.  Submodules keep the JAX
names (a GroupNorm sits under ``norm`` of its ``_GN``), so a Flax tree maps
onto the module through the weight bridge.  The module computes in f32, the
JAX module's dtype.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_RATIONAL_SCALES = {0.75: (3, 4), 1.5: (3, 2), 2.0: (2, 1), 4.0: (4, 1)}


@dataclasses.dataclass(frozen=True)
class LTX2UpsamplerConfig:
    in_channels: int = 128
    mid_channels: int = 512
    num_blocks_per_stage: int = 4
    spatial_upsample: bool = True
    temporal_upsample: bool = False
    spatial_scale: float = 2.0
    rational_resampler: bool = False

    @classmethod
    def tiny(cls) -> "LTX2UpsamplerConfig":
        return cls(in_channels=4, mid_channels=32, num_blocks_per_stage=1)


def _pixel_shuffle_2d(x: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """(N, H, W, c p1 p2) -> (N, H p1, W p2, c), the channels split [c, p1, p2]."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, c // (p1 * p2), p1, p2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * p1, w * p2, c // (p1 * p2))


def _pixel_shuffle_3d(x: torch.Tensor, p: Tuple[int, int, int]) -> torch.Tensor:
    """(B, F, H, W, c p1 p2 p3) -> (B, F p1, H p2, W p3, c)."""
    b, f, h, w, c = x.shape
    p1, p2, p3 = p
    cp = c // (p1 * p2 * p3)
    x = x.reshape(b, f, h, w, cp, p1, p2, p3).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, f * p1, h * p2, w * p3, cp)


def _binomial_kernel(size: int) -> np.ndarray:
    k = np.array([math.comb(size - 1, i) for i in range(size)], np.float64)
    k2 = np.outer(k, k)
    return (k2 / k2.sum()).astype(np.float32)


def _blur_downsample(x: torch.Tensor, stride: int, size: int = 5) -> torch.Tensor:
    """Depthwise binomial blur at ``stride`` over channels-last (N, H, W, C)."""
    if stride == 1:
        return x
    c = x.shape[-1]
    kernel = torch.from_numpy(_binomial_kernel(size)).to(device=x.device, dtype=x.dtype)
    out = F.conv2d(x.permute(0, 3, 1, 2), kernel[None, None].expand(c, 1, size, size), stride=stride,
                   padding=size // 2, groups=c)
    return out.permute(0, 2, 3, 1)


def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A torch conv over channels-last ``x`` ((B, F, H, W, C) or (N, H, W, C))."""
    last = x.dim() - 1
    return conv(x.movedim(last, 1)).movedim(1, last)


class _GN(nn.Module):
    """GroupNorm(min(32, features), eps 1e-5) in f32 over channels-last input."""

    def __init__(self, features: int) -> None:
        super().__init__()
        self.norm = nn.GroupNorm(min(32, features), features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(self.norm, x.to(torch.float32)).to(x.dtype)


class UpsamplerResBlock(nn.Module):
    """conv, GN, SiLU, conv, GN, then SiLU of the residual sum."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv1 = nn.Conv3d(channels, channels, 3, padding=1)
        self.norm1 = _GN(channels)
        self.conv2 = nn.Conv3d(channels, channels, 3, padding=1)
        self.norm2 = _GN(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.norm1(_conv(self.conv1, x)))
        return F.silu(self.norm2(_conv(self.conv2, h)) + x)


class LTX2LatentUpsampler(nn.Module):
    """(B, F, H, W, in_channels) latents -> the upsampled latents."""

    def __init__(self, config: LTX2UpsamplerConfig = LTX2UpsamplerConfig()) -> None:
        super().__init__()
        self.config = config
        mid = config.mid_channels
        if not (config.spatial_upsample or config.temporal_upsample):
            raise ValueError("either spatial_upsample or temporal_upsample must be set")
        self.initial_conv = nn.Conv3d(config.in_channels, mid, 3, padding=1)
        self.initial_norm = _GN(mid)
        for i in range(config.num_blocks_per_stage):
            self.add_module(f"res_{i}", UpsamplerResBlock(mid))
        if config.spatial_upsample and config.temporal_upsample:
            self.up_conv = nn.Conv3d(mid, 8 * mid, 3, padding=1)
        elif config.spatial_upsample:
            factor = _RATIONAL_SCALES[float(config.spatial_scale)][0] ** 2 if config.rational_resampler else 4
            self.up_conv = nn.Conv2d(mid, factor * mid, 3, padding=1)
        else:
            self.up_conv = nn.Conv3d(mid, 2 * mid, 3, padding=1)
        for i in range(config.num_blocks_per_stage):
            self.add_module(f"post_res_{i}", UpsamplerResBlock(mid))
        self.final_conv = nn.Conv3d(mid, config.in_channels, 3, padding=1)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, f = latents.shape[:2]
        x = F.silu(self.initial_norm(_conv(self.initial_conv, latents)))
        for i in range(cfg.num_blocks_per_stage):
            x = getattr(self, f"res_{i}")(x)
        if cfg.spatial_upsample and cfg.temporal_upsample:
            x = _pixel_shuffle_3d(_conv(self.up_conv, x), (2, 2, 2))
        elif cfg.spatial_upsample:
            flat = _conv(self.up_conv, x.reshape(b * f, *x.shape[2:]))
            if cfg.rational_resampler:
                num, den = _RATIONAL_SCALES[float(cfg.spatial_scale)]
                flat = _blur_downsample(_pixel_shuffle_2d(flat, num, num), den)
            else:
                flat = _pixel_shuffle_2d(flat, 2, 2)
            x = flat.reshape(b, f, *flat.shape[1:])
        else:
            # a frame shuffle, then the first frame cropped
            x = _conv(self.up_conv, x)
            bb, ff, h, w, c = x.shape
            x = x.reshape(bb, ff, h, w, c // 2, 2).permute(0, 1, 5, 2, 3, 4).reshape(bb, ff * 2, h, w, c // 2)[:, 1:]
        for i in range(cfg.num_blocks_per_stage):
            x = getattr(self, f"post_res_{i}")(x)
        return _conv(self.final_conv, x)


def upsample_ltx2_video_latents(latents: torch.Tensor, upsampler: LTX2LatentUpsampler, latents_mean: torch.Tensor,
                                latents_std: torch.Tensor, scaling_factor: float = 1.0) -> torch.Tensor:
    """Denormalize (B, F, H, W, C) diffusion latents with the video VAE's
    per-channel statistics, upsample, renormalize."""
    mean = latents_mean.reshape(1, 1, 1, 1, -1)
    std = latents_std.reshape(1, 1, 1, 1, -1)
    up = upsampler(latents * std / scaling_factor + mean)
    return (up - mean) * scaling_factor / std


def _gn(w: Dict[str, torch.Tensor], key: str) -> Dict[str, Dict[str, torch.Tensor]]:
    from ..weight_import import _float

    return {"norm": {"scale": _float(w[f"{key}.weight"]), "bias": _float(w[f"{key}.bias"])}}


def ltx2_upsampler_params(w: Dict[str, torch.Tensor], config: LTX2UpsamplerConfig) -> Dict[str, Dict]:
    """``{"params": tree}`` of an ``LTX2LatentUpsampler`` checkpoint, the JAX
    importer's tree leaf for leaf (f32, bf16 and e4m3 leaves as stored)."""
    from ..weight_import import _conv_generic as conv

    params: Dict[str, Dict] = {
        "initial_conv": conv(w, "initial_conv"),
        "initial_norm": _gn(w, "initial_norm"),
        "final_conv": conv(w, "final_conv"),
    }
    for prefix, ours in (("res_blocks", "res"), ("post_upsample_res_blocks", "post_res")):
        for i in range(config.num_blocks_per_stage):
            params[f"{ours}_{i}"] = {
                "conv1": conv(w, f"{prefix}.{i}.conv1"), "norm1": _gn(w, f"{prefix}.{i}.norm1"),
                "conv2": conv(w, f"{prefix}.{i}.conv2"), "norm2": _gn(w, f"{prefix}.{i}.norm2"),
            }
    rational = config.spatial_upsample and not config.temporal_upsample and config.rational_resampler
    params["up_conv"] = conv(w, "upsampler.conv" if rational else "upsampler.0")
    return {"params": params}


def load_ltx2_latent_upsampler(path: str, config: Optional[LTX2UpsamplerConfig] = None,
                               device="cpu") -> LTX2LatentUpsampler:
    """The upsampler of an LTX-2 upsampler safetensors file on ``device``;
    the config rides the file's ``config`` metadata when present."""
    from ..weight_bridge import load_flax_params
    from ..weight_import import read_safetensors, safetensors_metadata

    if config is None:
        try:
            raw = json.loads(safetensors_metadata(path).get("config", "{}"))
        except (OSError, ValueError):
            raw = {}
        if raw.get("dims", 3) != 3:
            raise NotImplementedError("only dims=3 LTX-2 upsampler checkpoints are supported")
        config = LTX2UpsamplerConfig(
            in_channels=raw.get("in_channels", 128),
            mid_channels=raw.get("mid_channels", 512),
            num_blocks_per_stage=raw.get("num_blocks_per_stage", 4),
            spatial_upsample=raw.get("spatial_upsample", True),
            temporal_upsample=raw.get("temporal_upsample", False),
            spatial_scale=raw.get("spatial_scale", 2.0),
            rational_resampler=raw.get("rational_resampler", False),
        )
    with torch.device(device):
        module = LTX2LatentUpsampler(config)
    return load_flax_params(module, ltx2_upsampler_params(read_safetensors(path), config)["params"])
