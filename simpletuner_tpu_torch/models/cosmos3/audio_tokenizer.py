"""Cosmos3 AVAE audio tokenizer in PyTorch.

Counterpart of ``simpletuner_tpu/models/cosmos3/audio_tokenizer.py``
(``Cosmos3AVAEAudioTokenizer``, the waveform codec of the sound
submodality).  The encoder is an STFT front-end (the (n_fft - hop) pad split
floor / rest, frames taken with ``center=False`` under a periodic hann
window, real ++ imag concatenated channel-major to C * (n_fft + 2)
features), a 1 x 1 conv, per stage ConvNeXt blocks (depthwise k7, a
scale-only f32 LayerNorm over channels with eps 1e-5, x4, log-scale
SnakeBeta or exact gelu, 1 x 1) and a strided conv (k = 2s, pad ceil(s/2)),
then a bias-free 1 x 1 to the moments.  The bottleneck is Oobleck's: mean ++
scale, std = softplus(scale) + 1e-4, the mode unless a generator is given.
The decoder is Oobleck's: a k7 conv, per reversed stride SnakeBeta, a
transposed conv (k = 2s, pad ceil(s/2), output_padding s % 2) and three
dilated residual units (1, 3, 9), then SnakeBeta and a bias-free k7 conv,
clamped to [-1, 1].  ``normalize_volume`` divides the batch by its one
batch-wide peak, as the JAX module does.

The JAX modules compute in NTC; these compute in torch's (B, C, T) with
``conv1d`` / ``conv_transpose1d``, keeping the JAX names (``encoder.layer_{i}``,
``decoder.block_{i}_convt``, ``decoder.block_{i}_res_{j}.snake1_alpha``) so a
Flax tree crosses through the weight bridge.  A module computes in the dtype
of its parameters (f32, or float64 for a reference run); the STFT and the
LayerNorm compute in at least f32.  The importer folds the weight norms
(``g v / ||v||``) in numpy, as the JAX one does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Cosmos3AudioTokenizerConfig:
    sampling_rate: int = 48000
    vocoder_input_dim: int = 64  # latent channels
    input_channels: int = 1
    stereo: bool = True
    enc_dim: int = 192
    enc_num_blocks: int = 2
    enc_n_fft: int = 64
    enc_hop_length: int = 16
    enc_latent_dim: int = 128
    enc_c_mults: Tuple[int, ...] = (1, 2, 4)
    enc_strides: Tuple[int, ...] = (4, 5, 6)
    enc_use_snake: bool = True
    dec_dim: int = 320
    dec_c_mults: Tuple[int, ...] = (1, 2, 4, 8, 16)
    dec_strides: Tuple[int, ...] = (2, 4, 5, 6, 8)
    dec_out_channels: int = 2
    normalize_volume: bool = True

    @property
    def audio_channels(self) -> int:
        return self.input_channels * (2 if self.stereo else 1)

    @property
    def hop_size(self) -> int:
        return int(np.prod(self.dec_strides))

    @classmethod
    def tiny(cls) -> "Cosmos3AudioTokenizerConfig":
        return cls(
            vocoder_input_dim=4,
            enc_dim=8,
            enc_num_blocks=1,
            enc_n_fft=16,
            enc_hop_length=4,
            enc_latent_dim=8,
            enc_c_mults=(1, 2),
            enc_strides=(2, 2),
            dec_dim=8,
            dec_c_mults=(1, 2, 4),
            dec_strides=(4, 2, 2),
        )


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Log-scale SnakeBeta ``x + sin(e^alpha x)^2 / (e^beta + 1e-9)``; x (B, C, T), params (C,)."""
    a = torch.exp(alpha)[:, None]
    b = torch.exp(beta)[:, None]
    return x + torch.sin(a * x) ** 2 / (b + 1e-9)


def stft_features(wave: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """``torch.stft`` with the (n_fft - hop) pad split floor / rest, periodic
    hann, ``center=False``, onesided: (N, samples) -> (N, frames, n_fft + 2)
    real ++ imag."""
    pad_left = (n_fft - hop) // 2
    wave = F.pad(_at_least_f32(wave), (pad_left, n_fft - hop - pad_left))
    frames = wave.unfold(-1, n_fft, hop)  # (N, 1 + (L - n_fft) // hop, n_fft)
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * torch.arange(n_fft, dtype=wave.dtype, device=wave.device) / n_fft)
    spec = torch.fft.rfft(frames * window, dim=-1)
    return torch.cat([spec.real, spec.imag], dim=-1)


class _Snake(nn.Module):
    """Parameters (C,) alpha and beta under the given names, zero at init."""

    def _snake_params(self, dim: int, *names: str) -> None:
        for name in names:
            self.register_parameter(name, nn.Parameter(torch.empty(dim, dtype=torch.float32)))
        self._snake_names = names

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for name in self._snake_names:
            getattr(self, name).zero_()


class ConvNeXtBlock(_Snake):
    """Non-causal ConvNeXt block: depthwise k7, scale-only f32 LayerNorm, 1 x 1 -> x4, SnakeBeta, 1 x 1."""

    def __init__(self, hidden: int, use_snake: bool = True) -> None:
        super().__init__()
        self.use_snake = use_snake
        self.dwconv = nn.Conv1d(hidden, hidden, 7, padding=3, groups=hidden)
        self.norm_scale = nn.Parameter(torch.empty(hidden, dtype=torch.float32))
        self.pwconv1 = nn.Conv1d(hidden, 4 * hidden, 1)
        self.pwconv2 = nn.Conv1d(4 * hidden, hidden, 1)
        self._snake_params(4 * hidden, *(("act_alpha", "act_beta") if use_snake else ()))

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        super().reset_own_parameters(generator)
        self.norm_scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _at_least_f32(self.dwconv(x))
        h = (h - h.mean(1, keepdim=True)) * torch.rsqrt(h.var(1, unbiased=False, keepdim=True) + 1e-5)
        h = (h * self.norm_scale[:, None]).to(x.dtype)
        h = self.pwconv1(h)
        h = snake_beta(h, self.act_alpha, self.act_beta) if self.use_snake else F.gelu(h)
        return x + self.pwconv2(h)


class ConvTranspose1d(nn.Module):
    """torch ``ConvTranspose1d`` semantics; ``weight`` (out, in, k) is the
    JAX (k, in, out) kernel through the bridge, read as conv_transpose1d's
    (in, out, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int, padding: int,
                 output_padding: int = 0) -> None:
        super().__init__()
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(out_channels, dtype=torch.float32))

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        from ..layers import lecun_normal_

        lecun_normal_(self.weight, self.weight.shape[1] * self.weight.shape[2], generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.weight.transpose(0, 1), self.bias, stride=self.stride,
                                  padding=self.padding, output_padding=self.output_padding)


class ResidualUnit(_Snake):
    """SnakeBeta, a k7 conv dilated by ``dilation``, SnakeBeta, a 1 x 1 conv, plus the input."""

    def __init__(self, dim: int, dilation: int = 1) -> None:
        super().__init__()
        self._snake_params(dim, "snake1_alpha", "snake1_beta", "snake2_alpha", "snake2_beta")
        self.conv1 = nn.Conv1d(dim, dim, 7, dilation=dilation, padding=3 * dilation)
        self.conv2 = nn.Conv1d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(snake_beta(x, self.snake1_alpha, self.snake1_beta))
        return x + self.conv2(snake_beta(h, self.snake2_alpha, self.snake2_beta))


class SpecConvNeXtEncoder(nn.Module):
    def __init__(self, config: Cosmos3AudioTokenizerConfig) -> None:
        super().__init__()
        cfg = self.config = config
        features = cfg.audio_channels * (cfg.enc_n_fft + 2)
        output_dim = cfg.enc_c_mults[0] * cfg.enc_dim
        layers = [nn.Conv1d(features, output_dim, 1, bias=False)]
        for index, stride in enumerate(cfg.enc_strides):
            input_dim = cfg.enc_c_mults[index] * cfg.enc_dim
            output_dim = cfg.enc_c_mults[min(index + 1, len(cfg.enc_c_mults) - 1)] * cfg.enc_dim
            layers += [ConvNeXtBlock(input_dim, cfg.enc_use_snake) for _ in range(cfg.enc_num_blocks)]
            layers.append(nn.Conv1d(input_dim, output_dim, 2 * stride, stride=stride, padding=math.ceil(stride / 2)))
        layers.append(nn.Conv1d(output_dim, cfg.enc_latent_dim, 1, bias=False))
        for i, layer in enumerate(layers):
            self.add_module(f"layer_{i}", layer)
        self.num_layers = len(layers)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, C, T) waveform -> (B, enc_latent_dim, T_lat) moments."""
        cfg = self.config
        batch, channels, samples = audio.shape
        spec = stft_features(audio.reshape(batch * channels, samples), cfg.enc_n_fft, cfg.enc_hop_length)
        frames = spec.shape[1]
        # (B C, T, F2) -> (B, C F2, T): channel-major, as the reference reshape
        h = spec.reshape(batch, channels, frames, cfg.enc_n_fft + 2).permute(0, 1, 3, 2)
        h = h.reshape(batch, channels * (cfg.enc_n_fft + 2), frames).to(self.layer_0.weight.dtype)
        for i in range(self.num_layers):
            h = getattr(self, f"layer_{i}")(h)
        return h


class OobleckDecoder(_Snake):
    def __init__(self, config: Cosmos3AudioTokenizerConfig) -> None:
        super().__init__()
        cfg = self.config = config
        mults = (1,) + tuple(cfg.dec_c_mults)
        strides = tuple(reversed(cfg.dec_strides))
        self.conv1 = nn.Conv1d(cfg.vocoder_input_dim, cfg.dec_dim * mults[-1], 7, padding=3)
        names = []
        for i, stride in enumerate(strides):
            input_dim = cfg.dec_dim * mults[len(strides) - i]
            output_dim = cfg.dec_dim * mults[len(strides) - i - 1]
            for leaf in ("alpha", "beta"):
                self.register_parameter(f"block_{i}_snake_{leaf}",
                                        nn.Parameter(torch.empty(input_dim, dtype=torch.float32)))
                names.append(f"block_{i}_snake_{leaf}")
            self.add_module(f"block_{i}_convt", ConvTranspose1d(
                input_dim, output_dim, 2 * stride, stride, math.ceil(stride / 2), stride % 2))
            for j, dilation in enumerate((1, 3, 9)):
                self.add_module(f"block_{i}_res_{j}", ResidualUnit(output_dim, dilation))
        self._snake_params(cfg.dec_dim, "snake_out_alpha", "snake_out_beta")
        self._snake_names = tuple(names) + self._snake_names
        self.conv2 = nn.Conv1d(cfg.dec_dim, cfg.dec_out_channels, 7, padding=3, bias=False)
        self.num_blocks = len(strides)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, vocoder_input_dim, T_lat) -> (B, dec_out_channels, N)."""
        h = self.conv1(latents.to(self.conv1.weight.dtype))
        for i in range(self.num_blocks):
            h = snake_beta(h, getattr(self, f"block_{i}_snake_alpha"), getattr(self, f"block_{i}_snake_beta"))
            h = getattr(self, f"block_{i}_convt")(h)
            for j in range(3):
                h = getattr(self, f"block_{i}_res_{j}")(h)
        return self.conv2(snake_beta(h, self.snake_out_alpha, self.snake_out_beta))


class Cosmos3AudioTokenizer(nn.Module):
    """Encoder, Oobleck bottleneck and decoder over (B, C, T) waveforms."""

    def __init__(self, config: Cosmos3AudioTokenizerConfig = Cosmos3AudioTokenizerConfig()) -> None:
        super().__init__()
        self.config = config
        self.encoder = SpecConvNeXtEncoder(config)
        self.decoder = OobleckDecoder(config)

    def encode(self, sample: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, C, T) waveform -> (B, vocoder_input_dim, T_lat) latents: the
        posterior mode, or a draw from ``generator``."""
        cfg = self.config
        if cfg.normalize_volume:  # one peak over the whole batch, as the JAX module
            sample = sample / (sample.abs().max() + 1e-5) * 0.95
        pad = (cfg.hop_size - sample.shape[-1] % cfg.hop_size) % cfg.hop_size
        if pad:
            sample = F.pad(sample, (0, pad))
        mean, scale = self.encoder(sample).chunk(2, dim=1)
        if generator is not None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
            mean = mean + (F.softplus(scale) + 1e-4) * noise
        return mean

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, vocoder_input_dim, T_lat) -> (B, dec_out_channels, N) clamped to [-1, 1]."""
        return self.decoder(latents).clamp(-1.0, 1.0)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(sample))


def _fold_weight_norm(w: Mapping[str, torch.Tensor], key: str) -> np.ndarray:
    """A weight-normed conv's effective torch kernel, folded in numpy f32."""
    if f"{key}.weight" in w:
        return w[f"{key}.weight"].float().numpy()
    g = w[f"{key}.weight_g"].float().numpy()  # (O, 1, 1)
    v = w[f"{key}.weight_v"].float().numpy()  # (O, I, k)
    norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _conv1d(w: Mapping[str, torch.Tensor], key: str) -> Dict[str, torch.Tensor]:
    out = {"kernel": torch.from_numpy(np.ascontiguousarray(_fold_weight_norm(w, key).transpose(2, 1, 0)))}
    if f"{key}.bias" in w:
        out["bias"] = w[f"{key}.bias"].float()
    return out


def _snake(w: Mapping[str, torch.Tensor], key: str, dst: dict, alpha_name: str, beta_name: str) -> None:
    dst[alpha_name] = w[f"{key}.alpha"].float().reshape(-1)
    dst[beta_name] = w[f"{key}.beta"].float().reshape(-1)


def cosmos3_audio_tokenizer_params(w: Mapping[str, torch.Tensor], config: Cosmos3AudioTokenizerConfig
                                   ) -> Dict[str, Any]:
    """A ``Cosmos3AVAEAudioTokenizer`` torch state dict as the Flax
    ``{"params": ...}`` tree (weight norms folded, ``conv_t1`` (I, O, k)
    kernels as (k, I, O))."""
    cfg = config
    enc: Dict[str, Any] = {}
    layer = 0
    enc[f"layer_{layer}"] = _conv1d(w, f"encoder.layers.{layer}")
    layer += 1
    for _ in cfg.enc_strides:
        for _ in range(cfg.enc_num_blocks):
            src = f"encoder.layers.{layer}"
            blk = {
                "dwconv": _conv1d(w, f"{src}.dwconv.1"),  # a Sequential(pad, conv)
                "norm_scale": w[f"{src}.norm.weight"].float(),
                "pwconv1": _conv1d(w, f"{src}.pwconv1"),
                "pwconv2": _conv1d(w, f"{src}.pwconv2"),
            }
            if f"{src}.act.alpha" in w:
                _snake(w, f"{src}.act", blk, "act_alpha", "act_beta")
            enc[f"layer_{layer}"] = blk
            layer += 1
        enc[f"layer_{layer}"] = _conv1d(w, f"encoder.layers.{layer}")
        layer += 1
    enc[f"layer_{layer}"] = _conv1d(w, f"encoder.layers.{layer}")

    dec: Dict[str, Any] = {"conv1": _conv1d(w, "decoder.conv1"), "conv2": _conv1d(w, "decoder.conv2")}
    _snake(w, "decoder.snake1", dec, "snake_out_alpha", "snake_out_beta")
    for i in range(len(cfg.dec_strides)):
        src = f"decoder.block.{i}"
        _snake(w, f"{src}.snake1", dec, f"block_{i}_snake_alpha", f"block_{i}_snake_beta")
        kt = _fold_weight_norm(w, f"{src}.conv_t1")  # (I, O, k)
        dec[f"block_{i}_convt"] = {"kernel": torch.from_numpy(np.ascontiguousarray(kt.transpose(2, 0, 1))),
                                   "bias": w[f"{src}.conv_t1.bias"].float()}
        for j, unit in enumerate(("res_unit1", "res_unit2", "res_unit3")):
            node = {"conv1": _conv1d(w, f"{src}.{unit}.conv1"), "conv2": _conv1d(w, f"{src}.{unit}.conv2")}
            _snake(w, f"{src}.{unit}.snake1", node, "snake1_alpha", "snake1_beta")
            _snake(w, f"{src}.{unit}.snake2", node, "snake2_alpha", "snake2_beta")
            dec[f"block_{i}_res_{j}"] = node
    return {"params": {"encoder": enc, "decoder": dec}}


def load_cosmos3_audio_tokenizer(config: Cosmos3AudioTokenizerConfig, path: str) -> Dict[str, Any]:
    """Import a ``Cosmos3AVAEAudioTokenizer`` checkpoint; a decoder-only file
    (no ``encoder.*`` keys) is refused, since encode needs the encoder."""
    from ..weight_import import read_safetensors

    w = read_safetensors(path)
    if not any(k.startswith("encoder.") for k in w):
        raise ValueError(
            "decoder-only Cosmos3 AVAE checkpoint: encoder weights are "
            "required for encode(); re-convert with encoder weights"
        )
    return cosmos3_audio_tokenizer_params(w, config)
