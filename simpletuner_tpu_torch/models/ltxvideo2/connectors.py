"""LTX-2 Gemma text connectors in PyTorch.

Counterpart of ``simpletuner_tpu/models/ltxvideo2/connectors.py``
(``LTX2TextConnectors``): the stacked Gemma hidden states (49 layers x 3840)
are range-normalized per layer over the valid tokens (x 8), projected to
3840 without a bias, and run through one 2-layer 1-D transformer per
modality (30 heads x 128) whose padded positions are replaced by tiled
learnable registers, so the output carries no padding mask: affine-free RMS
norms, 1-D fractional-coordinate interleaved RoPE and the ``LTX2Attention``
of the DiT (its attention through the flash kernels on the card, unmasked).

As in the JAX package, nothing calls the connectors on the encode path
(``LTXVideo2.encode_text`` tiles the Gemma width to 3840 instead; ROADMAP
Queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..layers import FeedForward, LoRADense
from .transformer import LTX2Attention, ltx2_rope_tables, rms_plain


@dataclasses.dataclass(frozen=True)
class LTX2ConnectorConfig:
    caption_channels: int = 3840
    text_proj_in_factor: int = 49  # stacked Gemma layers
    num_heads: int = 30
    head_dim: int = 128
    num_layers: int = 2
    num_registers: int = 128
    rope_base_seq_len: int = 4096
    rope_theta: float = 10000.0
    scale_factor: int = 8

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.head_dim

    @classmethod
    def tiny(cls) -> "LTX2ConnectorConfig":
        return cls(caption_channels=16, text_proj_in_factor=3, num_heads=2, head_dim=8, num_layers=1, num_registers=4)


def per_layer_masked_mean_norm(hidden: torch.Tensor, mask: torch.Tensor, scale_factor: float = 8.0,
                               eps: float = 1e-6) -> torch.Tensor:
    """(B, S, D, L) stacked layers and a (B, S) mask -> (B, S, D L): per
    sample and layer, (h - mean) / (max - min + eps) x ``scale_factor`` over
    the valid tokens, the padded tokens 0."""
    m = mask.to(torch.bool)[:, :, None, None]
    h = hidden.to(torch.float32)
    valid = mask.to(torch.float32).sum(dim=1) * h.shape[2]
    mean = torch.where(m, h, 0.0).sum(dim=(1, 2), keepdim=True) / (valid[:, None, None, None] + eps)
    x_min = torch.where(m, h, torch.inf).amin(dim=(1, 2), keepdim=True)
    x_max = torch.where(m, h, -torch.inf).amax(dim=(1, 2), keepdim=True)
    normalized = ((h - mean) / (x_max - x_min + eps) * scale_factor).reshape(hidden.shape[0], hidden.shape[1], -1)
    return torch.where(mask.to(torch.bool)[:, :, None], normalized, 0.0)


class ConnectorTransformer1d(nn.Module):
    """The 1-D connector over (B, S, dim) left-padded features and their
    (B, S) mask: each row rolled so its valid tokens lead, the registers
    tiled over the tail, then ``num_layers`` RMS-norm attention + FFN
    blocks and a final RMS norm."""

    def __init__(self, config: LTX2ConnectorConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim = config.inner_dim
        self.learnable_registers = nn.Parameter(torch.empty(config.num_registers, dim, dtype=torch.float32))
        for i in range(config.num_layers):
            self.add_module(f"block_{i}_attn", LTX2Attention(dim, config.num_heads, config.head_dim, dim, dtype=dtype))
            self.add_module(f"block_{i}_ff", FeedForward(dim, 4.0, dtype=dtype))
        self._rope: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.learnable_registers.uniform_(-1.0, 1.0, generator=generator)

    def rope(self, seq: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (seq, device)
        if key not in self._rope:
            cfg = self.config
            tables = ltx2_rope_tables(np.arange(seq, dtype=np.float64)[:, None], (cfg.rope_base_seq_len,),
                                      cfg.inner_dim, cfg.rope_theta)
            self._rope[key] = tuple(torch.from_numpy(a).to(device) for a in tables)
        return self._rope[key]

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        batch, seq = x.shape[:2]
        if seq % cfg.num_registers != 0:
            raise ValueError(f"sequence length {seq} must divide the register count {cfg.num_registers}")
        tiled = self.learnable_registers.repeat(seq // cfg.num_registers, 1).to(self.dtype)
        # each row rolled left by its pad count: row b's token j reads (j + pad_b) mod S
        valid = mask.to(torch.int64).sum(dim=1)
        positions = torch.arange(seq, device=x.device)
        source = (positions[None, :] + (seq - valid)[:, None]) % seq
        fronted = torch.gather(x, 1, source[..., None].expand(batch, seq, x.shape[-1]))
        h = torch.where((positions[None, :] < valid[:, None])[..., None], fronted.to(self.dtype), tiled[None])
        rope = self.rope(seq, x.device)
        for i in range(cfg.num_layers):
            h = h + getattr(self, f"block_{i}_attn")(rms_plain(h), q_rope=rope)
            h = h + getattr(self, f"block_{i}_ff")(rms_plain(h))
        return rms_plain(h)


class LTX2TextConnectors(nn.Module):
    """(B, S, caption_channels x 49) stacked, left-padded Gemma features and
    their mask -> (video, audio) connector features (B, S, dim)."""

    def __init__(self, config: LTX2ConnectorConfig = LTX2ConnectorConfig(),
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        self.text_proj_in = LoRADense(config.caption_channels * config.text_proj_in_factor, config.caption_channels,
                                      use_bias=False, dtype=dtype)
        self.video_connector = ConnectorTransformer1d(config, dtype)
        self.audio_connector = ConnectorTransformer1d(config, dtype)

    def forward(self, text_hidden_states: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        stacked = text_hidden_states.reshape(*text_hidden_states.shape[:2], cfg.caption_channels, -1)
        proj = self.text_proj_in(per_layer_masked_mean_norm(stacked, mask, cfg.scale_factor).to(self.dtype))
        return self.video_connector(proj, mask), self.audio_connector(proj, mask)


def ltx2_connector_params(w: Dict[str, torch.Tensor], config: LTX2ConnectorConfig) -> Dict[str, Dict]:
    """``{"params": tree}`` of an ``LTX2TextConnectors`` checkpoint, the JAX
    importer's tree leaf for leaf (f32, bf16 and e4m3 leaves as stored)."""
    from ..weight_import import _float, _linear

    def connector(prefix):
        params = {"learnable_registers": _float(w[f"{prefix}.learnable_registers"])}
        for i in range(config.num_layers):
            src = f"{prefix}.transformer_blocks.{i}"
            attn = {name: _linear(w, f"{src}.attn1.{name}") for name in ("to_q", "to_k", "to_v")}
            attn.update(norm_q=_float(w[f"{src}.attn1.norm_q.weight"]),
                        norm_k=_float(w[f"{src}.attn1.norm_k.weight"]), to_out=_linear(w, f"{src}.attn1.to_out.0"))
            params[f"block_{i}_attn"] = attn
            params[f"block_{i}_ff"] = {"proj_in": _linear(w, f"{src}.ff.net.0.proj"),
                                       "proj_out": _linear(w, f"{src}.ff.net.2")}
        return params

    return {"params": {"text_proj_in": _linear(w, "text_proj_in"),
                       "video_connector": connector("video_connector"),
                       "audio_connector": connector("audio_connector")}}


def load_ltx2_connectors(config: LTX2ConnectorConfig, path: str, dtype: torch.dtype = torch.bfloat16,
                         device="cpu") -> LTX2TextConnectors:
    """``LTX2TextConnectors`` on ``device`` from a connectors safetensors checkpoint."""
    from ..weight_bridge import load_flax_params
    from ..weight_import import read_safetensors

    with torch.device(device):
        module = LTX2TextConnectors(config, dtype)
    return load_flax_params(module, ltx2_connector_params(read_safetensors(path), config)["params"])
