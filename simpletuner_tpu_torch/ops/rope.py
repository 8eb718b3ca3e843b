"""Rotary position embeddings (axial, Flux-style).

PyTorch counterpart of ``simpletuner_tpu/ops/rope.py``: cos/sin tables per
axis, concatenated across axes, applied to interleaved (even, odd) channel
pairs in f32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rope_frequencies(dim: int, positions: torch.Tensor, theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for one axis: positions (..., seq) -> (..., seq, dim // 2)."""
    if dim % 2:
        raise ValueError("rope dim must be even")
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / (theta ** exponent)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def axial_rope(
    axes_dim: Sequence[int],
    ids: torch.Tensor,
    theta: float = 10000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-axis RoPE table: ids (..., seq, n_axes) -> cos, sin (..., seq, head_dim // 2)."""
    tables = [rope_frequencies(dim, ids[..., axis], theta) for axis, dim in enumerate(axes_dim)]
    return torch.cat([c for c, _ in tables], dim=-1), torch.cat([s for _, s in tables], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved (even, odd) channel pairs of x (..., seq, heads, head_dim).

    cos/sin: (..., seq, head_dim // 2), broadcast over the heads axis."""
    x_pairs = x.to(torch.float32).reshape(*x.shape[:-1], -1, 2)
    x_even, x_odd = x_pairs[..., 0], x_pairs[..., 1]
    cos_b = cos.unsqueeze(-2)
    sin_b = sin.unsqueeze(-2)
    rotated = torch.stack(
        [x_even * cos_b - x_odd * sin_b, x_even * sin_b + x_odd * cos_b], dim=-1
    )
    return rotated.reshape(x.shape).to(x.dtype)
