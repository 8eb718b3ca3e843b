"""EMA of the trainable tensors.

PyTorch counterpart of ``simpletuner_tpu/training/ema.py``: a warmup-aware
decay and an f32 lerp of every trainable tensor after each optimizer update,
optionally only every ``update_interval`` steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    decay: float = 0.9999
    update_interval: Optional[int] = None
    use_warmup: bool = True
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0


def ema_decay_for_step(config: EMAConfig, optimization_step: int) -> float:
    """Warmup decay ``1 - (1 + s / inv_gamma) ** -power``, clipped to [0, decay]."""
    step = max(float(optimization_step), 0.0)
    if not config.use_warmup:
        return config.decay
    warmup_decay = 1.0 - (1.0 + step / config.inv_gamma) ** -config.power
    return min(max(warmup_decay, 0.0), config.decay)


def ema_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()}


@torch.no_grad()
def ema_update(
    config: EMAConfig, ema_params: Dict[str, torch.Tensor], new_params: Dict[str, torch.Tensor],
    optimization_step: int,
) -> Dict[str, torch.Tensor]:
    if config.update_interval and config.update_interval > 1 and optimization_step % config.update_interval:
        return ema_params
    decay = ema_decay_for_step(config, optimization_step)
    return {k: e * decay + new_params[k].float() * (1.0 - decay) for k, e in ema_params.items()}
