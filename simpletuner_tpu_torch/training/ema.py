"""EMA of the trainable tensors.

PyTorch counterpart of ``simpletuner_tpu/training/ema.py``: a warmup-aware
decay and an f32 lerp of every trainable tensor after each optimizer update,
optionally only every ``update_interval`` steps.

``ema_update`` takes the step as a 0-dim tensor (the train state's device
step, which a captured step advances itself) and computes the decay on its
device in f32, as the JAX function does; an update-interval step that is
skipped selects the old tensors on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    decay: float = 0.9999
    update_interval: Optional[int] = None
    use_warmup: bool = True
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0


def ema_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()}


def ema_decay_for_step(config: EMAConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup decay ``1 - (1 + s / inv_gamma) ** -power``, clipped to [0,
    decay], in f32 on the step's device (the JAX arithmetic)."""
    step = torch.clamp_min(step.to(torch.float32), 0.0)
    if not config.use_warmup:
        return torch.full((), config.decay, dtype=torch.float32, device=step.device)
    warmup_decay = 1.0 - (1.0 + step / config.inv_gamma) ** -config.power
    return torch.clamp(warmup_decay, 0.0, config.decay)


@torch.no_grad()
def ema_update(
    config: EMAConfig, ema_params: Dict[str, torch.Tensor], new_params: Dict[str, torch.Tensor],
    optimization_step: Union[int, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """The EMA after one update; the old tensors on steps that are not a
    multiple of ``update_interval``.  An int step is taken as an int32 tensor."""
    device = next(iter(ema_params.values())).device if ema_params else None
    step = torch.as_tensor(optimization_step, dtype=torch.int32, device=device)
    decay = ema_decay_for_step(config, step)
    updated = {k: e * decay + new_params[k].float() * (1.0 - decay) for k, e in ema_params.items()}
    if config.update_interval and config.update_interval > 1:
        apply = torch.remainder(step, config.update_interval) == 0
        updated = {k: torch.where(apply, u, ema_params[k]) for k, u in updated.items()}
    return updated
