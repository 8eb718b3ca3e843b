"""Flow-matching Euler scheduler.

Counterpart of ``simpletuner_tpu/schedulers/flow_euler.py``: the sigma ladder
from 1 down to 1/N with a static shift or the resolution-dependent exp-mu
shift, and the Euler step x_{t_next} = x_t + (sigma_next - sigma) * v.  The
ladder is an f32 CPU tensor; a step moves to the latents' device as a scalar.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


def time_shift(sigmas: torch.Tensor, shift: float) -> torch.Tensor:
    """Static shift: s*sigma / (1 + (s - 1)*sigma)."""
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


def dynamic_shift_mu(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
) -> float:
    """Resolution-dependent mu for the exp shift."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def time_shift_exp(sigmas: torch.Tensor, mu: float) -> torch.Tensor:
    """exp-mu shift: e^mu / (e^mu + (1/sigma - 1))."""
    emu = math.exp(mu)
    return emu / (emu + (1.0 / sigmas.clamp(min=1e-6) - 1.0))


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerScheduler:
    """Precomputed sigma ladder (num_steps + 1,), sigma_0 = 1 ... sigma_N = 0."""

    sigmas: torch.Tensor
    timesteps: torch.Tensor  # (num_steps,), what the model consumes (sigma itself)

    @classmethod
    def create(
        cls,
        num_steps: int,
        shift: Optional[float] = 3.0,
        use_dynamic_shifting: bool = False,
        image_seq_len: Optional[int] = None,
        base_shift: float = 0.5,
        max_shift: float = 1.15,
    ) -> "FlowMatchEulerScheduler":
        sigmas = torch.linspace(1.0, 1.0 / num_steps, num_steps, dtype=torch.float32)
        if use_dynamic_shifting and image_seq_len is not None:
            mu = dynamic_shift_mu(image_seq_len, base_shift=base_shift, max_shift=max_shift)
            sigmas = time_shift_exp(sigmas, mu)
        elif shift and shift != 1.0:
            sigmas = time_shift(sigmas, shift)
        sigmas = torch.cat([sigmas, torch.zeros(1, dtype=torch.float32)])
        return cls(sigmas=sigmas, timesteps=sigmas[:-1])

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    def init_latents(self, noise: torch.Tensor) -> torch.Tensor:
        return noise  # flow starts at pure noise (sigma = 1)

    def add_noise(self, latents: torch.Tensor, noise: torch.Tensor, i: int) -> torch.Tensor:
        """Noise clean latents to step ``i``'s sigma (img2img entry point)."""
        sigma = self.sigmas[i].item()
        return (1.0 - sigma) * latents + sigma * noise

    def timestep(self, i: int) -> torch.Tensor:
        return self.sigmas[i]

    def step(self, i: int, latents: torch.Tensor, model_pred: torch.Tensor) -> torch.Tensor:
        delta = (self.sigmas[i + 1] - self.sigmas[i]).item()  # f32 difference, as in JAX
        return latents + delta * model_pred.to(latents.dtype)


def flow_sigmas_for_training(num_steps: int, shift: float = 3.0) -> torch.Tensor:
    """Discrete sigma ladder for 'fast' discrete flow sampling during training."""
    return FlowMatchEulerScheduler.create(num_steps, shift=shift).sigmas[:-1]
