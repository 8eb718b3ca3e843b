"""EDM Euler scheduler (the Karras sigma ladder) for x0-prediction families.

Counterpart of ``simpletuner_tpu/schedulers/edm_euler.py``: Cosmos-Predict2
trains with additive noise x_t = x0 + sigma eps and samples down a Karras
rho = 7 ladder from sigma_max = 80 to sigma_min = 0.002, then 0.  The
family's ``model_predict`` returns the preconditioned x0 estimate, so one
step is d = (x_i - x0) / sigma_i, x_{i+1} = x_i + (sigma_{i+1} - sigma_i) d.
The ladder is made in float64 on the host and kept as an f32 CPU tensor; a
step moves to the latents' device as scalars.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EDMEulerScheduler:
    """Precomputed Karras sigma ladder (num_steps + 1,): sigma_max ... sigma_min, 0."""

    sigmas: torch.Tensor
    timesteps: torch.Tensor  # (num_steps,): the sigma the model consumes

    @classmethod
    def create(cls, num_steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
               rho: float = 7.0) -> "EDMEulerScheduler":
        ramp = np.linspace(0.0, 1.0, num_steps)
        min_inv = sigma_min ** (1.0 / rho)
        max_inv = sigma_max ** (1.0 / rho)
        sigmas = (max_inv + ramp * (min_inv - max_inv)) ** rho
        sigmas = torch.from_numpy(np.concatenate([sigmas, [0.0]]).astype(np.float32))
        return cls(sigmas=sigmas, timesteps=sigmas[:-1])

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    def init_latents(self, noise: torch.Tensor) -> torch.Tensor:
        return noise * self.sigmas[0].item()

    def add_noise(self, latents: torch.Tensor, noise: torch.Tensor, i: int) -> torch.Tensor:
        """Noise clean latents to step ``i``'s sigma (img2img entry point)."""
        return latents + self.sigmas[i].item() * noise

    def timestep(self, i: int) -> torch.Tensor:
        return self.timesteps[i]

    def step(self, i: int, latents: torch.Tensor, model_pred: torch.Tensor) -> torch.Tensor:
        """``model_pred`` is the x0 estimate."""
        d = (latents - model_pred.to(torch.float32)) / max(self.sigmas[i].item(), 1e-8)
        return latents + (self.sigmas[i + 1] - self.sigmas[i]).item() * d  # an f32 difference, as in JAX
