"""DDIM scheduler for the epsilon / v-prediction families (SDXL, SD 1.x).

Counterpart of ``simpletuner_tpu/schedulers/ddim.py``: the deterministic
(eta = 0) DDIM update over the family's alpha-bar ladder, with ``leading`` or
``trailing`` timestep spacing, epsilon / v / sample prediction and
``set_alpha_to_one``.  (``add_noise``, the img2img entry, waits for img2img
validation, ROADMAP Queue 1 item 4d.)  The ladder is an f32 CPU tensor; each step's
coefficients are f32 scalars computed there, and the update runs in f32 on
the latents' device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..training.losses import DDPMScheduleConfig, make_alphas_cumprod


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    timesteps: torch.Tensor  # (num_steps,) descending int32 timesteps
    alphas_cumprod: torch.Tensor  # (train_steps,) f32
    final_alpha_cumprod: torch.Tensor  # f32 scalar, alpha-bar of the "-1" step
    prediction_type: str = "epsilon"

    @classmethod
    def create(
        cls,
        num_steps: int,
        schedule: DDPMScheduleConfig = DDPMScheduleConfig(),
        prediction_type: str = "epsilon",
        set_alpha_to_one: bool = True,
        timestep_spacing: str = "leading",
    ) -> "DDIMScheduler":
        train_steps = schedule.num_train_timesteps
        if timestep_spacing == "trailing":
            step = train_steps / num_steps
            ts = (torch.round(torch.arange(train_steps, 0, -step, dtype=torch.float32)) - 1).to(torch.int32)
        else:  # leading
            ratio = train_steps // num_steps
            ts = (torch.arange(num_steps) * ratio).to(torch.int32).flip(0)
        ac = make_alphas_cumprod(schedule)
        final = torch.tensor(1.0) if set_alpha_to_one else ac[0]
        return cls(timesteps=ts, alphas_cumprod=ac, final_alpha_cumprod=final, prediction_type=prediction_type)

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    def init_latents(self, noise: torch.Tensor) -> torch.Tensor:
        return noise

    def timestep(self, i: int) -> torch.Tensor:
        return self.timesteps[i]

    def step(self, i: int, latents: torch.Tensor, model_pred: torch.Tensor) -> torch.Tensor:
        t = int(self.timesteps[i])
        prev_t = t - self.alphas_cumprod.shape[0] // self.num_steps
        alpha = self.alphas_cumprod[t]
        alpha_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
        sqrt_a, sqrt_b = torch.sqrt(alpha).item(), torch.sqrt(1.0 - alpha).item()
        pred = model_pred.to(torch.float32)
        x = latents.to(torch.float32)
        if self.prediction_type == "epsilon":
            x0 = (x - sqrt_b * pred) / sqrt_a
            eps = pred
        elif self.prediction_type == "v_prediction":
            x0 = sqrt_a * x - sqrt_b * pred
            eps = sqrt_a * pred + sqrt_b * x
        elif self.prediction_type == "sample":
            x0 = pred
            eps = (x - sqrt_a * x0) / sqrt_b
        else:
            raise ValueError(f"unknown prediction_type {self.prediction_type}")
        out = torch.sqrt(alpha_prev).item() * x0 + torch.sqrt(1.0 - alpha_prev).item() * eps
        return out.to(latents.dtype)
