"""UniPC (order-2 predictor) scheduler.

Counterpart of ``simpletuner_tpu/schedulers/unipc.py``: the B(h) = h,
order-2 data-prediction update over the DDPM (alpha-bar ladder)
parameterization, ``create_ddpm``, which ``build_scheduler`` builds.  (The
JAX module's ``create_flow`` and ``add_noise`` have no caller there and are
not ported.)  The previous x0
prediction is the scheduler's state: callers use ``init_state`` /
``step_with_state``.  The ladders are f32 CPU tensors; each step's
coefficients are f32 scalars computed there, and the update runs in f32 on
the latents' device, blended as the JAX step blends its two orders.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..training.losses import DDPMScheduleConfig, make_alphas_cumprod


@dataclasses.dataclass(frozen=True)
class UniPCScheduler:
    timesteps: torch.Tensor  # (num_steps,) model-facing timesteps
    lambdas: torch.Tensor  # (num_steps + 1,) lambda_i = log(alpha_i / sigma_i)
    alphas: torch.Tensor  # (num_steps + 1,)
    sigmas: torch.Tensor  # (num_steps + 1,)
    prediction_type: str = "flow_matching"

    @classmethod
    def create_ddpm(
        cls,
        num_steps: int,
        schedule: DDPMScheduleConfig = DDPMScheduleConfig(),
        prediction_type: str = "epsilon",
    ) -> "UniPCScheduler":
        ratio = schedule.num_train_timesteps // num_steps
        ts = (torch.arange(num_steps) * ratio).to(torch.int32).flip(0)
        ac = make_alphas_cumprod(schedule)
        ac_i = torch.cat([ac[ts.long()], torch.tensor([1.0 - 1e-6])])
        alphas = torch.sqrt(ac_i)
        sigmas = torch.sqrt(1.0 - ac_i)
        lambdas = torch.log(torch.clamp(alphas, min=1e-8)) - torch.log(torch.clamp(sigmas, min=1e-8))
        return cls(timesteps=ts, lambdas=lambdas, alphas=alphas, sigmas=sigmas, prediction_type=prediction_type)

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    def init_latents(self, noise: torch.Tensor) -> torch.Tensor:
        return noise

    def timestep(self, i: int) -> torch.Tensor:
        return self.timesteps[i]

    def _to_x0(self, i: int, x: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        a, s = self.alphas[i].item(), self.sigmas[i].item()
        if self.prediction_type == "flow_matching":
            return x - s * pred  # v = eps - x0 with x = (1 - sigma) x0 + sigma eps
        if self.prediction_type == "epsilon":
            return (x - s * pred) / a
        if self.prediction_type == "v_prediction":
            return a * x - s * pred
        return pred  # sample

    def init_state(self, noise: torch.Tensor) -> Dict[str, object]:
        return {"prev_x0": torch.zeros_like(noise, dtype=torch.float32), "have_prev": 0.0}

    def step_with_state(self, i: int, latents: torch.Tensor, model_pred: torch.Tensor, state):
        x = latents.to(torch.float32)
        x0 = self._to_x0(i, x, model_pred.to(torch.float32))
        have_prev = state["have_prev"] > 0
        lam, lam_next = self.lambdas[i], self.lambdas[i + 1]
        lam_prev = self.lambdas[max(i - 1, 0)] if have_prev else lam
        h = lam_next - lam
        a_next, s_next, s_t = self.alphas[i + 1], self.sigmas[i + 1], self.sigmas[i]
        # order 1 (DPM-Solver++ / DDIM-like) data-prediction update; the f32
        # scalar products are formed first, as in the JAX expression
        phi1 = torch.expm1(-h)
        x_next1 = (s_next / s_t).item() * x - (a_next * phi1).item() * x0
        # order 2: extrapolate with the previous x0 difference
        r = lam - lam_prev if abs(float(lam - lam_prev)) > 1e-8 else torch.tensor(1.0)
        r = r if abs(float(r)) > 1e-8 else torch.tensor(1.0)
        d1 = (x0 - state["prev_x0"]) / r.item() * h.item()
        x_next2 = x_next1 - (a_next * (phi1 / h + 1.0) * 0.5).item() * d1
        use2 = 1.0 if have_prev else 0.0
        x_next = x_next1 * (1.0 - use2) + x_next2 * use2
        return x_next.to(latents.dtype), {"prev_x0": x0, "have_prev": 1.0}
