"""Sampling loop and classifier-free guidance.

Counterpart of ``simpletuner_tpu/schedulers/sampling.py``.  The JAX loop is a
``lax.scan`` inside one jitted program; PyTorch runs eagerly, so here it is a
Python loop over the scheduler's steps.  Only text-to-image sampling with a
stateless scheduler is ported (no img2img strength, no partial ladders).
"""

from __future__ import annotations

from typing import Callable

import torch


def classifier_free_guidance(
    cond: torch.Tensor,
    uncond: torch.Tensor,
    scale: float,
    rescale: float = 0.0,
) -> torch.Tensor:
    """CFG with optional std rescaling toward the conditional prediction."""
    guided = uncond + scale * (cond - uncond)
    if not rescale:
        return guided
    dims = tuple(range(1, guided.dim()))
    std_cond = cond.std(dim=dims, keepdim=True, unbiased=False)
    std_guided = guided.std(dim=dims, keepdim=True, unbiased=False).clamp(min=1e-8)
    renorm = guided * (std_cond / std_guided)
    return rescale * renorm + (1.0 - rescale) * guided


def sample_loop(
    scheduler,
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    noise: torch.Tensor,
) -> torch.Tensor:
    """Run the full denoise ladder from ``noise``.

    ``denoise_fn(latents, timestep) -> model_pred`` closes over the weights
    and conditioning (and CFG if wanted)."""
    if hasattr(scheduler, "step_with_state"):
        raise NotImplementedError("stateful schedulers are not ported")
    latents = scheduler.init_latents(noise)
    for i in range(scheduler.num_steps):
        latents = scheduler.step(i, latents, denoise_fn(latents, scheduler.timestep(i)))
    return latents
