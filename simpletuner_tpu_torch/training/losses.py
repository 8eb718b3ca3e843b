"""Flow-matching loss math: sigma sampling, schedule shifts, interpolation, loss.

PyTorch counterpart of the flow-matching half of
``simpletuner_tpu/training/losses.py``.  Random draws come from an explicit
``torch.Generator``; they are not JAX's numbers, so parity is held on their
distribution or through the ``override_noise``/``override_sigmas`` batch
hooks.  The DDPM (epsilon / v-prediction) schedules and SNR weighting are not
ported: the flow families take none of them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class FlowScheduleConfig:
    sigmoid_scale: float = 1.0
    schedule_shift: Optional[float] = None
    auto_shift: bool = False
    use_uniform_schedule: bool = False
    use_beta_schedule: bool = False
    beta_alpha: float = 2.0
    beta_beta: float = 2.0
    # an explicit sigma list (values > 1 parse as timesteps / 1000): fixed-list
    # samples from it, round-robin cycles by (global step, batch index, process)
    custom_sigmas: Optional[Tuple[float, ...]] = None
    custom_mode: str = "fixed-list"  # fixed-list | round-robin
    # the schnell 4-level schedule [1.0, 0.3, 0.2, 0.1], drawn uniformly
    fast_schedule: bool = False


def parse_flow_custom_timesteps(raw) -> Optional[Tuple[float, ...]]:
    """Comma/semicolon string, JSON list, or sequence -> sigma tuple in (0,1]."""
    if raw in (None, "", "None"):
        return None
    value = raw
    if isinstance(value, str):
        import json

        stripped = value.strip()
        try:
            value = json.loads(stripped)
        except Exception:
            value = [seg for seg in stripped.replace(";", ",").split(",") if seg.strip()]
    try:
        floats = [float(v) for v in value]
    except (TypeError, ValueError) as exc:
        raise ValueError(f"unparseable flow_custom_timesteps {raw!r}") from exc
    floats = [v for v in floats if math.isfinite(v)]
    if not floats:
        return None
    if max(floats) > 1.0:  # timesteps in [0, 1000] -> sigmas
        floats = [min(max(v, 0.0), 1000.0) / 1000.0 for v in floats]
    return tuple(min(max(v, 0.0), 1.0) for v in floats)


def calculate_dynamic_shift_mu(
    seq_len,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
):
    """Resolution-dependent schedule shift mu."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return seq_len * m + b


def apply_schedule_shift(sigmas: torch.Tensor, shift) -> torch.Tensor:
    """Static shift: sigma <- s sigma / (1 + (s - 1) sigma)."""
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


def apply_schedule_shift_mu(sigmas: torch.Tensor, mu) -> torch.Tensor:
    """Dynamic (exp-mu) shift used with resolution-dependent mu."""
    return apply_schedule_shift(sigmas, torch.exp(torch.as_tensor(mu, dtype=torch.float32)))


def _process_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def sample_flow_sigmas(
    generator: torch.Generator,
    batch_size: int,
    config: FlowScheduleConfig = FlowScheduleConfig(),
    seq_len: Optional[int] = None,
    global_step: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Per-example flow-matching sigmas in (0, 1), f32 on ``device``.

    Default is the logit-normal ("sigmoid") density; alternatives: uniform
    and an explicit custom sigma list.  Optional static or resolution-dynamic
    schedule shift (not applied to custom lists).  The beta schedule raises:
    torch has no beta draw that takes a generator."""
    device = torch.device(device) if device is not None else generator.device

    def choice(values):
        # the table is filled on the device: no host-to-device copy, so a
        # captured step can draw from it
        table = torch.stack([torch.full((), v, dtype=torch.float32, device=device) for v in values])
        index = torch.randint(0, table.shape[0], (batch_size,), generator=generator, device=device)
        return table[index]

    if config.fast_schedule:
        return choice([1.0, 0.3, 0.2, 0.1])
    if config.custom_sigmas:
        if config.custom_mode == "round-robin":
            step = 0 if global_step is None else int(global_step)
            base = step * batch_size + _process_index() * batch_size
            index = [(base + i) % len(config.custom_sigmas) for i in range(batch_size)]
            return torch.tensor([config.custom_sigmas[i] for i in index], dtype=torch.float32, device=device)
        if config.custom_mode != "fixed-list":
            raise ValueError(
                f"flow_timesteps_mode must be 'fixed-list' or 'round-robin', got {config.custom_mode!r}"
            )
        return choice(list(config.custom_sigmas))
    if config.use_beta_schedule:
        raise NotImplementedError("flow_use_beta_schedule: torch has no generator-driven beta draw")
    if config.use_uniform_schedule:
        sigmas = torch.rand((batch_size,), generator=generator, device=device) * (1.0 - 2e-5) + 1e-5
    else:
        normal = torch.randn((batch_size,), generator=generator, device=device) * config.sigmoid_scale
        sigmas = torch.sigmoid(normal)
    if config.auto_shift and seq_len is not None:
        sigmas = apply_schedule_shift_mu(sigmas, calculate_dynamic_shift_mu(float(seq_len)))
    elif config.schedule_shift is not None and config.schedule_shift != 1.0:
        sigmas = apply_schedule_shift(sigmas, float(config.schedule_shift))
    return sigmas


def flow_interpolate(latents: torch.Tensor, noise: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """x_sigma = (1 - sigma) x0 + sigma eps (rectified-flow forward process)."""
    sigmas = sigmas.reshape(sigmas.shape[0], *([1] * (latents.dim() - 1)))
    return (1.0 - sigmas) * latents + sigmas * noise


def flow_target(latents: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Velocity target for rectified flow: eps - x0."""
    return noise - latents


@dataclasses.dataclass(frozen=True)
class LossConfig:
    loss_type: str = "l2"  # l2 | huber | smooth_l1
    huber_schedule: str = "snr"  # snr | exponential | constant
    huber_c: float = 0.1
    snr_gamma: Optional[float] = None
    soft_min_snr_gamma: Optional[float] = None
    use_soft_min_snr: bool = False
    soft_min_snr_sigma_data: float = 1.0
    prediction_type: str = "flow_matching"


def _pointwise_loss(pred: torch.Tensor, target: torch.Tensor, config: LossConfig, huber_c) -> torch.Tensor:
    diff = pred.float() - target.float()
    if config.loss_type == "l2":
        return diff.square()
    if config.loss_type == "huber":
        return 2.0 * huber_c * (torch.sqrt(diff.square() + huber_c ** 2) - huber_c)
    if config.loss_type == "smooth_l1":
        abs_diff = diff.abs()
        return torch.where(abs_diff < huber_c, 0.5 * diff.square() / huber_c, abs_diff - 0.5 * huber_c)
    raise ValueError(f"unknown loss type {config.loss_type}")


def _huber_c_for(config: LossConfig, timesteps: Optional[torch.Tensor], num_train_timesteps: int,
                 device) -> torch.Tensor:
    if config.loss_type == "l2" or config.huber_schedule == "constant" or timesteps is None:
        return torch.full((), config.huber_c, dtype=torch.float32, device=device)
    t_frac = timesteps.float() / max(num_train_timesteps - 1, 1)
    if config.huber_schedule == "exponential":
        return config.huber_c * torch.exp(-t_frac * 10.0)
    # "snr": interpolate between huber_c at t=0 and ~0 at t=max
    return config.huber_c * (1.0 - t_frac) + 1e-4


def diffusion_loss(
    model_pred: torch.Tensor,
    target: torch.Tensor,
    config: LossConfig,
    timesteps: Optional[torch.Tensor] = None,
    alphas_cumprod: Optional[torch.Tensor] = None,
    sigmas: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    loss_weight: Optional[torch.Tensor] = None,
    num_train_timesteps: int = 1000,
    elementwise_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scalar training loss with an optional pixel mask and per-sample weight.

    ``mask``: broadcastable to pred (1 = keep); ``loss_weight``: per-sample
    weight; ``elementwise_weight``: per-element multiplier before reduction.
    SNR weighting applies only to epsilon/v-prediction with DDPM timesteps,
    which are not ported: it raises when it would apply."""
    del sigmas  # the flow loss does not weight by sigma
    batch = model_pred.shape[0]
    huber_c = _huber_c_for(config, timesteps, num_train_timesteps, model_pred.device)
    if huber_c.dim():  # per-timestep schedule -> broadcast over spatial dims
        huber_c = huber_c.reshape(batch, *([1] * (model_pred.dim() - 1)))
    loss = _pointwise_loss(model_pred, target, config, huber_c)
    if elementwise_weight is not None:
        loss = loss * elementwise_weight.float()
    if mask is not None:
        mask = mask.float()
        loss = loss * mask
        denom = mask.reshape(batch, -1).sum(dim=-1) * (loss[0].numel() / mask[0].numel())
        per_example = loss.reshape(batch, -1).sum(dim=-1) / torch.clamp(denom, min=1.0)
    else:
        per_example = loss.reshape(batch, -1).mean(dim=-1)
    snr_weighted = config.snr_gamma is not None and config.prediction_type in ("epsilon", "v_prediction")
    soft_min = config.soft_min_snr_gamma is not None and timesteps is not None and alphas_cumprod is not None
    if snr_weighted or soft_min:
        raise NotImplementedError("SNR loss weighting (DDPM schedules) is not ported")
    if loss_weight is not None:
        per_example = per_example * loss_weight.float()
    return per_example.mean()
