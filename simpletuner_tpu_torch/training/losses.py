"""Diffusion loss math: flow-matching sigmas and DDPM schedules, targets, loss.

PyTorch counterpart of ``simpletuner_tpu/training/losses.py``: the flow half
(sigma sampling, schedule shifts, interpolation) and the DDPM half (the beta
ladders with the zero-SNR rescale, ``add_noise``, the v target, SNR and
soft-min SNR, the biased and windowed timestep weights and their draw), and
``diffusion_loss`` with its SNR, soft-min-SNR and Huber schedules.  Random
draws come from an explicit ``torch.Generator``; they are not JAX's numbers,
so parity is held on their distribution (the timestep weights themselves
against the JAX function) or through the ``override_noise`` /
``override_sigmas`` / ``override_timesteps`` batch hooks.  Every draw stays
on the device with no host sync, so a step captured as a CUDA graph draws
anew at each replay.
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


# ---------------------------------------------------------------------------------
# DDPM-style (epsilon / v-prediction) schedules
# ---------------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DDPMScheduleConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # linear | scaled_linear | squaredcos_cap_v2
    rescale_betas_zero_snr: bool = False


def make_alphas_cumprod(config: DDPMScheduleConfig, device=None) -> torch.Tensor:
    """The (num_train_timesteps,) f32 alpha-bar ladder, computed in f32 as
    the JAX function computes it."""
    steps = config.num_train_timesteps
    f32 = dict(dtype=torch.float32, device=device)
    if config.beta_schedule == "linear":
        betas = torch.linspace(config.beta_start, config.beta_end, steps, **f32)
    elif config.beta_schedule == "scaled_linear":
        betas = torch.linspace(config.beta_start ** 0.5, config.beta_end ** 0.5, steps, **f32) ** 2
    elif config.beta_schedule == "squaredcos_cap_v2":
        t = torch.arange(steps + 1, **f32) / steps
        f = torch.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        betas = torch.clamp(1.0 - f[1:] / f[:-1], 0.0, 0.999)
    else:
        raise ValueError(f"unknown beta schedule {config.beta_schedule}")
    alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
    if config.rescale_betas_zero_snr:
        # shift sqrt(alpha-bar) so the final step has zero SNR (Lin et al. 2023)
        sqrt_ac = torch.sqrt(alphas_cumprod)
        sqrt_ac = (sqrt_ac - sqrt_ac[-1]) * (sqrt_ac[0] / (sqrt_ac[0] - sqrt_ac[-1]))
        alphas_cumprod = sqrt_ac ** 2
    return alphas_cumprod


def _alpha_bar(timesteps: torch.Tensor, alphas_cumprod: torch.Tensor, ndim: int) -> torch.Tensor:
    return alphas_cumprod[timesteps.long()].reshape(timesteps.shape[0], *([1] * (ndim - 1)))


def add_noise(latents: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor,
              alphas_cumprod: torch.Tensor) -> torch.Tensor:
    """x_t = sqrt(alpha-bar_t) x0 + sqrt(1 - alpha-bar_t) eps."""
    ac = _alpha_bar(timesteps, alphas_cumprod, latents.dim())
    return torch.sqrt(ac) * latents + torch.sqrt(1.0 - ac) * noise


def velocity_target(latents: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor,
                    alphas_cumprod: torch.Tensor) -> torch.Tensor:
    """v = sqrt(alpha-bar_t) eps - sqrt(1 - alpha-bar_t) x0."""
    ac = _alpha_bar(timesteps, alphas_cumprod, latents.dim())
    return torch.sqrt(ac) * noise - torch.sqrt(1.0 - ac) * latents


def compute_snr(timesteps: torch.Tensor, alphas_cumprod: torch.Tensor) -> torch.Tensor:
    ac = alphas_cumprod[timesteps.long()]
    return ac / torch.clamp(1.0 - ac, min=1e-12)


def compute_soft_min_snr(timesteps: torch.Tensor, alphas_cumprod: torch.Tensor,
                         sigma_data: float = 1.0) -> torch.Tensor:
    """Soft-min SNR: (sigma sigma_d)^2 / (sigma^2 + sigma_d^2)^2 with sigma = sqrt(1 - alpha-bar_t)."""
    ac = alphas_cumprod[timesteps.long()]
    sigma_sq = torch.clamp(1.0 - ac, min=1e-12)
    sd_sq = float(sigma_data) ** 2
    return (sigma_sq * sd_sq) / torch.square(sigma_sq + sd_sq)


@dataclasses.dataclass(frozen=True)
class TimestepSamplingConfig:
    num_train_timesteps: int = 1000
    bias_strategy: str = "none"  # none | earlier | later | range
    bias_multiplier: float = 1.0
    bias_begin: int = 0
    bias_end: int = 1000
    bias_portion: float = 0.25
    # hard window: timesteps outside [range_begin, range_end) are never drawn
    # (the refiner's low-noise segment, or the inverted high-noise one)
    range_begin: int = 0
    range_end: int = 0  # 0 = no restriction


def timestep_weights(config: TimestepSamplingConfig, device=None) -> torch.Tensor:
    """Per-timestep sampling weights (f32, summing to 1): the hard window,
    then the bias strategy's multiplier on its span."""
    steps = config.num_train_timesteps
    idx = torch.arange(steps, device=device)
    weights = torch.ones((steps,), dtype=torch.float32, device=device)
    if config.range_end > config.range_begin:
        weights = torch.where((idx >= config.range_begin) & (idx < config.range_end), weights, 0.0)
    if config.bias_strategy == "none" or config.bias_multiplier == 1.0:
        return weights / weights.sum()
    num_biased = int(config.bias_portion * steps)
    if config.bias_strategy == "earlier":
        mask = idx < num_biased
    elif config.bias_strategy == "later":
        mask = idx >= steps - num_biased
    elif config.bias_strategy == "range":
        mask = (idx >= config.bias_begin) & (idx < config.bias_end)
    else:
        raise ValueError(f"unknown bias strategy {config.bias_strategy}")
    weights = torch.where(mask, weights * config.bias_multiplier, weights)
    return weights / weights.sum()


def sample_timesteps(generator: torch.Generator, batch_size: int, config: TimestepSamplingConfig,
                     device=None, cdf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(batch_size,) int64 timesteps drawn from ``timestep_weights``: the
    inverse CDF at a uniform draw, as ``jax.random.choice`` draws with ``p``
    (cumulative weights, ``searchsorted`` of total x (1 - u)).  ``cdf`` (the
    cumulative weights, on ``device``) may be given so a captured step makes
    no table; everything stays on the device."""
    device = torch.device(device) if device is not None else generator.device
    if cdf is None:
        cdf = torch.cumsum(timestep_weights(config, device=device), dim=0)
    u = torch.rand((batch_size,), generator=generator, device=device)
    index = torch.searchsorted(cdf, cdf[-1] * (1.0 - u))
    return torch.clamp(index, max=config.num_train_timesteps - 1)


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
    """Scalar training loss with SNR weighting and an optional pixel mask.

    ``mask``: broadcastable to pred (1 = keep); ``loss_weight``: per-sample
    weight; ``elementwise_weight``: per-element multiplier before reduction.
    ``snr_gamma`` (min-SNR, or the soft-min curve under ``use_soft_min_snr``)
    weights epsilon / v-prediction losses, ``soft_min_snr_gamma`` any loss
    given DDPM timesteps."""
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
    if config.snr_gamma is not None and config.prediction_type in ("epsilon", "v_prediction"):
        if timesteps is None or alphas_cumprod is None:
            raise ValueError("snr weighting requires timesteps and alphas_cumprod")
        if config.use_soft_min_snr:
            snr = compute_soft_min_snr(timesteps, alphas_cumprod, config.soft_min_snr_sigma_data)
        else:
            snr = compute_snr(timesteps, alphas_cumprod)
        if config.prediction_type == "v_prediction":
            snr_weight = torch.clamp(snr, max=config.snr_gamma) / torch.clamp(snr + 1.0, min=1e-8)
        else:
            snr_weight = torch.clamp(snr, max=config.snr_gamma) / torch.clamp(snr, min=1e-8)
        per_example = per_example * snr_weight
    elif config.soft_min_snr_gamma is not None and timesteps is not None and alphas_cumprod is not None:
        snr = compute_snr(timesteps, alphas_cumprod)
        gamma = config.soft_min_snr_gamma
        per_example = per_example * (gamma / (snr + gamma))
    if loss_weight is not None:
        per_example = per_example * loss_weight.float()
    return per_example.mean()
