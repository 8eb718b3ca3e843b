"""Learning-rate schedules as closed forms of the optimizer step.

PyTorch counterpart of ``simpletuner_tpu/training/schedules.py``: the same
nine schedules, with optax's semantics written out (``linear_schedule``,
``polynomial_schedule``, ``cosine_decay_schedule``, ``sgdr_schedule`` and
``join_schedules`` for the warmup).  A schedule maps the step count (a Python
int, the count *before* the update, as optax evaluates it) to a float.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import numpy as np

Schedule = Callable[[int], float]


def _get(config: Any, key: str, default=None):
    return config.get(key, default) if hasattr(config, "get") else getattr(config, key, default)


def _polynomial(init: float, end: float, power: float, steps: int) -> Schedule:
    """optax.polynomial_schedule (linear_schedule at power 1)."""

    def schedule(count: int) -> float:
        count = min(max(count, 0), steps)
        return (init - end) * (1 - count / steps) ** power + end

    return schedule


def _cosine_decay(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule."""

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay_steps)) + alpha)

    return schedule


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: schedule i runs from boundary i - 1, restarting its count."""

    def schedule(count: int) -> float:
        index = sum(1 for b in boundaries if count >= b)
        start = boundaries[index - 1] if index else 0
        return schedules[index](count - start)

    return schedule


def _with_warmup(schedule: Schedule, warmup_steps: int, peak_lr: float) -> Schedule:
    if warmup_steps <= 0:
        return schedule
    return _join([_polynomial(0.0, peak_lr, 1.0, warmup_steps), schedule], [warmup_steps])


def sine_schedule(peak_lr: float, total_steps: int, min_lr: float = 0.0) -> Schedule:
    """Full sine oscillation between min and peak."""

    def schedule(count: int) -> float:
        frac = min(max(count / max(total_steps, 1), 0.0), 1.0)
        return min_lr + (peak_lr - min_lr) * 0.5 * (1.0 + math.sin(2.0 * math.pi * frac - math.pi / 2.0))

    return schedule


def cosine_hard_restarts(peak_lr: float, total_steps: int, cycles: int, min_lr: float = 0.0) -> Schedule:
    """The cycle position is taken in f32 as in the JAX schedule, whose clip
    at 1 - 1e-9 rounds to 1: from ``total_steps`` on the schedule is at peak."""

    def schedule(count: int) -> float:
        frac = np.clip(np.float32(count) / np.float32(max(total_steps, 1)), 0.0, np.float32(1.0 - 1e-9))
        cycle_frac = float((frac * np.float32(cycles)) % np.float32(1.0))
        return min_lr + (peak_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * cycle_frac))

    return schedule


def _sgdr(peak: float, end: float, decay_steps: int, cycles: int) -> Schedule:
    """optax.sgdr_schedule of ``cycles`` warmup-free cosine decays from peak to end."""
    alpha = 0.0 if peak == 0.0 else end / peak
    cosine = [_cosine_decay(peak, decay_steps, alpha) for _ in range(cycles)]
    # each cycle is join([linear(peak, peak, 0), cosine], [0]) in optax
    boundaries = [decay_steps * (i + 1) for i in range(cycles - 1)]
    return _join(cosine, boundaries)


def get_lr_schedule(config: Any, total_steps: int) -> Schedule:
    name = (_get(config, "lr_scheduler") or "constant").lower()
    peak = float(_get(config, "learning_rate", 1e-4) or 1e-4)
    warmup = int(_get(config, "lr_warmup_steps", 0) or 0)
    end = float(_get(config, "lr_end", 1e-7) or 0.0)
    cycles = int(_get(config, "lr_num_cycles", 1) or 1)
    power = float(_get(config, "lr_power", 1.0) or 1.0)
    decay_steps = max(total_steps - warmup, 1)

    if name == "constant":
        return lambda count: peak
    if name == "constant_with_warmup":
        return _with_warmup(lambda count: peak, warmup, peak)
    if name == "linear":
        return _with_warmup(_polynomial(peak, end, 1.0, decay_steps), warmup, peak)
    if name == "polynomial":
        return _with_warmup(_polynomial(peak, end, power, decay_steps), warmup, peak)
    if name == "cosine":
        return _with_warmup(_cosine_decay(peak, decay_steps, end / peak if peak else 0.0), warmup, peak)
    if name == "cosine_with_restarts":
        cycle_steps = max(decay_steps // max(cycles, 1), 1)
        return _with_warmup(_sgdr(peak, end, cycle_steps, max(cycles, 1)), warmup, peak)
    if name == "cosine_annealing_hard_restarts":
        return _with_warmup(cosine_hard_restarts(peak, decay_steps, max(cycles, 1), end), warmup, peak)
    if name == "sine":
        return _with_warmup(sine_schedule(peak, decay_steps, end), warmup, peak)
    raise ValueError(f"unknown lr_scheduler {name!r}")
