"""Optimizer factory: gradient clipping and AdamW with optax's semantics.

PyTorch counterpart of the ``adamw`` entries of
``simpletuner_tpu/training/optimizers.py``.  ``torch.optim.AdamW`` and
``torch.nn.utils.clip_grad_norm_`` differ from ``optax.adamw`` and
``optax.clip_by_global_norm`` in small ways (torch's clip divides by
``norm + 1e-6`` and always rescales; torch decays the weights in a separate
multiply before the step; optax evaluates the learning-rate schedule at the
count before the update), so the port writes the optax formulas out:

    g <- g                       if |g| < max_norm else g / |g| * max_norm
    mu <- (1 - b1) g + b1 mu;    nu <- (1 - b2) g^2 + b2 nu;   n <- n + 1
    u  <- (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps) + wd * p
    p  <- p - lr(n - 1) * u

Clipping comes before AdamW, as in the JAX chain (optimizers.py:663-675).
Every other optimizer name raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

Tensors = Dict[str, torch.Tensor]

ADAMW_NAMES = ("adamw", "torch-adamw", "optimi-adamw", "bnb-adamw", "bnb-adamw-paged")


def _get(config: Any, key: str, default=None):
    return config.get(key, default) if hasattr(config, "get") else getattr(config, key, default)


def _adam_kwargs(config: Any) -> Dict[str, float]:
    return dict(
        b1=_get(config, "optimizer_beta1") or _get(config, "adam_beta1", 0.9) or 0.9,
        b2=_get(config, "optimizer_beta2") or _get(config, "adam_beta2", 0.999) or 0.999,
        eps=_get(config, "adam_epsilon", 1e-8) or 1e-8,
    )


def _weight_decay(config: Any, default: float = 1e-2) -> float:
    wd = _get(config, "adam_weight_decay", default)
    return default if wd is None else wd


def parse_optimizer_config(raw: Optional[str]) -> Dict[str, Any]:
    """Parse the reference's ``--optimizer_config`` 'k=v,k=v' override string."""
    if not raw:
        return {}
    out: Dict[str, Any] = {}
    for pair in str(raw).split(","):
        if "=" not in pair:
            continue
        key, value = pair.split("=", 1)
        key, value = key.strip(), value.strip()
        try:
            out[key] = float(value) if "." in value or "e" in value.lower() else int(value)
        except ValueError:
            out[key] = value
    return out


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``), f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors.values()))


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: Tensors
    nu: Tensors


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``clip_by_global_norm(max_norm)`` (when ``max_norm`` > 0) then ``optax.adamw``."""

    learning_rate: Union[float, Callable[[int], float]]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-2
    max_norm: float = 0.0

    def init(self, params: Tensors) -> AdamWState:
        return AdamWState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        )

    def lr(self, count: int) -> float:
        return self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdamWState, params: Tensors):
        """(updates, new state); ``params + updates`` is the stepped tree."""
        grads = {k: g.float() for k, g in grads.items()}
        if self.max_norm and self.max_norm > 0:
            norm = global_norm(grads)
            keep = norm < self.max_norm
            grads = {k: torch.where(keep, g, g / norm * self.max_norm) for k, g in grads.items()}
        count = state.count + 1
        dev = next(iter(grads.values())).device if grads else None
        step = torch.tensor(count, dtype=torch.float32, device=dev)
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32, device=dev) ** step
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32, device=dev) ** step
        lr = self.lr(state.count)
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - self.b1) * g + self.b1 * state.mu[k]
            nu[k] = (1 - self.b2) * g.square() + self.b2 * state.nu[k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            u = u + self.weight_decay * params[k].float()
            updates[k] = -lr * u
        return updates, AdamWState(count=count, mu=mu, nu=nu)


def get_optimizer(config: Any, learning_rate: Union[float, Callable[[int], float]]) -> AdamW:
    """The optimizer chain of the JAX package's ``get_optimizer``, for the
    AdamW names: global-norm clip at ``max_grad_norm`` (when > 0) then AdamW
    with ``optimizer_config`` overrides of b1/b2/eps/weight_decay."""
    name = (_get(config, "optimizer") or "adamw").lower()
    if name not in ADAMW_NAMES:
        raise NotImplementedError(f"optimizer {name!r} is not ported (only {ADAMW_NAMES})")
    method = _get(config, "grad_clip_method", "norm") or "norm"
    if method != "norm":
        raise NotImplementedError(f"grad_clip_method={method!r} is not ported (only 'norm')")
    if _get(config, "train_text_encoder") or _get(config, "lyrics_embedder_train"):
        raise NotImplementedError("sidecar optimizer groups (text encoder, lyrics embedder) are not ported")
    overrides = parse_optimizer_config(_get(config, "optimizer_config"))
    kw = {**_adam_kwargs(config), **{k: v for k, v in overrides.items() if k in ("b1", "b2", "eps")}}
    max_norm = _get(config, "max_grad_norm", 1.0)
    return AdamW(
        learning_rate,
        weight_decay=overrides.get("weight_decay", _weight_decay(config)),
        max_norm=float(max_norm) if max_norm and max_norm > 0 else 0.0,
        **kw,
    )
