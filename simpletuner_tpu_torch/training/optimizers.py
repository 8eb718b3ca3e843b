"""Optimizer factory: gradient clipping and the AdamW family with optax's semantics.

PyTorch counterpart of ``simpletuner_tpu/training/optimizers.py`` for the
names a LoRA run on a quantized base uses: AdamW (and plain Adam), the
Kahan-compensated ``adamw_bf16`` (the registry default), and the
block-quantized 8-bit / 4-bit / fp8 AdamW and 8-bit Lion of
``training/optim_quant.py``.  ``torch.optim.AdamW`` and
``torch.nn.utils.clip_grad_norm_`` differ from ``optax.adamw`` and
``optax.clip_by_global_norm`` in small ways (torch's clip divides by
``norm + 1e-6`` and always rescales; torch decays the weights in a separate
multiply before the step; optax evaluates the learning-rate schedule at the
count before the update), so the port writes the optax formulas out:

    g <- g                       if |g| < max_norm else g / |g| * max_norm
    mu <- (1 - b1) g + b1 mu;    nu <- (1 - b2) g^2 + b2 nu;   n <- n + 1
    u  <- (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps) + wd * p
    p  <- p - lr(n - 1) * u

Clipping comes before the optimizer, as in the JAX chain (optimizers.py:663-675).
Every other optimizer name raises.

A state's ``count`` is a 0-dim int32 tensor on the parameters' device, so a
step captured as a CUDA graph (``training/train_state.py::jit_train_step``)
advances it itself; the bias corrections come from it on the device.  The
train step writes the scheduled learning rate ``step_lr(count)`` into a 0-dim
f32 buffer before each step and passes it as ``update(..., lr=)``; without
the buffer the schedule is read here from the count (a host sync).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

Tensors = Dict[str, torch.Tensor]
Schedule = Union[float, Callable[[int], float]]

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


def zero_count(params: Tensors) -> torch.Tensor:
    """A state's count at init: 0 as a 0-dim int32 tensor on the parameters' device."""
    return torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device if params else None)


def bias_corrections(count: torch.Tensor, b1: float, b2: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``1 - b1^count`` and ``1 - b2^count`` in f32, as optax computes them.
    Every value is made on the count's device (no host-to-device copy), so a
    captured step can run it."""
    step = count.to(torch.float32)
    beta = lambda b: torch.full((), b, dtype=torch.float32, device=count.device)  # noqa: E731
    return 1 - beta(b1) ** step, 1 - beta(b2) ** step


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``clip_by_global_norm(max_norm)`` (when ``max_norm`` > 0), then the
    optimizer's own update (``_update``).  ``update`` returns (updates, new
    state); ``params + updates`` is the stepped tree."""

    learning_rate: Schedule
    max_norm: float = 0.0

    def lr(self, count: int) -> float:
        return self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate

    def step_lr(self, count: int) -> float:
        """The learning rate of the update from a state at ``count``: the
        schedule at the count before the update, as optax reads it."""
        return self.lr(count)

    def _lr(self, count: torch.Tensor, lr: Optional[torch.Tensor]):
        """The learning rate ``_update`` applies: the constant, else ``lr``
        (the caller's f32 buffer holding ``step_lr(count)``), else the
        schedule read here from the count, as an f32 tensor (a schedule's
        value is an f32 array in JAX)."""
        if not callable(self.learning_rate):
            return self.learning_rate
        if lr is not None:
            return lr
        return torch.full((), self.step_lr(int(count)), dtype=torch.float32, device=count.device)

    def init(self, params: Tensors):
        raise NotImplementedError

    def _update(self, grads: Tensors, state, params: Tensors, lr: Optional[torch.Tensor]):
        raise NotImplementedError

    @torch.no_grad()
    def update(self, grads: Tensors, state, params: Tensors, lr: Optional[torch.Tensor] = None):
        """(updates, new state); ``lr``: a 0-dim f32 tensor holding
        ``step_lr(count)``, read in place of the schedule (see the module
        docstring)."""
        grads = {k: g.float() for k, g in grads.items()}
        if self.max_norm and self.max_norm > 0:
            norm = global_norm(grads)
            keep = norm < self.max_norm
            grads = {k: torch.where(keep, g, g / norm * self.max_norm) for k, g in grads.items()}
        return self._update(grads, state, params, lr)


@dataclasses.dataclass
class AdamWState:
    count: torch.Tensor
    mu: Tensors
    nu: Tensors


@dataclasses.dataclass(frozen=True)
class AdamW(Optimizer):
    """``optax.adamw``; with ``weight_decay=0`` it is ``optax.adam`` (the
    decay term adds ``0 * p``)."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-2

    def init(self, params: Tensors) -> AdamWState:
        return AdamWState(
            count=zero_count(params),
            mu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        )

    def _update(self, grads: Tensors, state: AdamWState, params: Tensors, lr: Optional[torch.Tensor]):
        count = state.count + 1
        bc1, bc2 = bias_corrections(count, self.b1, self.b2)
        neg_lr = -self._lr(state.count, lr)  # once: a tensor lr would negate per tensor
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - self.b1) * g + self.b1 * state.mu[k]
            nu[k] = (1 - self.b2) * g.square() + self.b2 * state.nu[k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            u = u + self.weight_decay * params[k].float()
            updates[k] = neg_lr * u
        return updates, AdamWState(count=count, mu=mu, nu=nu)


@dataclasses.dataclass
class KahanAdamWState:
    count: torch.Tensor
    mu: Tensors
    nu: Tensors
    compensation: Tensors


@dataclasses.dataclass(frozen=True)
class KahanAdamW(Optimizer):
    """``kahan_adamw`` (``adamw_bf16``, optimizers.py:27-81): AdamW whose step
    is added to the parameter with Kahan compensation in the parameter's
    dtype; moments and compensation take the parameter's dtype.  As in the
    JAX function the schedule is read at the count *after* the increment,
    and the learning rate scales the decay term itself."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-2

    def init(self, params: Tensors) -> KahanAdamWState:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        return KahanAdamWState(count=zero_count(params), mu=zeros(), nu=zeros(), compensation=zeros())

    def step_lr(self, count: int) -> float:
        return self.lr(count + 1)

    def _update(self, grads: Tensors, state: KahanAdamWState, params: Tensors, lr: Optional[torch.Tensor]):
        count = state.count + 1
        bc1, bc2 = bias_corrections(count, self.b1, self.b2)
        lr = self._lr(state.count, lr)
        mu, nu, comp, updates = {}, {}, {}, {}
        for k, g in grads.items():
            p, m, n = params[k], state.mu[k], state.nu[k]
            mf = m.float() * self.b1 + g * (1.0 - self.b1)
            nf = n.float() * self.b2 + g.square() * (1.0 - self.b2)
            step = lr * (mf / bc1) / (torch.sqrt(nf / bc2) + self.eps)
            step = step + lr * self.weight_decay * p.float()
            delta = (-step).to(p.dtype) + state.compensation[k]
            new_p = p + delta
            comp[k] = delta - (new_p - p)  # the low-order bits the add lost
            updates[k] = new_p - p
            mu[k], nu[k] = mf.to(m.dtype), nf.to(n.dtype)
        return updates, KahanAdamWState(count=count, mu=mu, nu=nu, compensation=comp)


def _adamw(lr, config, overrides, max_norm):
    kw = {**_adam_kwargs(config), **{k: v for k, v in overrides.items() if k in ("b1", "b2", "eps")}}
    return AdamW(lr, max_norm, weight_decay=overrides.get("weight_decay", _weight_decay(config)), **kw)


def _adam(lr, config, overrides, max_norm):
    return AdamW(lr, max_norm, weight_decay=0.0, **_adam_kwargs(config))


def _adamw_bf16(lr, config, overrides, max_norm):
    return KahanAdamW(lr, max_norm, weight_decay=overrides.get("weight_decay", _weight_decay(config)),
                      **_adam_kwargs(config))


def _adamw_quantized(state: str, lr, config, overrides, max_norm):
    from .optim_quant import INT4_PACKED, AdamWQuantized

    state_dtype = {"int8": torch.int8, "int4": INT4_PACKED, "fp8": torch.float8_e4m3fn}[state]
    return AdamWQuantized(lr, max_norm, weight_decay=overrides.get("weight_decay", _weight_decay(config)),
                          state_dtype=state_dtype, **_adam_kwargs(config))


def _lion_8bit(lr, config, overrides, max_norm):
    from .optim_quant import LionQuantized

    return LionQuantized(lr, max_norm, b1=overrides.get("b1", 0.9), b2=overrides.get("b2", 0.99),
                         weight_decay=overrides.get("weight_decay", _weight_decay(config)))


# name -> factory(learning_rate, config, overrides, max_norm), as the JAX registry
# (optimizers.py:128-197).  JAX registers "bnb-adam8bit" twice (:169, 8-bit
# state, and :195, plain Adam); the later registration wins there, so here too
# it is plain Adam.
OPTIMIZERS: Dict[str, Callable] = {
    **dict.fromkeys(ADAMW_NAMES, _adamw),
    **dict.fromkeys(("ao-adamw8bit", "bnb-adamw8bit", "bnb-adamw8bit-paged"),
                    functools.partial(_adamw_quantized, "int8")),
    "ao-adamw4bit": functools.partial(_adamw_quantized, "int4"),
    **dict.fromkeys(("ao-adamfp8", "ao-adamwfp8"), functools.partial(_adamw_quantized, "fp8")),
    **dict.fromkeys(("bnb-lion8bit", "bnb-lion8bit-paged"), _lion_8bit),
    "adamw_bf16": _adamw_bf16,
    **dict.fromkeys(("adam", "torch-adam", "optimi-adam", "bnb-adam", "bnb-adam8bit"), _adam),
}


def get_optimizer(config: Any, learning_rate: Schedule) -> Optimizer:
    """The optimizer chain of the JAX package's ``get_optimizer`` for the
    ported names: global-norm clip at ``max_grad_norm`` (when > 0), then the
    named optimizer with its ``optimizer_config`` overrides."""
    name = (_get(config, "optimizer") or "adamw").lower()
    if name not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer {name!r} is not ported (only {sorted(OPTIMIZERS)})")
    method = _get(config, "grad_clip_method", "norm") or "norm"
    if method != "norm":
        raise NotImplementedError(f"grad_clip_method={method!r} is not ported (only 'norm')")
    if _get(config, "train_text_encoder") or _get(config, "lyrics_embedder_train"):
        raise NotImplementedError("sidecar optimizer groups (text encoder, lyrics embedder) are not ported")
    overrides = parse_optimizer_config(_get(config, "optimizer_config"))
    max_norm = _get(config, "max_grad_norm", 1.0)
    return OPTIMIZERS[name](learning_rate, config, overrides, float(max_norm) if max_norm and max_norm > 0 else 0.0)
