"""Train state and the train step, LoRA mode.

PyTorch counterpart of ``simpletuner_tpu/training/train_state.py``: one step
does prepare -> forward -> loss -> grad -> global norm -> non-finite guard ->
clip + optimizer (``training/optimizers.py``) -> EMA.  PyTorch runs it
eagerly on the module's device; the trainable adapters are updated in place
(the JAX step returns a new state with the same values).  The frozen base
may be stored quantized (``quantize_mode``, ``training/quantization.py``).

Semantics kept from the JAX step (train_state.py:172-337):

* loss and gradients of the trainable tensors only (the base is frozen);
* gradient accumulation over a leading micro-batch axis, gradients and loss
  averaged;
* ``grad_norm`` is the global norm *before* clipping;
* a non-finite loss or norm zeroes the gradients, the optimizer state still
  advances on those zeros, and the trainable tensors keep their old values;
* metrics ``loss``, ``grad_norm``, ``skipped_nonfinite``, ``lr`` (the schedule
  at the step before the update);
* the EMA follows the update.

Only ``model_type=lora`` is ported; full fine-tunes, ControlNet, teachers,
critics, text-encoder and sidecar training and CREPA raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..models.layers import freeze_base, quantize_module
from .ema import EMAConfig, ema_init, ema_update
from .optimizers import global_norm
from .quantization import dequantize_state_dict

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    module: nn.Module  # the frozen base with the adapters in it
    trainable: Dict[str, nn.Parameter]  # the f32 adapters by JAX path
    opt_state: Any
    ema: Optional[Tensors] = None

    def state_dict(self, use_ema: bool = False, dtype: torch.dtype = torch.bfloat16) -> Tensors:
        """The module's weights for export, a quantized base dequantized to
        ``dtype`` and the adapters (or their EMA) as they are: the counterpart
        of ``TrainState.variables`` (train_state.py:32-38)."""
        state = dequantize_state_dict(self.module.state_dict(), dtype)
        if use_ema and self.ema is not None:
            state.update({path.replace("/", "."): value for path, value in self.ema.items()})
        return state


def create_train_state(
    model,
    module: nn.Module,
    tx,
    ema_config: Optional[EMAConfig] = None,
    quantize_mode: Optional[str] = None,
) -> TrainState:
    """Freeze the base of ``module`` and set up the optimizer (and EMA) over
    its adapters.  ``quantize_mode`` ("int8", "fp8", "int4": the resolved
    ``base_model_precision``) stores the frozen base quantized, in place and
    one layer at a time; the adapters stay f32."""
    model_type = getattr(model.config, "model_type", "lora")
    if quantize_mode and model.lora_rank <= 0:
        raise ValueError("base_model_precision quantization requires model_type=lora (frozen base)")
    if model_type != "lora":
        raise NotImplementedError(f"model_type={model_type!r}: only LoRA training is ported")
    trainable = freeze_base(module)
    if not trainable:
        raise ValueError("model_type=lora but the module has no adapters (check flux_lora_target)")
    if quantize_mode:
        quantize_module(module, quantize_mode)
    return TrainState(
        step=0,
        module=module,
        trainable=trainable,
        opt_state=tx.init(trainable),
        ema=ema_init(trainable) if ema_config is not None else None,
    )


def build_train_step(
    model,
    tx,
    lr_schedule: Optional[Callable[[int], float]] = None,
    ema_config: Optional[EMAConfig] = None,
    grad_accum_steps: int = 1,
) -> Callable:
    """Returns ``step_fn(state, batch, generator) -> (state, metrics)``.

    With ``grad_accum_steps`` > 1, batch tensors carry a leading micro-batch
    axis (A, B, ...); gradients are averaged over the A micro-steps.  Metrics
    are 0-dim tensors on the module's device, so a step makes no host sync."""

    def value_and_grad(state: TrainState, micro_batch, generator):
        micro_batch = {**micro_batch, "global_step": state.step}
        loss, _ = model.loss_fn(state.module, generator, micro_batch)
        params = list(state.trainable.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), {
            key: torch.zeros_like(p) if g is None else g for (key, p), g in zip(state.trainable.items(), grads)
        }

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        if grad_accum_steps <= 1:
            loss, grads = value_and_grad(state, batch, generator)
        else:
            loss, grads = None, None
            for index in range(grad_accum_steps):
                micro = {k: v[index] if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
                micro_loss, micro_grads = value_and_grad(state, micro, generator)
                if grads is None:
                    loss, grads = micro_loss, micro_grads
                else:
                    loss = loss + micro_loss
                    grads = {k: grads[k] + g for k, g in micro_grads.items()}
            scale = 1.0 / grad_accum_steps
            grads = {k: g * scale for k, g in grads.items()}
            loss = loss * scale

        with torch.no_grad():
            grad_norm = global_norm(grads)
            finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
            safe_grads = {k: torch.where(finite, g, torch.zeros_like(g)) for k, g in grads.items()}
            updates, new_opt_state = tx.update(safe_grads, state.opt_state, state.trainable)
            for key, param in state.trainable.items():
                param.copy_(torch.where(finite, param + updates[key].to(param.dtype), param))
            new_step = state.step + 1
            new_ema = state.ema
            if state.ema is not None and ema_config is not None:
                new_ema = ema_update(ema_config, state.ema, state.trainable, new_step)

        metrics = {
            "loss": loss,
            "grad_norm": grad_norm,
            "skipped_nonfinite": 1.0 - finite.float(),
        }
        if lr_schedule is not None:
            metrics["lr"] = torch.tensor(lr_schedule(state.step), dtype=torch.float32)
        new_state = dataclasses.replace(state, step=new_step, opt_state=new_opt_state, ema=new_ema)
        return new_state, metrics

    return step_fn
