"""Train state and the train step, LoRA mode.

PyTorch counterpart of ``simpletuner_tpu/training/train_state.py``: one step
does prepare -> forward -> loss -> grad -> global norm -> non-finite guard ->
clip + optimizer (``training/optimizers.py``) -> EMA.  The trainable adapters
are updated in place (the JAX step returns a new state with the same values).
The frozen base may be stored quantized (``quantize_mode``,
``training/quantization.py``).

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

The step runs eagerly, or as one CUDA graph (:func:`jit_train_step`, the
counterpart of the JAX ``jit_train_step`` with its donated state).  A graph
replays the numbers it captured, so the state holds its per-step numbers on
the device (:class:`DeviceScalars`): the step counter and the optimizer's
count as 0-dim tensors that the step advances itself, and the learning rates
in buffers that the host writes before each run.

Only ``model_type=lora`` is ported; full fine-tunes, ControlNet, teachers,
critics, text-encoder and sidecar training and CREPA raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from ..models.layers import freeze_base, quantize_module
from ..ops.flash_attention import flash_bwd_dkv_kernel, flash_bwd_dq_kernel, flash_fwd_kernel
from .ema import EMAConfig, ema_init, ema_update
from .optimizers import global_norm
from .quantization import dequantize_state_dict, int8_matmul

Tensors = Dict[str, torch.Tensor]
# the launch counters of the step's path; they count where a wrapper launches
# its kernel, so a graph's launches are counted once, at capture
LAUNCH_COUNTERS = (flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel, int8_matmul)
# eager steps jit_train_step runs before the capture (lazy initialisation of
# the libraries and kernels the step reaches); the state is restored after
WARMUP_STEPS = 2


@dataclasses.dataclass
class DeviceScalars:
    """The per-step numbers of a state, as 0-dim tensors on the adapters'
    device that a captured step reads.  ``step`` (int32) is the device
    counterpart of ``TrainState.step`` and the step advances it; ``opt_lr``
    (the optimizer's ``step_lr``) and ``metric_lr`` (``lr_schedule(step)``,
    f32) are written by the host before each run."""

    step: torch.Tensor
    opt_lr: torch.Tensor
    metric_lr: torch.Tensor


@dataclasses.dataclass
class TrainState:
    """``step`` (the host's step count) and the optimizer's count start at 0
    and advance together, one per step, so the host knows the count the
    learning rate is read at without reading the device."""

    step: int
    module: nn.Module  # the frozen base with the adapters in it
    trainable: Dict[str, nn.Parameter]  # the f32 adapters by JAX path
    opt_state: Any
    scalars: DeviceScalars
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
    device = next(iter(trainable.values())).device
    return TrainState(
        step=0,
        module=module,
        trainable=trainable,
        opt_state=tx.init(trainable),
        scalars=DeviceScalars(
            step=torch.zeros((), dtype=torch.int32, device=device),
            opt_lr=torch.zeros((), dtype=torch.float32, device=device),
            metric_lr=torch.zeros((), dtype=torch.float32, device=device),
        ),
        ema=ema_init(trainable) if ema_config is not None else None,
    )


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of the state that a step changes: the adapters, the
    optimizer state, the EMA and the device scalars, in a fixed order."""
    out: List[torch.Tensor] = []

    def walk(node) -> None:
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif dataclasses.is_dataclass(node):
            for field in dataclasses.fields(node):
                walk(getattr(node, field.name))
        elif isinstance(node, dict):
            for key in sorted(node):
                walk(node[key])

    for part in (state.trainable, state.opt_state, state.ema, state.scalars):
        walk(part)
    return out


class TrainStep:
    """``step(state, batch, generator) -> (state, metrics)``, made by
    :func:`build_train_step`.

    With ``grad_accum_steps`` > 1, batch tensors carry a leading micro-batch
    axis (A, B, ...); gradients are averaged over the A micro-steps.  Metrics
    are 0-dim tensors on the module's device, so a step makes no host sync.
    The learning rates are written into the state's buffers here before the
    step, except while a CUDA graph captures it (:func:`jit_train_step`
    writes them before each replay)."""

    def __init__(self, model, tx, lr_schedule: Optional[Callable[[int], float]] = None,
                 ema_config: Optional[EMAConfig] = None, grad_accum_steps: int = 1) -> None:
        self.model, self.tx, self.lr_schedule = model, tx, lr_schedule
        self.ema_config, self.grad_accum_steps = ema_config, grad_accum_steps

    def write_scalars(self, state: TrainState) -> None:
        """Write the learning rates of the coming step into the state's
        buffers (a fill each, no host-to-device copy); the optimizer's count
        is ``state.step``."""
        if callable(self.tx.learning_rate):
            state.scalars.opt_lr.fill_(self.tx.step_lr(state.step))
        if self.lr_schedule is not None:
            state.scalars.metric_lr.fill_(self.lr_schedule(state.step))

    def _value_and_grad(self, state: TrainState, micro_batch, generator):
        micro_batch = {**micro_batch, "global_step": state.step}
        loss, _ = self.model.loss_fn(state.module, generator, micro_batch)
        params = list(state.trainable.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), {
            key: torch.zeros_like(p) if g is None else g for (key, p), g in zip(state.trainable.items(), grads)
        }

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        scalars = state.scalars
        if not (scalars.step.is_cuda and torch.cuda.is_current_stream_capturing()):
            self.write_scalars(state)
        accum = self.grad_accum_steps
        if accum <= 1:
            loss, grads = self._value_and_grad(state, batch, generator)
        else:
            loss, grads = None, None
            for index in range(accum):
                micro = {k: v[index] if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
                micro_loss, micro_grads = self._value_and_grad(state, micro, generator)
                if grads is None:
                    loss, grads = micro_loss, micro_grads
                else:
                    loss = loss + micro_loss
                    grads = {k: grads[k] + g for k, g in micro_grads.items()}
            scale = 1.0 / accum
            grads = {k: g * scale for k, g in grads.items()}
            loss = loss * scale

        with torch.no_grad():
            grad_norm = global_norm(grads)
            finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
            safe_grads = {k: torch.where(finite, g, torch.zeros_like(g)) for k, g in grads.items()}
            updates, new_opt_state = self.tx.update(safe_grads, state.opt_state, state.trainable,
                                                    lr=scalars.opt_lr)
            for key, param in state.trainable.items():
                param.copy_(torch.where(finite, param + updates[key].to(param.dtype), param))
            new_scalars = dataclasses.replace(scalars, step=scalars.step + 1)
            new_ema = state.ema
            if state.ema is not None and self.ema_config is not None:
                new_ema = ema_update(self.ema_config, state.ema, state.trainable, new_scalars.step)

        metrics = {
            "loss": loss,
            "grad_norm": grad_norm,
            "skipped_nonfinite": 1.0 - finite.float(),
        }
        if self.lr_schedule is not None:
            metrics["lr"] = scalars.metric_lr.clone()
        new_state = dataclasses.replace(state, step=state.step + 1, opt_state=new_opt_state, ema=new_ema,
                                        scalars=new_scalars)
        return new_state, metrics


def build_train_step(
    model,
    tx,
    lr_schedule: Optional[Callable[[int], float]] = None,
    ema_config: Optional[EMAConfig] = None,
    grad_accum_steps: int = 1,
) -> TrainStep:
    """Returns ``step_fn(state, batch, generator) -> (state, metrics)``
    (:class:`TrainStep`)."""
    return TrainStep(model, tx, lr_schedule, ema_config, grad_accum_steps)


def step_in_place(step_fn: TrainStep, state: TrainState, batch: Dict, generator: torch.Generator) -> Dict:
    """One step whose new state is copied into ``state``'s own tensors (the
    body :func:`jit_train_step` captures, the donation of the JAX step);
    ``state.step`` is left to the caller.  Returns the metrics."""
    new_state, metrics = step_fn(state, batch, generator)
    _copy_into(state, new_state)
    return metrics


def _copy_into(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor at the same place in
    ``dst`` (the same structure): how a captured step writes its new state
    into the static one."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif dataclasses.is_dataclass(dst):
        for field in dataclasses.fields(dst):
            _copy_into(getattr(dst, field.name), getattr(src, field.name))
    elif isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError("the step changed the structure of its state")
        for key in dst:
            _copy_into(dst[key], src[key])


class GraphedTrainStep:
    """One train step captured as a CUDA graph; made by :func:`jit_train_step`.

    ``graphed(state, batch, generator) -> (state, metrics)``: ``state`` must be
    the one the graph owns (the state given to ``jit_train_step``, which every
    call returns) and ``generator`` the one registered with the graph.  A call
    copies the batch's tensors into the static batch, writes the learning
    rates and replays the graph; the metrics are copies, so they outlive the
    next call.  ``captured_launches`` holds the launches of each counted
    kernel that the capture recorded: every replay makes them again, but no
    wrapper runs then, so the launch counters do not move at a replay (the
    profiler reads a replay's launches on the card)."""

    def __init__(self, step_fn: TrainStep, state: TrainState, example_batch: Dict, generator: torch.Generator) -> None:
        schedule = step_fn.model.flow_schedule_config()
        if schedule.custom_sigmas and schedule.custom_mode == "round-robin":
            raise ValueError("flow_timesteps_mode=round-robin reads the step on the host, which a captured step "
                             "cannot; run it with the eager step")
        device = next(iter(state.trainable.values())).device
        if device.type != "cuda" or generator.device.type != "cuda":
            raise ValueError(f"jit_train_step captures a CUDA graph; the adapters are on {device} and the "
                             f"generator on {generator.device} (the eager step runs on the CPU)")
        self.step_fn, self.state, self.generator = step_fn, state, generator
        self.batch = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in example_batch.items()}
        for key, value in self.batch.items():
            if isinstance(value, torch.Tensor) and value.device != device:
                raise ValueError(f"batch[{key!r}] is on {value.device}, the adapters on {device}")

        # warm up on a side stream, then put the state and the generator back;
        # the capture runs on the same stream (a leaf's gradient accumulator
        # that outlives an iteration keeps the stream it was made on)
        with torch.no_grad():
            saved = [t.clone() for t in state_tensors(self.state)]
        saved_rng = generator.get_state()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._body()
        torch.cuda.current_stream(device).wait_stream(side)
        self._restore(saved, saved_rng)
        del saved

        before = [counter.launches for counter in LAUNCH_COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, stream=side):
            self.metrics = self._body()
        self.captured_launches = {counter: counter.launches - count
                                  for counter, count in zip(LAUNCH_COUNTERS, before)}

    def _body(self):
        return step_in_place(self.step_fn, self.state, self.batch, self.generator)

    def _restore(self, saved, rng_state) -> None:
        with torch.no_grad():
            for tensor, value in zip(state_tensors(self.state), saved):
                tensor.copy_(value)
        self.generator.set_state(rng_state)

    def __call__(self, state: TrainState, batch: Dict, generator: torch.Generator):
        if state is not self.state:
            raise ValueError("a graphed step takes the state it owns: the one given to jit_train_step, which "
                             "every call returns")
        if generator is not self.generator:
            raise ValueError("a graphed step draws from the generator registered at capture")
        if batch.keys() != self.batch.keys():
            raise ValueError(f"batch keys {sorted(batch)} differ from the captured {sorted(self.batch)}")
        for key, static in self.batch.items():
            value = batch[key]
            if isinstance(static, torch.Tensor):
                if value.shape != static.shape or value.dtype != static.dtype:
                    raise ValueError(f"batch[{key!r}] is {value.dtype}{tuple(value.shape)}, captured "
                                     f"{static.dtype}{tuple(static.shape)}")
                if value is not static:
                    static.copy_(value)
            elif value != static:
                raise ValueError(f"batch[{key!r}] = {value!r} differs from the captured {static!r}")
        self.step_fn.write_scalars(self.state)
        self.graph.replay()
        self.state.step += 1
        return self.state, {k: v.clone() for k, v in self.metrics.items()}


def jit_train_step(step_fn: TrainStep, state: TrainState, example_batch: Dict,
                   generator: torch.Generator) -> GraphedTrainStep:
    """The step as one CUDA graph: the counterpart of the JAX
    ``jit_train_step`` (train_state.py:350-364) on one device, with no mesh.

    Warms the step up on a side stream (state and generator restored
    afterwards) and captures one step with static batch, state and metric
    buffers; the static state is updated in place at every replay, as the
    JAX step donates it.  ``generator`` is
    registered with the graph, so each replay draws new noise and sigmas, the
    same numbers an eager step would.  The state, batch and generator must
    be on a CUDA device: there is no eager fallback, and a capture that fails
    raises."""
    return GraphedTrainStep(step_fn, state, example_batch, generator)
