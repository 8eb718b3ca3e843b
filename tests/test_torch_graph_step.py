"""The torch port's capturable train step, on the CPU.

``jit_train_step`` captures the step as one CUDA graph, which replays the
numbers it captured; so the state keeps its per-step numbers on the device
(the optimizer's count, the step, the learning rates).  A CUDA graph cannot
be captured here, so these tests hold what it captures: every registered
optimizer with its tensor count and the learning rate from a buffer against
the same optimizer reading its schedule on the host from the count
(bitwise) and against the JAX optimizer, the EMA with a tensor step against
the JAX EMA, and the body ``jit_train_step`` captures (the step written into
the state's own tensors, run eagerly) against the eager step (bitwise) and
the JAX step.  Also what refuses: a CPU state and the round-robin sigma
list.  Graph replays against eager steps run on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 12).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpletuner_tpu.configuration import TrainingConfig
from simpletuner_tpu.training import ema as jema
from simpletuner_tpu.training import optim_quant as jo
from simpletuner_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from simpletuner_tpu.training.schedules import get_lr_schedule as jax_get_lr_schedule
from simpletuner_tpu.training.train_state import build_train_step as jax_build_train_step
from simpletuner_tpu.training.train_state import create_train_state as jax_create_train_state

from simpletuner_tpu_torch.bench import METRIC, result_line
from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models.flux import Flux
from simpletuner_tpu_torch.models.weight_bridge import lora_to_flax
from simpletuner_tpu_torch.training import ema as tema
from simpletuner_tpu_torch.training import optim_quant as to
from simpletuner_tpu_torch.training.optimizers import OPTIMIZERS, get_optimizer
from simpletuner_tpu_torch.training.schedules import get_lr_schedule
from simpletuner_tpu_torch.training.train_state import (
    build_train_step, create_train_state, jit_train_step, state_tensors, step_in_place,
)

from test_torch_optim_quant import LEAVES, _assert_codes_agree, _assert_params, _state, _tree
from test_torch_train_step import STEPS, TRAIN_CONFIG, _flat_lora, _restore_jax_lora_target, _step_batch, pair  # noqa: F401
from torch_parity import rel, t

# ---- optimizers: a device count and learning rate -----------------------------------------------------

OPT_STEPS = 10
# the bound each optimizer is held to against the JAX one in
# test_torch_optim_quant.py / test_torch_train_step.py (relative to how far
# the parameters moved): f32 formulas agree to f32 sum orders; a quantized
# moment one code apart moves later steps by about 1e-4
JAX_BOUND = {"adamw_bf16": 1e-5, "quantized": 5e-3, "lion": 5e-3, "adamw": 1e-5}


def _kind(tx):
    if isinstance(tx, to.LionQuantized):
        return "lion"
    if isinstance(tx, to.AdamWQuantized):
        return "quantized"
    return "adamw_bf16" if type(tx).__name__ == "KahanAdamW" else "adamw"


def _flat_state(state):
    """Every tensor of an optimizer state (the count included), in field order."""
    out = []
    for field in dataclasses.fields(state):
        value = getattr(state, field.name)
        out.extend(value[k] for k in sorted(value)) if isinstance(value, dict) else out.append(value)
    return out


@pytest.mark.parametrize("scheduled", [True, False], ids=["schedule", "constant"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_device_count_optimizer_is_bitwise_its_python_count_form(name, scheduled):
    config = {"optimizer": name, "learning_rate": 3e-3, "max_grad_norm": 1.0, "adam_weight_decay": 0.05,
              "lr_scheduler": "linear", "lr_warmup_steps": 3}
    lr_t = get_lr_schedule(config, OPT_STEPS) if scheduled else 3e-3
    lr_j = jax_get_lr_schedule(config, OPT_STEPS) if scheduled else 3e-3
    tx, tx_j = get_optimizer(config, lr_t), jax_get_optimizer(config, lr_j)
    rng = np.random.default_rng(5)
    params = _tree(rng, 0.1)  # Flax layouts; the port holds the transposes
    p_host = {k: torch.from_numpy(v.T.copy()) for k, v in params.items()}
    p_dev = {k: v.clone() for k, v in p_host.items()}
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    # "host": the schedule read from the count in the update; "dev": read from
    # the buffer the train step fills, as a graph replay reads it
    s_host, s_dev, s_j = tx.init(p_host), tx.init(p_dev), tx_j.init(p_j)
    lr_buffer = torch.zeros((), dtype=torch.float32)
    for step in range(OPT_STEPS):
        grads = _tree(rng, [0.02, 2.0][step % 3 == 2])  # the clip triggers every third step
        u_host, s_host = tx.update({k: torch.from_numpy(v.T.copy()) for k, v in grads.items()}, s_host, p_host)
        lr_buffer.fill_(tx.step_lr(step))  # what the host writes before a replay
        u_dev, s_dev = tx.update({k: torch.from_numpy(v.T.copy()) for k, v in grads.items()}, s_dev, p_dev,
                                 lr=lr_buffer)
        u_j, s_j = tx_j.update({k: jnp.asarray(v) for k, v in grads.items()}, s_j, p_j)
        p_host = {k: p_host[k] + u_host[k] for k in p_host}
        p_dev = {k: p_dev[k] + u_dev[k] for k in p_dev}
        p_j = {k: p_j[k] + u_j[k] for k in p_j}
    assert isinstance(s_dev.count, torch.Tensor) and s_dev.count.dtype == torch.int32
    assert int(s_dev.count) == int(s_host.count) == OPT_STEPS
    for k in p_host:
        assert torch.equal(p_dev[k], p_host[k]), k
    for got, ref in zip(_flat_state(s_dev), _flat_state(s_host)):
        assert torch.equal(got.view(torch.uint8) if got.dtype == torch.float8_e4m3fn else got,
                           ref.view(torch.uint8) if ref.dtype == torch.float8_e4m3fn else ref)
    # the device form against the JAX optimizer, as test_torch_optim_quant.py holds it
    kind = _kind(tx)
    moved = {k: np.asarray(p_j[k]) - params[k] for k in params}
    _assert_params(p_dev, p_j, moved, JAX_BOUND[kind])
    if kind == "quantized":
        adam = _state(s_j, jo.QuantizedAdamState)
        state_name = {torch.int8: "int8", to.INT4_PACKED: "int4", torch.float8_e4m3fn: "fp8"}[tx.state_dtype]
        for k, shape in LEAVES.items():
            if np.prod(shape) >= 4096:
                _assert_codes_agree(s_dev.mu_q[k], adam.mu_q[k], state_name, k)
                _assert_codes_agree(s_dev.nu_q[k], adam.nu_q[k], "uint4" if state_name == "int4" else state_name, k)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_count_is_a_zero_dim_int32_tensor(name):
    # the count a captured step advances on the device: made at init on the
    # parameters' device, one more per update, never a Python number
    tx = get_optimizer({"optimizer": name}, lambda count: 1e-3 / (1 + count))
    params = {"w": torch.zeros(80, 64)}
    state = tx.init(params)
    assert state.count.shape == () and state.count.dtype == torch.int32 and int(state.count) == 0
    for step in range(3):
        _, state = tx.update({"w": torch.ones(80, 64)}, state, params)
        assert state.count.dtype == torch.int32 and int(state.count) == step + 1


# ---- EMA with a device step ----------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_kw", [{}, {"use_warmup": False, "decay": 0.9}, {"update_interval": 2}],
                         ids=["warmup", "constant", "interval"])
def test_ema_with_a_device_step_matches_jax(cfg_kw):
    rng = np.random.default_rng(2)
    params = _tree(rng, 1.0)
    e_j = jema.ema_init({k: jnp.asarray(v) for k, v in params.items()})
    e_dev = tema.ema_init({k: t(v) for k, v in params.items()})
    e_host = tema.ema_init({k: t(v) for k, v in params.items()})
    for step in range(1, 8):
        new = _tree(rng, 1.0)
        e_j = jema.ema_update(jema.EMAConfig(**cfg_kw), e_j, {k: jnp.asarray(v) for k, v in new.items()},
                              jnp.int32(step))
        e_dev = tema.ema_update(tema.EMAConfig(**cfg_kw), e_dev, {k: t(v) for k, v in new.items()},
                                torch.full((), step, dtype=torch.int32))
        e_host = tema.ema_update(tema.EMAConfig(**cfg_kw), e_host, {k: t(v) for k, v in new.items()}, step)
        for k in params:
            # f32 on both sides (the decay too); only XLA's and torch's pow differ
            np.testing.assert_allclose(e_dev[k].numpy(), np.asarray(e_j[k]), rtol=1e-6, atol=1e-7)
            assert torch.equal(e_dev[k], e_host[k])


# ---- the step on a state in device form ----------------------------------------------------------------

SCHEDULED = {**TRAIN_CONFIG, "lr_scheduler": "cosine", "lr_warmup_steps": 4}


def _port_run(pair, config, form, steps, ema=None):
    model = pair["model"]
    schedule = get_lr_schedule(config_namespace(config), steps)
    tx = get_optimizer(config_namespace(config), schedule)
    state = create_train_state(model, pair["make_module"](), tx, ema_config=ema)
    step = build_train_step(model, tx, schedule, ema_config=ema)
    metrics = []
    for index in range(steps):
        batch = _step_batch(pair, index, "torch")
        if form == "static_scalars":  # the body jit_train_step captures
            tensors = [id(x) for x in state_tensors(state)]
            m = step_in_place(step, state, batch, torch.Generator())
            state.step += 1
            assert [id(x) for x in state_tensors(state)] == tensors  # updated in place
        else:
            state, m = step(state, batch, torch.Generator())
        metrics.append(m)
    return state, metrics


@pytest.mark.parametrize("form", ["eager", "static_scalars"])
def test_lora_trajectory_tracks_jax(pair, form):
    jax_model = pair["jax_model"]
    jax_model.apply_trace_globals()
    config = TrainingConfig(SCHEDULED)
    schedule_j = jax_get_lr_schedule(config, STEPS)
    tx_j = jax_get_optimizer(config, schedule_j)
    state_j = jax_create_train_state(jax_model, jax.tree_util.tree_map(jnp.asarray, pair["variables"]), tx_j)
    step_j = jax.jit(jax_build_train_step(jax_model, tx_j, schedule_j))
    ours, theirs = [], []
    for step in range(STEPS):
        state_j, m_j = step_j(state_j, _step_batch(pair, step, "jax"), jax.random.PRNGKey(step))
        theirs.append((float(m_j["loss"]), float(m_j["grad_norm"]), float(m_j["lr"])))
    state_t, metrics = _port_run(pair, SCHEDULED, form, STEPS)
    ours = [(float(m["loss"]), float(m["grad_norm"]), float(m["lr"])) for m in metrics]
    # the schedule's warm-up and decay reach the step: lr moves every step
    assert len({lr for _, _, lr in ours}) == STEPS
    # f32 on both sides, the same math (test_torch_train_step.py's bounds;
    # the curves measured within 1e-6 of each other)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    assert state_t.step == STEPS and int(state_t.opt_state.count) == int(state_t.scalars.step) == STEPS
    final_j, final_t = _flat_lora(state_j.trainable["lora"]), _flat_lora(lora_to_flax(state_t.module))
    assert set(final_j) == set(final_t)
    for key in final_j:
        assert rel(final_t[key], final_j[key]) < 1e-4, key


def test_static_scalar_step_is_bitwise_the_eager_step(pair):
    # what a graph replays against what the eager step computes: a schedule
    # that moves every step, the EMA, the metrics and every state tensor
    ema = tema.EMAConfig(decay=0.99, update_interval=2)
    steps = 8
    eager, m_eager = _port_run(pair, SCHEDULED, "eager", steps, ema)
    static, m_static = _port_run(pair, SCHEDULED, "static_scalars", steps, ema)
    for a, b in zip(m_eager, m_static):
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key].reshape(()), b[key].reshape(())), key
    assert static.step == eager.step == steps and int(static.scalars.step) == int(eager.scalars.step) == steps
    assert int(static.opt_state.count) == int(eager.opt_state.count) == steps
    for key, param in eager.trainable.items():
        assert torch.equal(static.trainable[key], param), key
        assert torch.equal(static.opt_state.mu[key], eager.opt_state.mu[key]), key
        assert torch.equal(static.opt_state.nu[key], eager.opt_state.nu[key]), key
        assert torch.equal(static.ema[key], eager.ema[key]), key
        assert not torch.equal(static.ema[key], param)  # the EMA lags the adapters


def test_state_tensors_cover_what_the_step_changes(pair):
    model = pair["model"]
    tx = get_optimizer(model.config, 1e-3)
    state = create_train_state(model, pair["make_module"](), tx, ema_config=tema.EMAConfig())
    tensors = state_tensors(state)
    n_lora = len(state.trainable)
    # adapters, count + mu + nu, EMA, step + two learning rates
    assert len(tensors) == n_lora + (1 + 2 * n_lora) + n_lora + 3
    assert len({id(x) for x in tensors}) == len(tensors)


# ---- what refuses ---------------------------------------------------------------------------------------


def test_jit_train_step_refuses_a_cpu_state(pair):
    model = pair["model"]
    tx = get_optimizer(model.config, 1e-3)
    state = create_train_state(model, pair["make_module"](), tx)
    step = build_train_step(model, tx)
    with pytest.raises(ValueError, match="CUDA graph"):
        jit_train_step(step, state, _step_batch(pair, 0, "torch"), torch.Generator())
    assert state.step == 0 and int(state.scalars.step) == 0 and int(state.opt_state.count) == 0  # nothing ran


def test_jit_train_step_refuses_round_robin_sigmas(pair):
    model = Flux(config_namespace({**TRAIN_CONFIG, "flow_custom_timesteps": "0.9,0.5,0.2",
                                   "flow_timesteps_mode": "round-robin"}))
    tx = get_optimizer(model.config, 1e-3)
    state = create_train_state(model, pair["make_module"](), tx)
    with pytest.raises(ValueError, match="round-robin"):
        jit_train_step(build_train_step(model, tx), state, _step_batch(pair, 0, "torch"), torch.Generator())


# ---- the bench's last line ------------------------------------------------------------------------------


def _row(mfu, median, quant, **extra):
    return {"s_per_step_median": median, "s_per_step": median * 1.01, "step_s": [median] * 3, "mfu_median": mfu,
            "peak_gib": 15.3, "quant": quant, "device": "NVIDIA H100 80GB HBM3", **extra}


def test_bench_last_line_is_one_json_object():
    import json

    int8 = _row(0.17, 1.3, "int8", quantized_matmul="full", remat_policy="attn",
                launches_per_step={"flash_fwd": 76.0, "flash_bwd_dq": 57.0, "flash_bwd_dkv": 57.0},
                int_mm_per_step=1069.0, profile={"idle_share_vs_median": 0.02, "idle_share_traced": 0.01,
                                                      "device_ms": 1270.0},
                eager={"s_per_step_median": 1.9, "profile": {"idle_share_vs_median": 0.33}})
    line = result_line(int8, _row(0.12, 1.8, "int4"), {**_row(0.4, 0.5, "none"), "batch": 4, "resolution": 512},
                       "NVIDIA H100 80GB HBM3, 700.00 W")
    parsed = json.loads(json.dumps(line))
    assert set(parsed) == {"metric", "value", "unit", "extra"}
    assert parsed["metric"] == METRIC and parsed["value"] == 0.17 and parsed["unit"].startswith("MFU")
    extra = parsed["extra"]
    assert extra["s_per_step_median"] == 1.3 and extra["eager_s_per_step_median"] == 1.9
    assert extra["idle_share"] == 0.02 and extra["peak_gib"] == 15.3 and extra["quant"] == "int8"
    assert extra["flagship_int4"]["mfu_median"] == 0.12 and extra["proxy_2p56b"]["batch"] == 4
    assert extra["card"].endswith("700.00 W")
