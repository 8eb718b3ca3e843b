"""The torch port's quantized frozen base against the JAX package, on the CPU.

The quantizers (int8, fp8, int4) on the tiny Flux tree, the weight bridge's
quantized layout both ways, ``int8_dynamic_dot`` forward and ``dx``, and tiny
Flux LoRA trajectories on int8 (``quantized_matmul=full``), int4 and fp8
bases against the JAX train step.  Inputs and weights come from numpy seeds;
the port's Linear weights are the transposes of the Flax kernels.
"""

import contextlib
import logging
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simpletuner_tpu.configuration import TrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.flux.model import Flux as JaxFlux
from simpletuner_tpu.training import quantization as jq
from simpletuner_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from simpletuner_tpu.training.schedules import get_lr_schedule as jax_get_lr_schedule
from simpletuner_tpu.training.train_state import build_train_step as jax_build_train_step
from simpletuner_tpu.training.train_state import create_train_state as jax_create_train_state

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.flux import Flux
from simpletuner_tpu_torch.models.weight_bridge import flax_variables, lora_to_flax
from simpletuner_tpu_torch.training import quantization as tq
from simpletuner_tpu_torch.training.optimizers import get_optimizer
from simpletuner_tpu_torch.training.schedules import get_lr_schedule
from simpletuner_tpu_torch.training.train_state import build_train_step, create_train_state

from torch_parity import bridge, fill_numpy, rel, t

MODES = ("int8", "fp8", "int4")


@pytest.fixture(autouse=True)
def _restore_jax_globals():
    """Building a JAX model family installs a process-wide LoRA target
    predicate and int8 matmul mode."""
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    yield
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])


def _config(**extra):
    return {"model_family": "flux", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _flat(tree):
    return {"/".join(getattr(k, "key", str(k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bits(a):
    """An array's bytes, so that fp8 and NaN compare by encoding."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint16)


@pytest.fixture(scope="module")
def tiny_tree():
    """The tiny Flux LoRA variables in numpy, and a port module factory."""
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jax_model = JaxFlux(TrainingConfig(_config()))
    shapes = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0)))
    variables = fill_numpy(shapes, seed=21)
    model = Flux(config_namespace(_config()))
    yield variables, lambda: bridge(variables, model.create_module())
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])


# ---- the quantizers and the bridge ------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_quantizers_match_quantize_params_on_the_flux_tree(tiny_tree, mode):
    variables, make_module = tiny_tree
    ref = jq.quantize_params({"params": variables["params"]}, mode)
    module = tl.quantize_module(make_module(), mode)
    port = flax_variables(module)
    ref_params, ref_scales = _flat(ref["params"]), _flat(ref["qscales"])
    port_params, port_scales = _flat(port["params"]), _flat(port["qscales"])
    assert set(port_params) == set(ref_params) and set(port_scales) == set(ref_scales)
    kernels = 0
    for name, value in {**ref_params, **ref_scales}.items():
        got = {**port_params, **port_scales}[name]
        assert got.dtype == value.dtype and got.shape == value.shape, name
        # values (int8), bytes (fp8), packed nibbles (int4) and f32 scales: identical
        assert np.array_equal(_bits(got), _bits(value)), name
        kernels += name.endswith(("kernel", "kernel_packed")) and value.dtype != np.float32
    assert kernels == sum(isinstance(m, tl.LoRADense) for m in module.modules())

    # the bridge carries the JAX tree into a port module quantized in the same mode
    loaded = bridge({**ref, "lora": variables["lora"]}, tl.quantize_module(make_module(), mode))
    for name, value in module.state_dict().items():
        assert torch.equal(loaded.state_dict()[name].view(torch.uint8) if value.dtype == torch.float8_e4m3fn
                           else loaded.state_dict()[name],
                           value.view(torch.uint8) if value.dtype == torch.float8_e4m3fn else value), name

    # export: the dequantized state dict is dequantize_params' tree
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        back = _flat(jq.dequantize_params(ref, jdtype)["params"])
        state = tq.dequantize_state_dict(module.state_dict(), dtype)
        plain = make_module()
        plain.load_state_dict(state)
        for name, value in _flat(flax_variables(plain)["params"]).items():
            if name.endswith("kernel"):
                np.testing.assert_array_equal(value, np.asarray(back[name], np.float32), err_msg=name)
    assert tq.has_quantized(module.state_dict()) and not tq.has_quantized(make_module().state_dict())


def test_quantize_dequantize_and_int4_unpack_match_jax():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((48, 20)) * 0.05).astype(np.float32)  # (in, out)
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-12 scale floor
    for mode in MODES:
        ref = jq.quantize_dequantize(w, mode)
        got = tq.quantize_dequantize(t(w.T), mode).numpy().T
        np.testing.assert_array_equal(got, ref.astype(np.float32), err_msg=mode)
    packed = jq.quantize_params({"params": {"m": {"kernel": jnp.asarray(w)}}}, "int4")["qscales"]["m"]
    port = tq.quantize_weight(t(w.T), "int4")
    np.testing.assert_array_equal(port["weight_packed"].numpy().T, np.asarray(packed["kernel_packed"]))
    np.testing.assert_array_equal(tq.unpack_int4_to_int8(port["weight_packed"]).numpy().T,
                                  np.asarray(jq.unpack_int4_to_int8(packed["kernel_packed"])))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tq.unpack_int4(port["weight_packed"], port["weight_scale"], dtype).float().numpy().T
        ref = np.asarray(jq.unpack_int4(packed["kernel_packed"], packed["kernel_scale"], jdtype), np.float32)
        np.testing.assert_array_equal(got, ref)
    # top/bottom halves of the input axis, not even/odd rows
    q = np.clip(np.round(w / np.maximum(np.abs(w).max(0) / 7, 1e-12)), -7, 7).astype(np.int32) + 8
    np.testing.assert_array_equal(port["weight_packed"].numpy().T, (q[:24] | (q[24:] << 4)).astype(np.uint8))
    with pytest.raises(ValueError, match="even input dim"):
        tq.quantize_weight(torch.ones(8, 63), "int4")
    with pytest.raises(ValueError):
        tq.quantize_weight(torch.ones(8, 64), "int2")


def test_precision_and_matmul_modes_resolve_as_jax(caplog):
    for raw in list(jq.PRECISION_ALIASES) + [None, ""]:
        config = config_namespace({"base_model_precision": raw})
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert tq.resolve_precision(config) == jq.resolve_precision(config), raw
        assert any("substituted" in r.message for r in caplog.records) == (raw in ("nf4-bnb", "int2-quanto"))
        for matmul in (None, "auto", "off", "forward", "full", True, False):
            config = config_namespace({"base_model_precision": raw, "quantized_matmul": matmul})
            assert tq.resolve_quantized_matmul(config) == jq.resolve_quantized_matmul(config), (raw, matmul)
    # an explicit False is "off", not "auto" (which is "full" on an int8 base)
    assert tq.resolve_quantized_matmul(config_namespace({"base_model_precision": "int8", "quantized_matmul": False})) \
        == "off"
    for bad in ({"base_model_precision": "int3"}, {"quantized_matmul": "int8-magic"}):
        with pytest.raises(ValueError):
            tq.resolve_quantized_matmul(config_namespace(bad))


# ---- int8_dynamic_dot -----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bwd", ["forward", "full"])
@pytest.mark.parametrize("rows", [1, 37])
def test_int8_dynamic_dot_matches_jax(dtype, bwd, rows):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((2, rows, 64)).astype(np.float32) * np.linspace(0.1, 3.0, rows)[None, :, None]
    x[0, 0] = 0.0  # an all-zero row takes the 1e-12 scale floor
    dy = rng.standard_normal((2, rows, 40)).astype(np.float32)
    w = (rng.standard_normal((64, 40)) * 0.05).astype(np.float32)
    packed = jq.quantize_params({"params": {"m": {"kernel": jnp.asarray(w)}}}, "int8")
    w_q, w_s = packed["params"]["m"]["kernel"], packed["qscales"]["m"]["kernel_scale"]
    full = bwd == "full"

    x_j, dy_j = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    y_j, vjp = jax.vjp(lambda a: jq.int8_dynamic_dot(a, w_q, w_s, full), x_j)
    (dx_j,) = vjp(dy_j)

    w_qt, w_st = t(np.asarray(w_q).T), t(np.asarray(w_s))
    x_t = torch.from_numpy(np.asarray(x_j.astype(jnp.float32))).to(tdt).requires_grad_(True)
    y_t = tq.int8_dynamic_dot(x_t, w_qt, w_st, full)
    (dx_t,) = torch.autograd.grad(y_t, x_t, torch.from_numpy(np.asarray(dy_j.astype(jnp.float32))).to(tdt))

    # the int32 accumulators are equal
    xq_j, _ = jq._dynamic_quantize(x_j.reshape(-1, 64))
    acc_j = jax.lax.dot_general(xq_j, w_q, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    xq_t, _ = tq._dynamic_quantize(x_t.detach().reshape(-1, 64))
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(tq.int8_matmul(xq_t, w_qt.t()).numpy(), np.asarray(acc_j))
    # outputs within one ulp of their dtype (measured: bit-identical)
    ulp = {"f32": 2.0 ** -23, "bf16": 2.0 ** -8}[dtype]
    for got, ref in ((y_t, y_j), (dx_t, dx_j)):
        assert got.dtype == tdt and tuple(got.shape) == ref.shape
        ref = np.asarray(ref.astype(jnp.float32))
        got = got.detach().float().numpy()
        np.testing.assert_allclose(got, ref, rtol=ulp, atol=0)
    assert float(np.abs(np.asarray(dx_j.astype(jnp.float32))).max()) > 0


def test_int8_dynamic_dot_saves_no_dequantized_weight():
    w = tq.quantize_weight(torch.randn(40, 64, generator=torch.Generator().manual_seed(0)), "int8")
    x = torch.randn(3, 64, dtype=torch.bfloat16, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda s: saved.append(s) or s, lambda s: s):
        y = tq.int8_dynamic_dot(x, w["weight"], w["weight_scale"], True)
    assert {s.dtype for s in saved} <= {torch.int8, torch.float32}
    assert not any(s.dtype == torch.bfloat16 and s.shape == (40, 64) for s in saved)
    y.float().sum().backward()
    assert x.grad is not None and x.grad.dtype == torch.bfloat16


# ---- quantized-base LoRA trajectories against the JAX train step -----------------------------------

BATCH, LATENT, TXT_LEN = 2, 8, 12


def _train_config(precision, matmul, steps):
    return _config(optimizer="adamw", learning_rate=1e-3, adam_weight_decay=0.01, max_grad_norm=1.0,
                   lr_scheduler="constant", max_train_steps=steps, flux_attention_masked_training=True,
                   flux_guidance_value=1.0, base_model_precision=precision, quantized_matmul=matmul)


def _steps(seed, steps):
    rng = np.random.default_rng(seed)
    masks = np.zeros((BATCH, TXT_LEN), np.int64)
    masks[0, :5] = 1
    masks[1, :9] = 1
    batch = {
        "latents": rng.standard_normal((BATCH, LATENT, LATENT, 4), dtype=np.float32),
        "t5_embeds": rng.standard_normal((BATCH, TXT_LEN, 32), dtype=np.float32),
        "pooled_embeds": rng.standard_normal((BATCH, 32), dtype=np.float32),
        "t5_masks": masks,
    }
    noises = rng.standard_normal((steps, BATCH, LATENT, LATENT, 4), dtype=np.float32)
    sigmas = rng.uniform(0.05, 0.95, (steps, BATCH)).astype(np.float32)
    return [{**batch, "override_noise": noises[i], "override_sigmas": sigmas[i]} for i in range(steps)]


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` inside an optax chain's state."""
    return next(x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
                if isinstance(x, optax.ScaleByAdamState))


def _sync(state_t, state_j):
    """Give the port's state the JAX state's adapters and Adam moments."""
    lora = _flat(state_j.trainable["lora"])
    adam = _adam_state(state_j.opt_state)
    mu, nu = _flat(adam.mu["lora"]), _flat(adam.nu["lora"])
    with torch.no_grad():
        for key, param in state_t.trainable.items():
            param.copy_(t(lora[key].T))
            state_t.opt_state.mu[key].copy_(t(mu[key].T))
            state_t.opt_state.nu[key].copy_(t(nu[key].T))
    assert state_t.opt_state.count == int(adam.count)


@contextlib.contextmanager
def _recording_codes():
    """Record the input and the int8 codes of every ``_dynamic_quantize`` call
    on both sides, as ``(ours, theirs)`` lists of 2-D arrays that the caller
    empties.  The JAX function reports from inside the jitted step through
    ``jax.debug.callback``, so the JAX caches are cleared on the way in and
    out: no step traced without the callback is reused, nor one with it."""
    ours, theirs = [], []
    port_quantize, jax_quantize = tq._dynamic_quantize, jq._dynamic_quantize

    def port(values):
        q, scales = port_quantize(values)
        k = values.shape[-1]
        ours.append((values.detach().float().numpy().reshape(-1, k), q.numpy().reshape(-1, k)))
        return q, scales

    def record(values, q):
        k = values.shape[-1]
        theirs.append((np.asarray(values, np.float32).reshape(-1, k), np.asarray(q).reshape(-1, k)))

    def traced(values):
        q, scales = jax_quantize(values)
        jax.debug.callback(record, values, q)
        return q, scales

    jax.clear_caches()
    try:
        with mock.patch.object(tq, "_dynamic_quantize", port), mock.patch.object(jq, "_dynamic_quantize", traced):
            yield ours, theirs
    finally:
        jax.clear_caches()


def _code_flips(ours, theirs):
    """The int8 codes that differ between the two sides in one step.  Both
    sides make the same calls; each JAX call is paired with the port call of
    its shape whose input is nearest (the same call: its input differs from
    every other call's by far more than f32 sum order moves it)."""
    assert ours and sorted(v.shape for v, _ in ours) == sorted(v.shape for v, _ in theirs)
    flips = 0
    for v_j, q_j in theirs:
        _, q_t = min(((np.abs(v_t - v_j).max(), q_t) for v_t, q_t in ours if v_t.shape == v_j.shape),
                     key=lambda pair: pair[0])
        flips += int(np.count_nonzero(q_t != q_j))
    return flips


def _trajectories(precision, matmul, steps, synced=False, perturb=0.0):
    """Port and JAX train steps on the same data.  ``synced`` starts every
    port step from the JAX state (adapters and Adam moments), so each step is
    compared alone, and counts the int8 codes of the step that differ between
    the two sides (``flips``); ``perturb`` scales the JAX run's text embeds by
    ``1 + perturb`` and leaves the port out (a JAX-against-JAX noise floor)."""
    if synced:
        with _recording_codes() as codes:
            return _run_trajectories(precision, matmul, steps, perturb, codes)
    return _run_trajectories(precision, matmul, steps, perturb, None)


def _run_trajectories(precision, matmul, steps, perturb, codes):
    synced = codes is not None
    config = _train_config(precision, matmul, steps)
    batches = _steps(7, steps)
    jax_model = JaxFlux(TrainingConfig(config))  # installs the int8 matmul mode
    shapes = jax.eval_shape(lambda: jax_model.init_params(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batches[0].items() if not k.startswith("override")}))
    variables = fill_numpy(shapes, seed=11)
    schedule_j = jax_get_lr_schedule(TrainingConfig(config), steps)
    tx_j = jax_get_optimizer(TrainingConfig(config), schedule_j)
    state_j = jax_create_train_state(jax_model, jax.tree_util.tree_map(jnp.asarray, variables), tx_j,
                                     quantize_mode=jq.resolve_precision(TrainingConfig(config)))
    step_j = jax.jit(jax_build_train_step(jax_model, tx_j, schedule_j))

    if perturb:
        state_p, step_p = state_j, step_j
    else:
        model = Flux(config_namespace(config))
        schedule_t = get_lr_schedule(model.config, steps)
        tx_t = get_optimizer(model.config, schedule_t)
        state_t = create_train_state(model, bridge(variables, model.create_module()), tx_t,
                                     quantize_mode=model.base_precision)
        step_t = build_train_step(model, tx_t, schedule_t)

    out = {"ours": [], "theirs": [], "norm_ours": [], "norm_theirs": [], "adapters": [], "flips": []}
    for i, batch in enumerate(batches):
        if synced:
            _sync(state_t, state_j)
            for log in codes:
                log.clear()
        state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(i))
        if perturb:
            batch = {**batch, "t5_embeds": batch["t5_embeds"] * np.float32(1 + perturb)}
            state_p, m_t = step_p(state_p, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(i))
            final_t = _flat(state_p.trainable["lora"])
        else:
            state_t, m_t = step_t(state_t, {k: t(v) for k, v in batch.items()}, torch.Generator())
            assert float(m_t["skipped_nonfinite"]) == 0.0
            final_t = _flat(lora_to_flax(state_t.module))
        if synced:
            jax.effects_barrier()
            out["flips"].append(_code_flips(*codes))
        out["ours"].append(float(m_t["loss"]))
        out["theirs"].append(float(m_j["loss"]))
        out["norm_ours"].append(float(m_t["grad_norm"]))
        out["norm_theirs"].append(float(m_j["grad_norm"]))
        final_j = _flat(state_j.trainable["lora"])
        out["adapters"].append(max(rel(final_t[key], final_j[key]) for key in final_j))
        assert set(final_t) == set(final_j)
    out["state_j"] = state_j
    if not perturb:
        out["state_t"] = state_t
    return out


def _step_errors(run):
    """Relative differences at every step: loss, grad norm, adapters after the update."""
    return {
        "loss": np.abs(np.asarray(run["ours"]) / np.asarray(run["theirs"]) - 1),
        "grad_norm": np.abs(np.asarray(run["norm_ours"]) / np.asarray(run["norm_theirs"]) - 1),
        "adapters": np.asarray(run["adapters"]),
    }


def _assert_tracks(run, int8_products, clean=1e-5):
    """Dequantized products: every step within 1e-3 (measured: 3e-6).  int8
    products (synced runs): an activation or dy entry whose f32 value lies
    within an f32 rounding of an int8 code boundary takes the neighbouring
    code on one side only, and the flip spreads to the codes downstream.
    Every step whose codes all agree on both sides is held within ``clean``
    (measured: 3.3e-7 under "full"; 2.1e-4 under "forward", whose dx goes
    through a bf16 product that rounds differently in XLA and torch); only a
    step with a counted flip may reach 5e-3 (measured: 3.3e-3)."""
    flips = np.asarray(run["flips"])
    if int8_products:
        assert len(flips) == len(run["ours"]) and (flips == 0).sum() >= 3, flips
    for name, errors in _step_errors(run).items():
        if int8_products:
            assert errors[flips == 0].max() < clean and errors.max() < 5e-3, (name, errors, flips)
        else:
            assert errors.max() < 1e-3, (name, errors)
    assert run["theirs"][-1] < run["theirs"][0] and run["ours"][-1] < run["ours"][0]


def test_int8_full_trajectory_tracks_jax():
    # 30 steps on an int8 base with int8 forward and dx products, every port
    # step started from the JAX state (adapters and Adam moments).  The codes
    # and int32 products are exact on both sides given the same inputs; only
    # f32 sum orders elsewhere differ
    run = _trajectories("int8-quanto", "full", 30, synced=True)
    assert max(run["norm_theirs"]) > 1.0  # the clip at max_grad_norm 1.0 is exercised
    _assert_tracks(run, int8_products=True)
    state = run["state_t"]
    assert all(m.quant == "int8" and m.quantized_matmul == "full"
               for m in state.module.modules() if isinstance(m, tl.LoRADense))
    # export dequantizes the base, as TrainState.variables does
    exported = state.state_dict()  # bf16 kernels, as dequantize_params' default
    ref = _flat(run["state_j"].variables()["params"])
    plain = Flux(config_namespace(_config())).create_module()
    plain.load_state_dict(exported)
    for name, value in _flat(flax_variables(plain)["params"]).items():
        np.testing.assert_array_equal(value, np.asarray(ref[name], np.float32), err_msg=name)


def test_int8_full_free_trajectory_stays_within_the_jax_noise_floor():
    # Left to run freely for 30 steps, the two trajectories part by a few
    # 1e-3 (the flips above accumulate into the adapters).  The JAX step does
    # the same to itself when its text embeds move by 1e-7 relative: the port
    # stays within twice that floor on the losses, grad norms and adapters
    port = _step_errors(_trajectories("int8-quanto", "full", 30))
    floor = _step_errors(_trajectories("int8-quanto", "full", 30, perturb=1e-7))
    for name in port:
        assert port[name].max() < 2 * floor[name].max(), (name, port[name].max(), floor[name].max())
        assert floor[name].max() > 1e-4  # the floor is real: codes flip under a 1e-7 perturbation


@pytest.mark.parametrize("precision,matmul,synced", [
    ("int4-quanto", "auto", True), ("int4-quanto", "off", False), ("fp8-quanto", "auto", False),
    ("int8-quanto", "forward", True), ("int8-quanto", "off", False),
])
def test_quantized_base_trajectory_tracks_jax(precision, matmul, synced):
    # dequantized products (int4 and int8 off, fp8) run freely; int8 products
    # step by step from the JAX state, as in the int8 full run.  "forward"
    # takes dx through the bf16 dequantized weight, as the JAX function does:
    # its bf16 roundings differ between XLA and torch now and then
    run = _trajectories(precision, matmul, 10, synced=synced)
    _assert_tracks(run, int8_products=synced, clean=1e-3 if matmul == "forward" else 1e-5)


def test_quantized_base_needs_lora_and_stays_quantized():
    model = Flux(config_namespace(_config(model_type="full")))
    module = Flux(config_namespace(_config())).create_module()
    with pytest.raises(ValueError, match="model_type=lora"):
        create_train_state(model, module, get_optimizer({"optimizer": "adamw"}, 1e-3), quantize_mode="int8")
    lora_model = Flux(config_namespace(_config()))
    module = tl.init_parameters(lora_model.create_module(), torch.Generator().manual_seed(0))
    float_bytes = sum(p.numel() * p.element_size() for n, p in module.named_parameters() if n.endswith(".weight"))
    state = create_train_state(lora_model, module, get_optimizer({"optimizer": "adamw"}, 1e-3), quantize_mode="int4")
    stored = [b for n, b in state.module.named_buffers() if n.endswith("weight_packed")]
    assert stored and all(b.dtype == torch.uint8 for b in stored)
    assert not any(n.endswith(".weight") and p.is_floating_point() for n, p in state.module.named_parameters())
    assert sum(b.numel() for b in stored) * 8 == float_bytes  # half a byte per f32 weight of 4 bytes
    assert set(state.trainable) == set(tl.lora_parameters(state.module))
    with pytest.raises(RuntimeError):
        tl.init_parameters(state.module)  # initialise before quantizing
