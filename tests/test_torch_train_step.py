"""The torch port's LoRA train step against the JAX package, on the CPU.

Pieces first (sigma sampling and shifts, the flow loss, the nine LR
schedules, clip + AdamW, EMA, LoRA targeting), then a tiny Flux LoRA
trajectory: the same seeded numpy weights go to JAX as they are and to the
port through its weight bridge, and each step gets the same numpy noise and
sigmas through the ``override_noise``/``override_sigmas`` batch hooks (the two
frameworks draw different random numbers).  fp32 throughout.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpletuner_tpu.configuration import TrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.flux.model import Flux as JaxFlux
from simpletuner_tpu.models.flux.transformer import FluxConfig as JaxFluxConfig
from simpletuner_tpu.training import ema as jema
from simpletuner_tpu.training import losses as jlosses
from simpletuner_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from simpletuner_tpu.training.schedules import get_lr_schedule as jax_get_lr_schedule
from simpletuner_tpu.training.train_state import build_train_step as jax_build_train_step
from simpletuner_tpu.training.train_state import create_train_state as jax_create_train_state

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.flux import Flux, FluxConfig
from simpletuner_tpu_torch.models.weight_bridge import flax_to_state_dict, lora_to_flax
from simpletuner_tpu_torch.ops import set_attention_backend
from simpletuner_tpu_torch.training import ema as tema
from simpletuner_tpu_torch.training import losses as tlosses
from simpletuner_tpu_torch.training.optimizers import get_optimizer
from simpletuner_tpu_torch.training.schedules import get_lr_schedule
from simpletuner_tpu_torch.training.train_state import build_train_step, create_train_state

from torch_parity import bridge, fill_numpy, rel, t

# f32 closed forms and elementwise updates: only f32 vs f64 evaluation order
# of the same formula differs
F32 = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _restore_jax_lora_target():
    """Building a JAX model family installs a process-wide LoRA target predicate."""
    previous = jl._LORA_TARGET
    yield
    jl.set_lora_target(previous)


# ---- training/losses ---------------------------------------------------------------------------


def test_flow_sigma_shifts_and_sampling_modes():
    sig = np.linspace(0.01, 0.99, 33).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.apply_schedule_shift(t(sig), 3.0).numpy(),
        np.asarray(jlosses.apply_schedule_shift(jnp.asarray(sig), 3.0)), **F32)
    mu_t = tlosses.calculate_dynamic_shift_mu(4096.0)
    mu_j = float(jlosses.calculate_dynamic_shift_mu(jnp.float32(4096.0)))
    assert abs(mu_t - mu_j) < 1e-6
    np.testing.assert_allclose(
        tlosses.apply_schedule_shift_mu(t(sig), mu_t).numpy(),
        np.asarray(jlosses.apply_schedule_shift_mu(jnp.asarray(sig), mu_j)), **F32)

    gen = torch.Generator().manual_seed(0)
    # deterministic modes: the same values
    robin = tlosses.FlowScheduleConfig(custom_sigmas=(0.9, 0.5, 0.2), custom_mode="round-robin")
    for step in range(3):
        np.testing.assert_array_equal(
            tlosses.sample_flow_sigmas(gen, 4, robin, global_step=step).numpy(),
            np.asarray(jlosses.sample_flow_sigmas(
                jax.random.PRNGKey(0), 4, jlosses.FlowScheduleConfig(custom_sigmas=(0.9, 0.5, 0.2),
                                                                     custom_mode="round-robin"),
                global_step=step)))
    fast = tlosses.sample_flow_sigmas(gen, 64, tlosses.FlowScheduleConfig(fast_schedule=True))
    assert set(np.unique(fast.numpy()).tolist()) <= {1.0, np.float32(0.3), np.float32(0.2), np.float32(0.1)}
    # random modes: the same distribution (20k draws: the means agree to a few std errors)
    for kwargs in ({}, {"use_uniform_schedule": True}, {"schedule_shift": 3.0},
                   {"auto_shift": True}, {"sigmoid_scale": 2.0}):
        port = tlosses.sample_flow_sigmas(gen, 20000, tlosses.FlowScheduleConfig(**kwargs), seq_len=4096).numpy()
        ref = np.asarray(jlosses.sample_flow_sigmas(
            jax.random.PRNGKey(1), 20000, jlosses.FlowScheduleConfig(**kwargs), 4096))
        assert port.dtype == np.float32 and 0 < port.min() and port.max() < 1
        assert abs(port.mean() - ref.mean()) < 0.012 and abs(port.std() - ref.std()) < 0.012
    with pytest.raises(NotImplementedError):
        tlosses.sample_flow_sigmas(gen, 2, tlosses.FlowScheduleConfig(use_beta_schedule=True))


@pytest.mark.parametrize("loss_type", ["l2", "huber", "smooth_l1"])
def test_diffusion_loss_matches_jax(loss_type):
    rng = np.random.default_rng(0)
    pred, target = (rng.standard_normal((3, 8, 8, 4), dtype=np.float32) for _ in range(2))
    noisy = rng.standard_normal((3, 8, 8, 4), dtype=np.float32)
    sigmas = np.array([0.2, 0.5, 0.9], np.float32)
    mask = (rng.random((3, 8, 8, 1)) > 0.3).astype(np.float32)
    weight = np.array([1.0, 0.5, 2.0], np.float32)
    for kw in ({}, {"mask": mask}, {"loss_weight": weight}, {"mask": mask, "loss_weight": weight}):
        port = tlosses.diffusion_loss(t(pred), t(target), tlosses.LossConfig(loss_type=loss_type), sigmas=t(sigmas),
                                      **{k: t(v) for k, v in kw.items()})
        ref = jlosses.diffusion_loss(jnp.asarray(pred), jnp.asarray(target), jlosses.LossConfig(loss_type=loss_type),
                                     sigmas=jnp.asarray(sigmas), **{k: jnp.asarray(v) for k, v in kw.items()})
        np.testing.assert_allclose(float(port), float(ref), rtol=1e-6)
    np.testing.assert_allclose(
        tlosses.flow_interpolate(t(pred), t(noisy), t(sigmas)).numpy(),
        np.asarray(jlosses.flow_interpolate(jnp.asarray(pred), jnp.asarray(noisy), jnp.asarray(sigmas))), **F32)


# ---- training/schedules, optimizers, ema -------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "constant", "constant_with_warmup", "linear", "polynomial", "cosine", "cosine_with_restarts",
    "cosine_annealing_hard_restarts", "sine",
])
@pytest.mark.parametrize("warmup", [0, 7])
def test_lr_schedules_match_optax(name, warmup):
    config = {"lr_scheduler": name, "learning_rate": 3e-4, "lr_warmup_steps": warmup, "lr_end": 1e-6,
              "lr_num_cycles": 3, "lr_power": 2.0}
    port, ref = get_lr_schedule(config, 60), jax_get_lr_schedule(config, 60)
    steps = list(range(0, 70))
    # optax evaluates in f32, the port in f64: a few f32 ulps of the peak
    np.testing.assert_allclose([port(s) for s in steps], [float(ref(jnp.int32(s))) for s in steps],
                               rtol=1e-6, atol=1e-6 * 3e-4)


def test_unknown_schedule_and_optimizers_raise():
    with pytest.raises(ValueError):
        get_lr_schedule({"lr_scheduler": "no-such"}, 10)
    for name in ("prodigy", "lion", "soap"):
        with pytest.raises(NotImplementedError):
            get_optimizer({"optimizer": name}, 1e-4)


def _random_tree(rng, scale=1.0):
    return {"a/lora_A": scale * rng.standard_normal((4, 6), dtype=np.float32),
            "a/lora_B": scale * rng.standard_normal((5, 4), dtype=np.float32),
            "b/lora_A": scale * rng.standard_normal((3,), dtype=np.float32)}


@pytest.mark.parametrize("max_norm", [0.0, 1.0])
def test_clip_and_adamw_match_optax(max_norm):
    rng = np.random.default_rng(1)
    config = {"optimizer": "adamw", "learning_rate": 1e-2, "max_grad_norm": max_norm, "adam_weight_decay": 0.05,
              "lr_scheduler": "linear", "lr_warmup_steps": 2, "optimizer_config": "b2=0.99"}
    params = _random_tree(rng)
    tx_j = jax_get_optimizer(config, jax_get_lr_schedule(config, 10))
    tx_t = get_optimizer(config, get_lr_schedule(config, 10))
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    p_t = {k: t(v) for k, v in params.items()}
    s_j, s_t = tx_j.init(p_j), tx_t.init(p_t)
    for step in range(5):
        grads = _random_tree(rng, scale=[0.05, 3.0][step % 2])  # the clip triggers on odd steps
        u_j, s_j = tx_j.update({k: jnp.asarray(v) for k, v in grads.items()}, s_j, p_j)
        u_t, s_t = tx_t.update({k: t(v) for k, v in grads.items()}, s_t, p_t)
        p_j = {k: p_j[k] + u_j[k] for k in p_j}
        p_t = {k: p_t[k] + u_t[k] for k in p_t}
        for k in params:
            np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]), rtol=2e-6, atol=1e-7)


def test_ema_matches_jax():
    rng = np.random.default_rng(2)
    for cfg_kw in ({}, {"use_warmup": False, "decay": 0.9}, {"update_interval": 2}):
        params = _random_tree(rng)
        e_j = jema.ema_init({k: jnp.asarray(v) for k, v in params.items()})
        e_t = tema.ema_init({k: t(v) for k, v in params.items()})
        for step in range(1, 6):
            new = _random_tree(rng)
            e_j = jema.ema_update(jema.EMAConfig(**cfg_kw), e_j, {k: jnp.asarray(v) for k, v in new.items()},
                                  jnp.int32(step))
            e_t = tema.ema_update(tema.EMAConfig(**cfg_kw), e_t, {k: t(v) for k, v in new.items()}, step)
            for k in params:
                np.testing.assert_allclose(e_t[k].numpy(), np.asarray(e_j[k]), rtol=1e-6, atol=1e-7)


# ---- LoRA adapters: f32 masters, the bridge, targeting -----------------------------------------------


def test_lora_adapters_are_f32_masters_cast_at_use():
    dense = tl.init_parameters(tl.LoRADense(16, 8, dtype=torch.bfloat16, lora_rank=4), torch.Generator().manual_seed(0))
    assert dense.weight.dtype == torch.bfloat16
    assert dense.lora_A.dtype == dense.lora_B.dtype == torch.float32
    with torch.no_grad():
        dense.lora_B.normal_(generator=torch.Generator().manual_seed(1))
        x = torch.randn(2, 16, generator=torch.Generator().manual_seed(2)).bfloat16()
        expected = torch.nn.functional.linear(x, dense.weight, dense.bias) + torch.nn.functional.linear(
            torch.nn.functional.linear(x, dense.lora_A.bfloat16()), dense.lora_B.bfloat16())
        assert torch.equal(dense(x), expected)


def test_bridge_keeps_lora_leaves_f32():
    rng = np.random.default_rng(3)
    dense = tl.LoRADense(16, 8, dtype=torch.bfloat16, lora_rank=4)
    params = {"kernel": rng.standard_normal((16, 8), dtype=np.float32), "bias": np.zeros(8, np.float32)}
    lora = {"lora_A": rng.standard_normal((16, 4), dtype=np.float32) * 0.3,
            "lora_B": rng.standard_normal((4, 8), dtype=np.float32) * 0.3}
    state = flax_to_state_dict(params, dense, lora)
    assert state["weight"].dtype == torch.bfloat16
    # the master copy arrives unrounded
    assert state["lora_A"].dtype == torch.float32 and np.array_equal(state["lora_A"].numpy(), lora["lora_A"].T)
    dense.load_state_dict(state)
    back = lora_to_flax(dense)
    np.testing.assert_array_equal(back["lora_A"], lora["lora_A"])
    np.testing.assert_array_equal(back["lora_B"], lora["lora_B"])


def _tiny_config(**extra):
    return {"model_family": "flux", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


@pytest.mark.parametrize("preset", ["all", "context", "tiny", "ai-toolkit"])
def test_lora_targets_match_jax_lora_collection(preset):
    # 21 single blocks so that the "tiny" preset (single blocks 7 and 20) adapts something
    arch = dataclasses.replace(JaxFluxConfig.tiny(), depth_single=21)
    config = _tiny_config(flux_lora_target=preset)
    jax_model = JaxFlux(TrainingConfig(config), arch=arch)
    shapes = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0)))
    jax_paths = {"/".join(getattr(k, "key", str(k)) for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(shapes.get("lora", {}))[0]}
    port_arch = dataclasses.replace(FluxConfig.tiny(), depth_single=21)
    module = Flux(config_namespace(config), arch=port_arch).create_module()
    port_paths = set(tl.lora_parameters(module))
    assert port_paths == jax_paths and port_paths
    if preset == "all":
        assert "single_0/linear1/lora_A" in port_paths and "double_0/txt_attn_proj/lora_B" in port_paths
        assert not any("mlp" in p or "_mod" in p or p.startswith(("img_in", "txt_in")) for p in port_paths)


def test_bench_flops_and_peak():
    from simpletuner_tpu_torch.bench import flux_step_flops, peak_flops

    # bench.py::flux_step_flops of the JAX flagship at 1024 px (4096 + 512 tokens)
    assert flux_step_flops(FluxConfig(), 1, 4096, 512) == pytest.approx(2.2313428844544e14, rel=1e-12)
    assert peak_flops("NVIDIA H100 80GB HBM3") == 989e12 and peak_flops("NVIDIA H100 PCIe") == 756e12
    with pytest.raises(ValueError):
        peak_flops("NVIDIA A100-SXM4-80GB")


def test_unported_training_options_raise():
    for extra in ({"lora_dropout": 0.1}, {"lora_init_type": "gaussian"}, {"lora_type": "lycoris"},
                  {"peft_lora_mode": "dora"}):
        with pytest.raises(NotImplementedError):
            Flux(config_namespace(_tiny_config(**extra))).create_module()
    model = Flux(config_namespace(_tiny_config(noise_offset=0.1)))
    with pytest.raises(NotImplementedError):
        model.prepare_batch(torch.Generator(), {"latents": torch.zeros(1, 8, 8, 4), "t5_embeds": torch.zeros(1, 4, 32)})


# ---- the tiny Flux LoRA trajectory -------------------------------------------------------------------

STEPS, BATCH, LATENT, TXT_LEN = 30, 2, 8, 12
TRAIN_CONFIG = _tiny_config(
    optimizer="adamw", learning_rate=1e-3, adam_weight_decay=0.01, max_grad_norm=1.0, lr_scheduler="constant",
    max_train_steps=STEPS, flux_attention_masked_training=True, flux_guidance_value=1.0,
)


def _batch(rng):
    masks = np.zeros((BATCH, TXT_LEN), np.int64)
    masks[0, :5] = 1
    masks[1, :9] = 1  # padded T5 tokens in both samples
    return {
        "latents": rng.standard_normal((BATCH, LATENT, LATENT, 4), dtype=np.float32),
        "t5_embeds": rng.standard_normal((BATCH, TXT_LEN, 32), dtype=np.float32),
        "pooled_embeds": rng.standard_normal((BATCH, 32), dtype=np.float32),
        "t5_masks": masks,
    }


@pytest.fixture(scope="module")
def pair():
    """The same tiny LoRA Flux in both frameworks, with the data of every step."""
    rng = np.random.default_rng(7)
    batch = _batch(rng)
    noises = rng.standard_normal((STEPS, BATCH, LATENT, LATENT, 4), dtype=np.float32)
    sigmas = rng.uniform(0.05, 0.95, (STEPS, BATCH)).astype(np.float32)

    previous = jl._LORA_TARGET
    jax_model = JaxFlux(TrainingConfig(TRAIN_CONFIG))
    shapes = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()}))
    variables = fill_numpy(shapes, seed=11)
    model = Flux(config_namespace(TRAIN_CONFIG))
    make_module = lambda: bridge(variables, model.create_module())
    yield dict(batch=batch, noises=noises, sigmas=sigmas, jax_model=jax_model, variables=variables,
               model=model, make_module=make_module)
    jl.set_lora_target(previous)


def _step_batch(pair, step, framework):
    out = {**pair["batch"], "override_noise": pair["noises"][step], "override_sigmas": pair["sigmas"][step]}
    convert = {"jax": jnp.asarray, "torch": t, "numpy": np.asarray}[framework]
    return {k: convert(v) for k, v in out.items()}


def _port_grads(pair, module, batch):
    loss, _ = pair["model"].loss_fn(module, torch.Generator(), batch)
    params = tl.lora_parameters(module)
    return loss.detach(), dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def _flat_lora(tree):
    return {"/".join(getattr(k, "key", str(k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_first_step_loss_and_lora_grads_match_jax(pair):
    jax_model, variables = pair["jax_model"], pair["variables"]
    jax_model.apply_trace_globals()
    batch_j = _step_batch(pair, 0, "jax")

    def loss_of(lora):
        return jax_model.loss_fn({**variables, "lora": lora}, jax.random.PRNGKey(0), batch_j)[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_of))(jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    module = pair["make_module"]()
    tl.freeze_base(module)
    loss_t, grads_t = _port_grads(pair, module, _step_batch(pair, 0, "torch"))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    flat_j = _flat_lora(grads_j)
    assert set(flat_j) == set(grads_t)
    for key, grad in grads_t.items():
        assert float(np.abs(flat_j[key]).max()) > 0
        assert rel(grad.numpy().T, flat_j[key]) < 1e-4, key


def test_lora_trajectory_tracks_jax(pair):
    jax_model = pair["jax_model"]
    jax_model.apply_trace_globals()
    config = TrainingConfig(TRAIN_CONFIG)
    schedule_j = jax_get_lr_schedule(config, STEPS)
    tx_j = jax_get_optimizer(config, schedule_j)
    state_j = jax_create_train_state(jax_model, jax.tree_util.tree_map(jnp.asarray, pair["variables"]), tx_j)
    step_j = jax.jit(jax_build_train_step(jax_model, tx_j, schedule_j))

    model = pair["model"]
    schedule_t = get_lr_schedule(model.config, STEPS)
    tx_t = get_optimizer(model.config, schedule_t)
    state_t = create_train_state(model, pair["make_module"](), tx_t)
    step_t = build_train_step(model, tx_t, schedule_t)

    ours, theirs, norms = [], [], []
    for step in range(STEPS):
        state_j, m_j = step_j(state_j, _step_batch(pair, step, "jax"), jax.random.PRNGKey(step))
        state_t, m_t = step_t(state_t, _step_batch(pair, step, "torch"), torch.Generator())
        ours.append(float(m_t["loss"]))
        theirs.append(float(m_j["loss"]))
        norms.append((float(m_t["grad_norm"]), float(m_j["grad_norm"])))
        assert float(m_t["skipped_nonfinite"]) == 0.0 and float(m_t["lr"]) == pytest.approx(float(m_j["lr"]))
    # the clip at max_grad_norm 1.0 is exercised
    assert max(n for _, n in norms) > 1.0
    # f32 on both sides, the same math; only f32 sum orders differ, which
    # left the curves within 1e-6 of each other over 30 steps (tighter than
    # test_loss_curve_parity.py's rtol 2e-2 / atol 2e-3)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    np.testing.assert_allclose([n for n, _ in norms], [n for _, n in norms], rtol=1e-4)
    assert ours[-1] < ours[0]
    assert state_t.step == STEPS and state_t.opt_state.count == STEPS
    final_j = _flat_lora(state_j.trainable["lora"])
    final_t = _flat_lora(lora_to_flax(state_t.module))
    assert set(final_j) == set(final_t)
    for key in final_j:
        assert rel(final_t[key], final_j[key]) < 1e-4, key  # measured: 5e-6


@pytest.mark.parametrize("backend", ["xla", "pallas_flash"])
def test_remat_leaves_gradients_bit_identical(pair, backend, monkeypatch):
    configured = Flux(config_namespace(_tiny_config(
        gradient_checkpointing=True, gradient_checkpointing_policy="dots", gradient_checkpointing_skip_last=2,
        gradient_checkpointing_interval=3))).create_module()
    assert (configured.remat, configured.remat_policy, configured.remat_skip_last, configured.remat_interval) == (
        True, "dots", 2, 3)
    flash = sys.modules["simpletuner_tpu_torch.ops.flash_attention"]
    calls = []
    plain = flash.mha_reference_lse
    monkeypatch.setattr(flash, "mha_reference_lse", lambda *a, **k: calls.append(1) or plain(*a, **k))
    module = pair["make_module"]()
    tl.freeze_base(module)
    batch = _step_batch(pair, 0, "torch")
    set_attention_backend(backend)
    # (remat, policy, skip_last, interval) -> flash forward calls with 2 double
    # + 2 single blocks: full remat re-runs every block's forward op, attn
    # keeps the single blocks' flash outputs across the boundary and attn_all
    # every block's, single checkpoints the single stack only, dots saves the
    # 2-D products and recomputes the flash op, skip_last=2 leaves both single
    # blocks unchecked, interval=2 checkpoints blocks 0 of each stack
    settings = {
        (False, "full", 0, 1): 4, (True, "full", 0, 1): 8, (True, "attn", 0, 1): 6, (True, "attn_all", 0, 1): 4,
        (True, "single", 0, 1): 6, (True, "dots", 0, 1): 8, (True, "full", 2, 1): 6, (True, "full", 0, 2): 6,
    }
    try:
        results = {}
        for key in settings:
            module.remat, module.remat_policy, module.remat_skip_last, module.remat_interval = key
            calls.clear()
            results[key] = _port_grads(pair, module, batch) + (len(calls),)
    finally:
        set_attention_backend("auto")
    base_loss, base_grads, _ = results[(False, "full", 0, 1)]
    for key, (loss, grads, _) in results.items():
        assert torch.equal(loss, base_loss)
        for name, grad in grads.items():
            assert torch.equal(grad, base_grads[name]), (key, name)
    if backend == "pallas_flash":
        assert {key: result[2] for key, result in results.items()} == settings


def test_nonfinite_batch_skips_the_update_and_advances_adam_as_jax(pair):
    model = pair["model"]
    tx = get_optimizer(model.config, 1e-3)
    state = create_train_state(model, pair["make_module"](), tx)
    step_fn = build_train_step(model, tx)
    state, _ = step_fn(state, _step_batch(pair, 0, "torch"), torch.Generator())
    before = {k: p.detach().clone() for k, p in state.trainable.items()}
    mu_before = {k: m.clone() for k, m in state.opt_state.mu.items()}
    bad = _step_batch(pair, 1, "torch")
    bad["latents"] = bad["latents"].clone()
    bad["latents"][0, 0, 0, 0] = float("nan")
    state, metrics = step_fn(state, bad, torch.Generator())
    assert float(metrics["skipped_nonfinite"]) == 1.0
    for key, param in state.trainable.items():
        assert torch.equal(param, before[key])
        # Adam advanced on zero gradients: mu decays by b1, as optax's does
        torch.testing.assert_close(state.opt_state.mu[key], 0.9 * mu_before[key], rtol=0, atol=0)
    assert state.step == 2 and state.opt_state.count == 2


def test_grad_accumulation_matches_jax(pair):
    jax_model = pair["jax_model"]
    jax_model.apply_trace_globals()
    config = TrainingConfig(TRAIN_CONFIG)
    tx_j = jax_get_optimizer(config, 1e-3)
    state_j = jax_create_train_state(jax_model, jax.tree_util.tree_map(jnp.asarray, pair["variables"]), tx_j)
    step_j = jax.jit(jax_build_train_step(jax_model, tx_j, grad_accum_steps=2))
    model = pair["model"]
    tx_t = get_optimizer(model.config, 1e-3)
    state_t = create_train_state(model, pair["make_module"](), tx_t)
    step_t = build_train_step(model, tx_t, grad_accum_steps=2)

    def stacked(framework):
        steps = [_step_batch(pair, i, "numpy") for i in (0, 1)]
        out = {k: np.stack([s[k] for s in steps]) for k in steps[0]}
        return {k: (jnp.asarray if framework == "jax" else t)(v) for k, v in out.items()}

    state_j, m_j = step_j(state_j, stacked("jax"), jax.random.PRNGKey(0))
    state_t, m_t = step_t(state_t, stacked("torch"), torch.Generator())
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m_t["grad_norm"]), float(m_j["grad_norm"]), rtol=1e-4)
    final_j, final_t = _flat_lora(state_j.trainable["lora"]), _flat_lora(lora_to_flax(state_t.module))
    for key in final_j:
        assert rel(final_t[key], final_j[key]) < 1e-4, key


def test_ema_in_the_step_matches_jax(pair):
    jax_model = pair["jax_model"]
    jax_model.apply_trace_globals()
    config = TrainingConfig(TRAIN_CONFIG)
    tx_j = jax_get_optimizer(config, 1e-3)
    ema_j = jema.EMAConfig(decay=0.99)
    state_j = jax_create_train_state(jax_model, jax.tree_util.tree_map(jnp.asarray, pair["variables"]), tx_j,
                                     ema_config=ema_j)
    step_j = jax.jit(jax_build_train_step(jax_model, tx_j, ema_config=ema_j))
    model = pair["model"]
    tx_t = get_optimizer(model.config, 1e-3)
    ema_t = tema.EMAConfig(decay=0.99)
    state_t = create_train_state(model, pair["make_module"](), tx_t, ema_config=ema_t)
    step_t = build_train_step(model, tx_t, ema_config=ema_t)
    for step in range(3):
        state_j, _ = step_j(state_j, _step_batch(pair, step, "jax"), jax.random.PRNGKey(step))
        state_t, _ = step_t(state_t, _step_batch(pair, step, "torch"), torch.Generator())
    ema_flat = _flat_lora(state_j.ema["lora"])
    assert set(ema_flat) == set(state_t.ema)
    for key, value in state_t.ema.items():
        assert not torch.equal(value, state_t.trainable[key])  # the EMA lags the adapters
        assert rel(value.numpy().T, ema_flat[key]) < 1e-4, key
