"""The torch port's DDPM training math and DDPM samplers against the JAX package, on the CPU.

The same numpy inputs go through ``simpletuner_tpu.training.losses`` /
``simpletuner_tpu.schedulers`` and their ports: the beta ladders (with the
zero-SNR rescale), ``add_noise``, the v target, SNR and soft-min SNR, the
timestep weights of every bias strategy and the refiner's window, the loss
with its SNR / soft-min / Huber branches for every prediction type, and the
DDIM and UniPC ladders run through both ``sample_loop``s with one fixed
denoise function.  Everything is f32; the bound is rtol 1e-6 (a few f32
ulps) unless a test says otherwise.  The timestep draw itself is not JAX's
(``jax.random.choice``): it is held to the weights it draws from.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from simpletuner_tpu.schedulers import DDIMScheduler as JaxDDIM
from simpletuner_tpu.schedulers import UniPCScheduler as JaxUniPC
from simpletuner_tpu.schedulers import sample_loop as jax_sample_loop
from simpletuner_tpu.training import losses as jl

from simpletuner_tpu_torch.schedulers import DDIMScheduler, UniPCScheduler, sample_loop
from simpletuner_tpu_torch.training import losses as tl

RTOL = 1e-6
SCHEDULES = [
    dict(beta_schedule="linear", beta_start=1e-4, beta_end=0.02),
    dict(beta_schedule="scaled_linear"),
    dict(beta_schedule="squaredcos_cap_v2"),
    dict(beta_schedule="scaled_linear", rescale_betas_zero_snr=True),
]
SCHEDULE_IDS = ["linear", "scaled_linear", "squaredcos", "zero_snr"]


def _ladders(kwargs):
    port = tl.make_alphas_cumprod(tl.DDPMScheduleConfig(**kwargs))
    ref = np.asarray(jl.make_alphas_cumprod(jl.DDPMScheduleConfig(**kwargs)))
    return port, ref


@pytest.mark.parametrize("kwargs", SCHEDULES, ids=SCHEDULE_IDS)
def test_alphas_cumprod_and_snr(kwargs):
    port, ref = _ladders(kwargs)
    assert port.dtype == torch.float32 and port.shape == (1000,)
    # near zero SNR the last alpha-bar is a difference of close f32 values: atol of a few f32 ulps of 1
    np.testing.assert_allclose(port.numpy(), ref, rtol=RTOL, atol=1e-7)
    # SNR on the same ladder (near alpha-bar = 1, 1 - alpha-bar amplifies a
    # one-ulp ladder difference into 1e-4 of the SNR)
    t = np.random.default_rng(0).integers(0, 1000, 16).astype(np.int32)
    ac = jnp.asarray(ref)
    np.testing.assert_allclose(tl.compute_snr(torch.from_numpy(t), torch.from_numpy(ref)).numpy(),
                               np.asarray(jl.compute_snr(jnp.asarray(t), ac)), rtol=RTOL)
    for sigma_data in (1.0, 0.5):
        np.testing.assert_allclose(
            tl.compute_soft_min_snr(torch.from_numpy(t), torch.from_numpy(ref), sigma_data).numpy(),
            np.asarray(jl.compute_soft_min_snr(jnp.asarray(t), ac, sigma_data)), rtol=RTOL)


@pytest.mark.parametrize("kwargs", SCHEDULES, ids=SCHEDULE_IDS)
def test_add_noise_and_velocity(kwargs):
    port, ref = _ladders(kwargs)
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((3, 8, 8, 4), dtype=np.float32)
    eps = rng.standard_normal((3, 8, 8, 4), dtype=np.float32)
    t = np.asarray([0, 517, 999], np.int32)
    args_t = (torch.from_numpy(x0), torch.from_numpy(eps), torch.from_numpy(t), port)
    args_j = (jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t), jnp.asarray(ref))
    np.testing.assert_allclose(tl.add_noise(*args_t).numpy(), np.asarray(jl.add_noise(*args_j)),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tl.velocity_target(*args_t).numpy(), np.asarray(jl.velocity_target(*args_j)),
                               rtol=RTOL, atol=1e-6)


BIASES = [
    dict(),
    dict(bias_strategy="earlier", bias_multiplier=3.0),
    dict(bias_strategy="later", bias_multiplier=2.0, bias_portion=0.4),
    dict(bias_strategy="range", bias_multiplier=5.0, bias_begin=200, bias_end=450),
    dict(range_begin=0, range_end=200),
    dict(range_begin=300, range_end=1000, bias_strategy="later", bias_multiplier=2.0),
]
BIAS_IDS = ["none", "earlier", "later", "range", "refiner_window", "inverted_window_biased"]


@pytest.mark.parametrize("kwargs", BIASES, ids=BIAS_IDS)
def test_timestep_weights_and_draw(kwargs):
    port = tl.timestep_weights(tl.TimestepSamplingConfig(**kwargs))
    ref = np.asarray(jl.timestep_weights(jl.TimestepSamplingConfig(**kwargs)))
    np.testing.assert_allclose(port.numpy(), ref, rtol=RTOL, atol=1e-12)
    # the draw: inverse CDF of these weights; its histogram follows them
    gen = torch.Generator().manual_seed(3)
    draws = tl.sample_timesteps(gen, 200_000, tl.TimestepSamplingConfig(**kwargs)).numpy()
    assert draws.min() >= 0 and draws.max() <= 999
    assert ref[draws].min() > 0  # never a zero-weight (windowed-out) step
    # mass per decile within 4 sigma of a multinomial count
    edges = np.arange(0, 1001, 100)
    expected = np.asarray([ref[a:b].sum() for a, b in zip(edges[:-1], edges[1:])]) * len(draws)
    counts = np.histogram(draws, bins=edges)[0]
    assert np.all(np.abs(counts - expected) <= 4 * np.sqrt(expected + 1)), (counts, expected)


def test_sample_timesteps_on_a_given_cdf_is_the_same_draw():
    config = tl.TimestepSamplingConfig(bias_strategy="earlier", bias_multiplier=3.0)
    cdf = torch.cumsum(tl.timestep_weights(config), dim=0)
    a = tl.sample_timesteps(torch.Generator().manual_seed(9), 64, config)
    b = tl.sample_timesteps(torch.Generator().manual_seed(9), 64, config, cdf=cdf)
    assert torch.equal(a, b)


LOSSES = [
    ("epsilon", dict(snr_gamma=5.0)),
    ("epsilon", dict(snr_gamma=5.0, use_soft_min_snr=True, soft_min_snr_sigma_data=0.5)),
    ("v_prediction", dict(snr_gamma=1.0)),
    ("sample", dict(snr_gamma=5.0)),  # min-SNR applies only to epsilon / v
    ("epsilon", dict(soft_min_snr_gamma=2.0)),
    ("epsilon", dict(loss_type="huber", huber_schedule="snr")),
    ("v_prediction", dict(loss_type="smooth_l1", huber_schedule="exponential", huber_c=0.3)),
    ("epsilon", dict(loss_type="huber", huber_schedule="constant")),
    ("epsilon", dict()),
]
LOSS_IDS = ["min_snr", "soft_min_curve", "v_min_snr", "sample", "soft_min_gamma", "huber_snr",
            "smooth_l1_exp", "huber_constant", "l2"]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("prediction,kwargs", LOSSES, ids=LOSS_IDS)
def test_diffusion_loss(prediction, kwargs, masked):
    rng = np.random.default_rng(2)
    pred = rng.standard_normal((4, 8, 8, 4), dtype=np.float32)
    target = rng.standard_normal((4, 8, 8, 4), dtype=np.float32)
    mask = (rng.random((4, 8, 8, 1)) > 0.3).astype(np.float32) if masked else None
    weight = rng.random(4).astype(np.float32)
    t = np.asarray([3, 250, 777, 999], np.int32)
    port_ac, ref_ac = _ladders(dict(beta_schedule="scaled_linear"))
    port = tl.diffusion_loss(
        torch.from_numpy(pred), torch.from_numpy(target), tl.LossConfig(prediction_type=prediction, **kwargs),
        timesteps=torch.from_numpy(t), alphas_cumprod=port_ac,
        mask=None if mask is None else torch.from_numpy(mask), loss_weight=torch.from_numpy(weight))
    ref = jl.diffusion_loss(
        jnp.asarray(pred), jnp.asarray(target), jl.LossConfig(prediction_type=prediction, **kwargs),
        timesteps=jnp.asarray(t), alphas_cumprod=jnp.asarray(ref_ac),
        mask=None if mask is None else jnp.asarray(mask), loss_weight=jnp.asarray(weight))
    # a mean over 256 weighted f32 terms, summed in another order: a few ulps
    np.testing.assert_allclose(float(port), float(ref), rtol=4 * RTOL)


def test_snr_weighting_needs_timesteps():
    x = torch.zeros(1, 2, 2, 1)
    with pytest.raises(ValueError, match="timesteps"):
        tl.diffusion_loss(x, x, tl.LossConfig(prediction_type="epsilon", snr_gamma=5.0))


def _fixed_denoise(module):
    """One deterministic 'model' for both packages: a fixed mix of the
    latents and a bounded function of the timestep."""
    def fn(latents, t):
        scale = 0.3 + 0.5 * module.sin(module.asarray(t, dtype=module.float32) / 997.0)
        return 0.9 * latents * scale + 0.05
    return fn


class _Jnp:
    sin, float32 = staticmethod(jnp.sin), jnp.float32
    asarray = staticmethod(jnp.asarray)


class _Torch:
    float32 = torch.float32

    @staticmethod
    def sin(x):
        return torch.sin(x)

    @staticmethod
    def asarray(x, dtype):
        return torch.as_tensor(x).to(dtype)


SAMPLERS = [
    ("ddim", dict(timestep_spacing="leading"), "epsilon"),
    ("ddim", dict(timestep_spacing="trailing"), "epsilon"),
    ("ddim", dict(set_alpha_to_one=False), "v_prediction"),
    ("ddim", dict(), "sample"),
    ("unipc", dict(), "epsilon"),
    ("unipc", dict(), "v_prediction"),
    ("unipc", dict(), "sample"),
]
SAMPLER_IDS = ["ddim_leading", "ddim_trailing", "ddim_v_no_alpha_one", "ddim_sample", "unipc_eps", "unipc_v",
               "unipc_sample"]
# every sampler on the SD ladder, and on the zero-SNR ladder except trailing
# DDIM with epsilon, whose first step (t = 999, alpha-bar 0) divides by zero
SAMPLER_CASES = [pytest.param(*case, SCHEDULES[1], id=f"{cid}-scaled_linear") for case, cid in zip(SAMPLERS, SAMPLER_IDS)]
SAMPLER_CASES += [pytest.param(*case, SCHEDULES[3], id=f"{cid}-zero_snr") for case, cid in zip(SAMPLERS, SAMPLER_IDS)
                  if cid != "ddim_trailing"]


@pytest.mark.parametrize("name,kwargs,prediction,schedule", SAMPLER_CASES)
def test_ddpm_samplers_match(name, kwargs, prediction, schedule):
    steps = 7
    if name == "ddim":
        port = DDIMScheduler.create(steps, tl.DDPMScheduleConfig(**schedule), prediction, **kwargs)
        ref = JaxDDIM.create(steps, jl.DDPMScheduleConfig(**schedule), prediction, **kwargs)
    else:
        port = UniPCScheduler.create_ddpm(steps, tl.DDPMScheduleConfig(**schedule), prediction)
        ref = JaxUniPC.create_ddpm(steps, jl.DDPMScheduleConfig(**schedule), prediction)
    np.testing.assert_array_equal(port.timesteps.numpy(), np.asarray(ref.timesteps))
    noise = np.random.default_rng(4).standard_normal((1, 8, 8, 4), dtype=np.float32)
    out = sample_loop(port, _fixed_denoise(_Torch), torch.from_numpy(noise)).numpy()
    expected = np.asarray(jax.jit(lambda n: jax_sample_loop(ref, _fixed_denoise(_Jnp), n))(jnp.asarray(noise)))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, expected, rtol=RTOL, atol=1e-6)


def test_family_schedule_configs_match():
    """The DDPM schedule and timestep-window configs the SDXL family builds."""
    from simpletuner_tpu.configuration import TrainingConfig as JaxConfig
    from simpletuner_tpu.models.sdxl import SDXL as JaxSDXL

    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.sdxl import SDXL

    for extra in ({}, {"rescale_betas_zero_snr": True}, {"refiner_training": True},
                  {"refiner_training": True, "refiner_training_invert_schedule": True,
                   "refiner_training_strength": 0.35},
                  {"timestep_bias_strategy": "range", "timestep_bias_begin": 100, "timestep_bias_end": 300,
                   "timestep_bias_multiplier": 2.0}):
        values = {"model_family": "sdxl", "model_arch_preset": "tiny", **extra}
        port, ref = SDXL(TrainingConfig(values)), JaxSDXL(JaxConfig(values))
        assert dataclasses.asdict(port.ddpm_schedule_config()) == dataclasses.asdict(ref.ddpm_schedule_config())
        assert dataclasses.asdict(port.timestep_sampling_config()) == \
            dataclasses.asdict(ref.timestep_sampling_config())
        np.testing.assert_allclose(port.alphas_cumprod.numpy(), np.asarray(ref.alphas_cumprod), rtol=RTOL, atol=1e-7)
