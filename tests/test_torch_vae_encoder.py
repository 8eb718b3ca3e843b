"""The port's VAE encoder against the JAX AutoencoderKL, on the CPU.

Seeded numpy weights (``torch_parity.numpy_variables``) for the tiny config
and the SDXL config go into the JAX module and, through the weight bridge,
into the port's; ``encode_moments`` and ``encode`` (the mean) take the same
image, at a non-square size that exercises the downsample conv's one-sided
padding.  f32 on both sides: relative L2 under 1e-5 (sum order only).  A
bf16 encoder is held to the JAX bf16 one within bf16 rounding, the logvar
clip is driven into both ends, and a sampled encode is checked against its
formula on the same draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpletuner_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from simpletuner_tpu.models.vae import VAEConfig as JaxVAEConfig

from simpletuner_tpu_torch.models.vae import AutoencoderKL, VAEConfig

from torch_parity import bridge, numpy_variables, rel


def _pair(name, dtype=torch.float32, seed=0):
    jcfg, cfg = getattr(JaxVAEConfig, name)(), getattr(VAEConfig, name)()
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jvae = JaxAutoencoderKL(jcfg, dtype=jdtype)
    variables = numpy_variables(jvae, np.zeros((1, 16, 16, 3), np.float32), seed=seed)
    return jvae, variables, bridge(variables, AutoencoderKL(cfg, dtype))


def _image(height, width, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (2, height, width, 3)).astype(np.float32)


@pytest.mark.parametrize("name,size", [("tiny", (24, 40)), ("sdxl", (64, 64)), ("sdxl", (48, 80))])
def test_encode_matches_jax(name, size):
    jvae, variables, vae = _pair(name)
    image = _image(*size)
    mean_ref, logvar_ref = jax.jit(lambda v, x: jvae.apply(v, x, method=JaxAutoencoderKL.encode_moments))(
        variables, image)
    latents_ref = jax.jit(lambda v, x: jvae.apply(v, x, method=JaxAutoencoderKL.encode))(variables, image)
    with torch.no_grad():
        mean, logvar = vae.encode_moments(torch.from_numpy(image))
        latents = vae.encode(torch.from_numpy(image))
    factor = vae.config.downscale_factor
    assert mean.shape == (2, size[0] // factor, size[1] // factor, vae.config.latent_channels)
    assert rel(mean.numpy(), np.asarray(mean_ref)) < 1e-5
    assert rel(logvar.numpy(), np.asarray(logvar_ref)) < 1e-5
    assert rel(latents.numpy(), np.asarray(latents_ref)) < 1e-5


def test_bf16_encode_matches_jax_bf16():
    jvae, variables, vae = _pair("tiny", torch.bfloat16)
    image = _image(32, 32)
    ref = jax.jit(lambda v, x: jvae.apply(v, x, method=JaxAutoencoderKL.encode))(variables, image)
    with torch.no_grad():
        out = vae.encode(torch.from_numpy(image))
    assert out.dtype == torch.bfloat16
    # both compute in bf16 with f32 norm statistics; the libraries round and sum in different orders
    assert rel(out.float().numpy(), np.asarray(ref, np.float32)) < 2e-2


@pytest.mark.parametrize("bias", [60.0, -60.0])
def test_logvar_clip_matches_jax(bias):
    """A quant_conv bias far outside [-30, 20] on the logvar half: both clip."""
    jvae, variables, vae = _pair("tiny")
    channels = vae.config.latent_channels
    variables["params"]["quant_conv"]["bias"] = np.concatenate(
        [np.zeros(channels, np.float32), np.full(channels, bias, np.float32)])
    bridge(variables, vae)
    image = _image(16, 16)
    _, logvar_ref = jvae.apply(variables, image, method=JaxAutoencoderKL.encode_moments)
    with torch.no_grad():
        _, logvar = vae.encode_moments(torch.from_numpy(image))
    clip = 20.0 if bias > 0 else -30.0
    assert torch.all(logvar == clip) and np.all(np.asarray(logvar_ref) == clip)


def test_sampled_encode_draws_from_the_generator():
    _, _, vae = _pair("tiny")
    image = torch.from_numpy(_image(16, 16))
    cfg = vae.config
    with torch.no_grad():
        mean, logvar = vae.encode_moments(image)
        sampled = vae.encode(image, generator=torch.Generator().manual_seed(3))
        again = vae.encode(image, generator=torch.Generator().manual_seed(3))
        noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(3))
    expected = (mean + torch.exp(0.5 * logvar) * noise - cfg.shift_factor) * cfg.scaling_factor
    assert torch.equal(sampled, again) and torch.allclose(sampled, expected, rtol=0, atol=1e-6)
    assert not torch.allclose(sampled, vae.encode(image))
