"""The torch port's render path against the JAX package, on the CPU.

Scheduler, sampling loop, VAE decoder and the whole slice (cached embeds ->
flow Euler loop over tiny Flux -> VAE decode -> PNG) take the same numpy
weights, embeds and noise on both sides.  Also: the inference entry point end
to end in a subprocess, its refusals, and a subprocess that proves the port
imports without JAX, Flax, Optax, Orbax, PIL or transformers.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from simpletuner_tpu.caching.text_embeds import TextEmbeddingCache
from simpletuner_tpu.data.backends.local import LocalDataBackend
from simpletuner_tpu.models.flux.model import Flux as JaxFlux
from simpletuner_tpu.models.flux.transformer import FluxConfig as JaxFluxConfig
from simpletuner_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from simpletuner_tpu.models.vae import VAEConfig as JaxVAEConfig
from simpletuner_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from simpletuner_tpu.schedulers.flow_euler import flow_sigmas_for_training as jax_training_sigmas
from simpletuner_tpu.schedulers import classifier_free_guidance as jax_cfg
from simpletuner_tpu.schedulers import sample_loop as jax_sample_loop
from simpletuner_tpu.training.validation import build_scheduler as jax_build_scheduler

from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime, load_inference_config, text_embed_cache
from simpletuner_tpu_torch.models.flux import Flux, FluxConfig
from simpletuner_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from simpletuner_tpu_torch.schedulers import (
    FlowMatchEulerScheduler,
    classifier_free_guidance,
    flow_sigmas_for_training,
    sample_loop,
)
from simpletuner_tpu_torch.training.validation import Validation, noise_generator, write_png

from torch_parity import bridge, numpy_variables, rel, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = "a lighthouse on a cliff at dusk"


# ---- schedulers ---------------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kwargs",
    [dict(shift=3.0), dict(shift=1.0), dict(use_dynamic_shifting=True, image_seq_len=4096),
     dict(use_dynamic_shifting=True, image_seq_len=256)],
)
def test_scheduler_sigmas_match_jax(kwargs):
    ours = FlowMatchEulerScheduler.create(7, **kwargs)
    ref = JaxScheduler.create(7, **kwargs)
    # f32 on both sides; linspace and the shift formulas round alike to 1 ulp
    np.testing.assert_allclose(ours.sigmas.numpy(), np.asarray(ref.sigmas), atol=1e-6)
    latents = np.random.default_rng(0).standard_normal((1, 4, 4, 2), dtype=np.float32)
    for ours_x, ref_x in (
        (ours.step(2, t(latents), t(latents)), ref.step(2, jnp.asarray(latents), jnp.asarray(latents))),
        (ours.add_noise(t(latents), t(2 * latents), 3), ref.add_noise(jnp.asarray(latents), jnp.asarray(2 * latents), 3)),
    ):
        np.testing.assert_allclose(ours_x.numpy(), np.asarray(ref_x), atol=1e-6)
    np.testing.assert_allclose(
        flow_sigmas_for_training(7).numpy(), np.asarray(jax_training_sigmas(7)), atol=1e-6
    )


def test_classifier_free_guidance_matches_jax():
    rng = np.random.default_rng(1)
    cond, uncond = (rng.standard_normal((2, 4, 4, 3), dtype=np.float32) for _ in range(2))
    for rescale in (0.0, 0.7):
        np.testing.assert_allclose(
            classifier_free_guidance(t(cond), t(uncond), 4.0, rescale).numpy(),
            np.asarray(jax_cfg(jnp.asarray(cond), jnp.asarray(uncond), 4.0, rescale)),
            atol=1e-5,
        )


# ---- the slice, tiny -----------------------------------------------------------------------------


def _config(tmp_path, **extra):
    values = {
        "model_family": "flux",
        "model_arch_preset": "tiny",
        "mixed_precision": "fp32",
        "vae_dtype": "fp32",
        "allow_untrained_init": True,
        "model_type": "full",  # adapters arrive with checkpoint loading (not ported)
        "validation_resolution": 64,
        "validation_seed": 7,
        "validation_guidance_real": 3.5,
        "flow_schedule_auto_shift": True,
        "flux_attention_masked_training": True,
        "data_backend_config": [
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": str(tmp_path / "text")},
        ],
    }
    values.update(extra)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(values))
    return str(path)


def _write_embeds(tmp_path, prompt=PROMPT, txt_len=12, valid=5, seed=0):
    rng = np.random.default_rng(seed)
    embeds = {
        "t5_embeds": rng.standard_normal((txt_len, 32), dtype=np.float32),
        "pooled_embeds": rng.standard_normal(32, dtype=np.float32),
        "attention_mask": (np.arange(txt_len) < valid).astype(np.int64),
    }
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(tmp_path / "text"), "flux")
    cache.save(prompt, embeds)
    return embeds


def _jax_weights(config, arch=None):
    """Numpy weights for tiny Flux and the tiny VAE, on the JAX trees."""
    model = JaxFlux(config, arch=arch)
    z = np.zeros
    flux_vars = numpy_variables(
        model.module, z((1, 16, 16), np.float32), z((1, 16, 3), np.int32), z((1, 12, 32), np.float32),
        z((1, 12, 3), np.int32), z(1, np.float32), z((1, 32), np.float32), z(1, np.float32), seed=1,
    )
    vae = JaxAutoencoderKL(JaxVAEConfig.tiny(), dtype=jnp.float32)
    vae_vars = numpy_variables(vae, z((1, 16, 16, 3), np.float32), seed=2)
    return model, flux_vars, vae, vae_vars


def test_sample_loop_and_vae_decode_match_jax(tmp_path):
    config = load_inference_config(_config(tmp_path))
    jmodel, flux_vars, jvae, vae_vars = _jax_weights(config)
    model = Flux(config)
    module = bridge(flux_vars, model.create_module())
    rng = np.random.default_rng(3)
    batch = {
        "latents": np.zeros((1, 8, 8, 4), np.float32),
        "t5_embeds": rng.standard_normal((1, 12, 32), dtype=np.float32),
        "pooled_embeds": rng.standard_normal((1, 32), dtype=np.float32),
        "t5_masks": (np.arange(12) < 5)[None].astype(np.int64),
    }
    noise = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)

    jcond = jmodel.inference_conditioning({k: jnp.asarray(v) for k, v in batch.items()})
    jsched = jax_build_scheduler(jmodel, 4, image_seq_len=16)
    ref = jax.jit(lambda v, c, n: jax_sample_loop(jsched, jmodel.denoise_fn(v, c), n))(flux_vars, jcond, noise)
    cond = model.inference_conditioning({k: t(v) for k, v in batch.items()})
    assert "t5_masks" in cond and "t5_masks" in jcond
    sched = FlowMatchEulerScheduler.create(4, use_dynamic_shifting=True, image_seq_len=16)
    with torch.no_grad():
        out = sample_loop(sched, model.denoise_fn(module, cond), t(noise))
    # f32, 4 Euler steps over 4 blocks: only f32 sum order differs
    assert rel(out.numpy(), np.asarray(ref)) < 1e-4

    vae = bridge(vae_vars, AutoencoderKL(VAEConfig.tiny(), torch.float32), ignore=("encoder", "quant_conv"))
    z = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    ref_img = jax.jit(lambda p, x: jvae.apply(p, x, method=JaxAutoencoderKL.decode))(vae_vars, z)
    with torch.no_grad():
        img = vae.decode(t(z))
    assert img.shape == (1, 16, 16, 3)
    assert rel(img.numpy(), np.asarray(ref_img)) < 1e-4  # f32 convs, sum order only


def test_render_matches_jax_end_to_end(tmp_path):
    """Config -> cached embeds -> runtime render -> PNG, against the JAX chain
    (inference_conditioning -> sample_loop -> VAE decode -> uint8) on the same
    weights and noise."""
    config_path = _config(tmp_path)
    embeds = _write_embeds(tmp_path)
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=str(tmp_path / "out"), device="cpu")
    jmodel, flux_vars, jvae, vae_vars = _jax_weights(runtime.config)
    bridge(flux_vars, runtime.module)
    bridge(vae_vars, runtime.vae, ignore=("encoder", "quant_conv"))
    (path,) = runtime.render(PROMPT, steps=4)
    image = np.asarray(Image.open(path))
    # latents are resolution/8 (as in JAX); the tiny VAE upsamples only x2
    assert image.shape == (16, 16, 3) and image.dtype == np.uint8

    batch = {
        "latents": jnp.zeros((1, 8, 8, 4)),
        "t5_embeds": jnp.asarray(embeds["t5_embeds"])[None],
        "pooled_embeds": jnp.asarray(embeds["pooled_embeds"])[None],
        "t5_masks": jnp.asarray(embeds["attention_mask"])[None],
    }
    noise = torch.randn((1, 8, 8, 4), generator=noise_generator(7, 0)).numpy()
    jsched = jax_build_scheduler(jmodel, 4, image_seq_len=16)

    def render(v, vae_v, cond, n):
        latents = jax_sample_loop(jsched, jmodel.denoise_fn(v, cond), n)
        z = latents / jmodel.VAE_SCALING_FACTOR + jmodel.VAE_SHIFT_FACTOR
        return jvae.apply(vae_v, z, method=JaxAutoencoderKL.decode)

    ref = np.asarray(jax.jit(render)(flux_vars, vae_vars, jmodel.inference_conditioning(batch), noise))[0]
    ref = np.clip((ref + 1.0) * 127.5, 0, 255).astype(np.uint8)
    # f32 both sides; uint8 truncation can flip a pixel by one level
    diff = np.abs(image.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and diff.mean() < 0.05


@pytest.mark.parametrize("precision", ["int8-quanto", "fp8-quanto", "int4-quanto"])
def test_render_on_a_quantized_base_matches_jax(tmp_path, precision):
    """The runtime quantizes a LoRA model's base and renders it as the JAX
    runtime renders ``TrainState.variables()``: ``dequantize_params`` of
    ``quantize_params``' tree (bf16 kernels), with dense products."""
    from simpletuner_tpu.models import layers as jl
    from simpletuner_tpu.training.quantization import dequantize_params, quantize_params

    from simpletuner_tpu_torch.models.layers import LoRADense, init_parameters
    from simpletuner_tpu_torch.models.weight_bridge import flax_variables

    config_path = _config(tmp_path, model_type="lora", lora_rank=4, base_model_precision=precision)
    embeds = _write_embeds(tmp_path)
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=str(tmp_path / "out"), device="cpu")
    mode = runtime.model.base_precision
    dense = [m for m in runtime.module.modules() if isinstance(m, LoRADense)]
    assert dense and all(m.quant is None and m.weight.dtype == torch.float32 for m in dense)
    # the base is the seeded initialisation through quantize_params and dequantize_params
    generator = torch.Generator().manual_seed(int(getattr(runtime.config, "seed", 42) or 42))
    initial = flax_variables(init_parameters(Flux(runtime.config).create_module(), generator))
    expected = dequantize_params(quantize_params(initial, mode))["params"]
    got = flax_variables(runtime.module)["params"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(expected)[0]:
        value = got
        for key in path:
            value = value[key.key]
        np.testing.assert_array_equal(value, np.asarray(leaf, np.float32), err_msg=str(path))
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    try:
        jmodel, flux_vars, jvae, vae_vars = _jax_weights(runtime.config)  # installs the int8 matmul mode
        rendered = dequantize_params(quantize_params(flux_vars, mode))
        bridge(rendered, runtime.module)
        bridge(vae_vars, runtime.vae, ignore=("encoder", "quant_conv"))
        (path,) = runtime.render(PROMPT, steps=4)
        image = np.asarray(Image.open(path)).astype(np.int32)
        batch = {
            "latents": jnp.zeros((1, 8, 8, 4)),
            "t5_embeds": jnp.asarray(embeds["t5_embeds"])[None],
            "pooled_embeds": jnp.asarray(embeds["pooled_embeds"])[None],
            "t5_masks": jnp.asarray(embeds["attention_mask"])[None],
        }
        noise = torch.randn((1, 8, 8, 4), generator=noise_generator(7, 0)).numpy()
        jsched = jax_build_scheduler(jmodel, 4, image_seq_len=16)

        def render(v, vae_v, cond, n):
            latents = jax_sample_loop(jsched, jmodel.denoise_fn(v, cond), n)
            z = latents / jmodel.VAE_SCALING_FACTOR + jmodel.VAE_SHIFT_FACTOR
            return jvae.apply(vae_v, z, method=JaxAutoencoderKL.decode)

        ref = np.asarray(jax.jit(render)(rendered, vae_vars, jmodel.inference_conditioning(batch), noise))[0]
    finally:
        jl.set_lora_target(previous[0])
        jl.set_quantized_matmul(previous[1])
    ref = np.clip((ref + 1.0) * 127.5, 0, 255).astype(np.int32)
    # f32 both sides; uint8 truncation can flip a pixel by one level
    diff = np.abs(image - ref)
    assert diff.max() <= 1 and diff.mean() < 0.05


def test_true_cfg_render_matches_jax(tmp_path):
    """A family without a guidance embedding (schnell) renders with true CFG
    against the cached negative prompt's embeds."""
    config = load_inference_config(_config(
        tmp_path, validation_prompt=PROMPT, validation_guidance=4.0, validation_guidance_rescale=0.5,
        validation_negative_prompt="blurry"))
    embeds = _write_embeds(tmp_path)
    negative = _write_embeds(tmp_path, prompt="blurry", valid=3, seed=1)
    jmodel, flux_vars, _, _ = _jax_weights(config, dataclasses.replace(JaxFluxConfig.tiny(), guidance_embed=False))
    model = Flux(config, dataclasses.replace(FluxConfig.tiny(), guidance_embed=False))
    module = bridge(flux_vars, model.create_module())
    validation = Validation(model, config)
    validation.load_embeds(text_embed_cache(config, "flux"))
    out = validation._render_single(module, validation._embeds[0], 0)  # no decode_fn: latents

    def batch(e):
        return {"latents": jnp.zeros((1, 8, 8, 4)), "t5_embeds": jnp.asarray(e["t5_embeds"])[None],
                "pooled_embeds": jnp.asarray(e["pooled_embeds"])[None],
                "t5_masks": jnp.asarray(e["attention_mask"])[None]}

    cond, uncond = jmodel.inference_conditioning(batch(embeds)), jmodel.inference_conditioning(batch(negative))
    jsched = jax_build_scheduler(jmodel, config.validation_num_inference_steps, image_seq_len=16)

    def sample(v, c, u, n):
        cond_fn, uncond_fn = jmodel.denoise_fn(v, c), jmodel.denoise_fn(v, u)
        return jax_sample_loop(jsched, lambda z, s: jax_cfg(cond_fn(z, s), uncond_fn(z, s), 4.0, 0.5), n)

    noise = torch.randn((1, 8, 8, 4), generator=noise_generator(7, 0)).numpy()
    ref = np.asarray(jax.jit(sample)(flux_vars, cond, uncond, noise))[0]
    assert rel(out, ref) < 1e-4  # f32, 20 guided steps: only f32 sum order differs


def test_cli_end_to_end_writes_the_rendered_png(tmp_path):
    config_path = _config(tmp_path, mixed_precision="bf16", vae_dtype="bf16")
    _write_embeds(tmp_path)
    out_dir = tmp_path / "cli"
    result = subprocess.run(
        [sys.executable, "-m", "simpletuner_tpu_torch.inference", "--config", config_path,
         "--prompt", PROMPT, "--output", str(out_dir), "--steps", "2", "--resolution", "32",
         "--seed", "11", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert result.returncode == 0, result.stderr[-2000:]
    path = result.stdout.strip().splitlines()[-1]
    assert path == str(out_dir / "validation" / "step_0_0.png")
    decoded = np.asarray(Image.open(path))

    runtime = CheckpointInferenceRuntime(config_path=config_path, output=str(tmp_path / "again"), device="cpu")
    (again,) = runtime.render(PROMPT, steps=2, resolution=32, seed=11)
    expected = np.asarray(Image.open(again))
    assert decoded.shape == (8, 8, 3)  # 32 px -> 4x4 latents -> tiny VAE x2
    # same seeds and weights; bf16 CPU matmuls may split sums by thread count
    assert np.abs(decoded.astype(np.int32) - expected.astype(np.int32)).max() <= 1


def test_refusals(tmp_path):
    with pytest.raises(FileNotFoundError):  # no cached embeds: never zeros
        CheckpointInferenceRuntime(_config(tmp_path), str(tmp_path), device="cpu").render("uncached", steps=1)
    with pytest.raises(NotImplementedError):
        CheckpointInferenceRuntime(_config(tmp_path, pretrained_model_name_or_path="/x"), device="cpu")
    with pytest.raises(ValueError):
        CheckpointInferenceRuntime(
            _config(tmp_path, model_arch_preset=None, allow_untrained_init=False), device="cpu")
    with pytest.raises(NotImplementedError):
        CheckpointInferenceRuntime(_config(tmp_path, model_family="sdxl"), device="cpu")
    # a quantized base needs a frozen one, as the JAX trainer's create_train_state says
    with pytest.raises(ValueError, match="model_type=lora"):
        CheckpointInferenceRuntime(_config(tmp_path, base_model_precision="int8-quanto"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            CheckpointInferenceRuntime(_config(tmp_path), device="cuda")


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 6), (3, 2, 4)])
def test_png_writer_round_trips(tmp_path, shape):
    image = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, image)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), image)


def test_port_imports_without_jax_flax_optax_orbax_pil_transformers():
    code = """
import importlib, pkgutil, sys
BLOCKED = ("jax", "flax", "optax", "orbax", "PIL", "transformers")
for name in BLOCKED:
    sys.modules[name] = None
import simpletuner_tpu_torch
names = [m.name for m in pkgutil.walk_packages(simpletuner_tpu_torch.__path__, "simpletuner_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = [m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print(len(names))
"""
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-2000:]
    assert int(result.stdout.strip()) >= 15
