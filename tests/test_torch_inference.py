"""The torch port's render path against the JAX package, on the CPU.

Scheduler, sampling loop, VAE decoder and the whole slice (prompt encoded by
the tiny text encoders -> flow Euler loop over tiny Flux -> VAE decode ->
PNG) take the same numpy weights, embeds and noise on both sides.  The JAX
side builds its render batch from the embed payload's keys, as the JAX
``Validation`` does, so a render is unmasked even with
``flux_attention_masked_training``; one test runs the JAX ``Validation``
itself next to the port's.  Also: the inference entry point end to end in a
subprocess, its refusals, and a subprocess that proves the port imports
without JAX, Flax, Optax, Orbax, PIL or transformers.
"""

import copy
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

from simpletuner_tpu.models.flux.model import Flux as JaxFlux
from simpletuner_tpu.models.text_encoders import load_text_encoders as jax_load_text_encoders
from simpletuner_tpu.models.flux.transformer import FluxConfig as JaxFluxConfig
from simpletuner_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from simpletuner_tpu.models.vae import VAEConfig as JaxVAEConfig
from simpletuner_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from simpletuner_tpu.schedulers.flow_euler import flow_sigmas_for_training as jax_training_sigmas
from simpletuner_tpu.schedulers import classifier_free_guidance as jax_cfg
from simpletuner_tpu.schedulers import sample_loop as jax_sample_loop
from simpletuner_tpu.training.validation import Validation as JaxValidation
from simpletuner_tpu.training.validation import build_scheduler as jax_build_scheduler

from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime, load_inference_config
from simpletuner_tpu_torch.models.clip import clip_state_dict_from_flax
from simpletuner_tpu_torch.models.flux import Flux, FluxConfig
from simpletuner_tpu_torch.models.t5 import t5_state_dict_from_flax
from simpletuner_tpu_torch.models.text_encoders import load_text_encoders
from simpletuner_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from simpletuner_tpu_torch.schedulers import (
    FlowMatchEulerScheduler,
    classifier_free_guidance,
    flow_sigmas_for_training,
    sample_loop,
)
from simpletuner_tpu_torch.training.trainer import Trainer
from simpletuner_tpu_torch.training.validation import Validation, build_scheduler, noise_generator, write_png

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
        "tokenizer_max_length": 16,
    }
    values.update(extra)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(values))
    return str(path)


def _jax_batch(payload):
    """The JAX Validation's render batch: the payload's arrays under their own
    keys (validation.py:714-718), so the T5 mask stays ``attention_mask``."""
    batch = {"latents": jnp.zeros((1, 8, 8, 4))}
    batch.update({k: jnp.asarray(v)[None] for k, v in payload.items() if hasattr(v, "shape")})
    return batch


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

    vae = bridge(vae_vars, AutoencoderKL(VAEConfig.tiny(), torch.float32))
    z = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    ref_img = jax.jit(lambda p, x: jvae.apply(p, x, method=JaxAutoencoderKL.decode))(vae_vars, z)
    with torch.no_grad():
        img = vae.decode(t(z))
    assert img.shape == (1, 16, 16, 3)
    assert rel(img.numpy(), np.asarray(ref_img)) < 1e-4  # f32 convs, sum order only


def test_render_matches_jax_end_to_end(tmp_path):
    """Config -> prompt encoded -> runtime render -> PNG, against the JAX chain
    (inference_conditioning -> sample_loop -> VAE decode -> uint8) on the same
    weights, embeds and noise."""
    config_path = _config(tmp_path)
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=str(tmp_path / "out"), device="cpu")
    jmodel, flux_vars, jvae, vae_vars = _jax_weights(runtime.config)
    bridge(flux_vars, runtime.module)
    bridge(vae_vars, runtime.vae)
    (path,) = runtime.render(PROMPT, steps=4)
    image = np.asarray(Image.open(path))
    # latents are resolution/8 (as in JAX); the tiny VAE upsamples only x2
    assert image.shape == (16, 16, 3) and image.dtype == np.uint8

    batch = _jax_batch(runtime.model.encode_text([PROMPT])[0])
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
    """The runtime stores a LoRA model's base quantized (``create_train_state``)
    and renders it as the JAX runtime renders ``TrainState.variables()``:
    ``dequantize_params`` of ``quantize_params``' tree (bf16 kernels), with
    dense products."""
    from simpletuner_tpu.models import layers as jl
    from simpletuner_tpu.training.quantization import dequantize_params, quantize_params

    from simpletuner_tpu_torch.models.layers import LoRADense, dequantize_module, init_parameters
    from simpletuner_tpu_torch.models.weight_bridge import flax_variables

    config_path = _config(tmp_path, model_type="lora", lora_rank=4, base_model_precision=precision)
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=str(tmp_path / "out"), device="cpu")
    mode = runtime.model.base_precision
    dense = [m for m in runtime.module.modules() if isinstance(m, LoRADense)]
    assert dense and all(m.quant == mode for m in dense)
    # the base is the seeded initialisation through quantize_params, and what a
    # render uses is dequantize_params of it
    generator = torch.Generator().manual_seed(int(getattr(runtime.config, "seed", 42) or 42))
    initial = flax_variables(init_parameters(Flux(runtime.config).create_module(), generator))
    stored = quantize_params(initial, mode)
    got = flax_variables(runtime.module)
    expected = dequantize_params(stored)["params"]
    rebuilt = flax_variables(dequantize_module(copy.deepcopy(runtime.module)))["params"]
    for tree, mine in ((stored["params"], got["params"]), (stored["qscales"], got["qscales"]), (expected, rebuilt)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            value = mine
            for key in path:
                value = value[key.key]
            np.testing.assert_array_equal(np.asarray(value, np.float32), np.asarray(leaf, np.float32),
                                          err_msg=str(path))
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    try:
        jmodel, flux_vars, jvae, vae_vars = _jax_weights(runtime.config)  # installs the int8 matmul mode
        quantized = quantize_params(flux_vars, mode)
        rendered = dequantize_params(quantized)
        bridge(quantized, runtime.module)
        bridge(vae_vars, runtime.vae)
        (path,) = runtime.render(PROMPT, steps=4)
        image = np.asarray(Image.open(path)).astype(np.int32)
        batch = _jax_batch(runtime.model.encode_text([PROMPT])[0])
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
    against the negative prompt's embeds, both encoded by precompute_embeds."""
    config = load_inference_config(_config(
        tmp_path, validation_prompt=PROMPT, validation_guidance=4.0, validation_guidance_rescale=0.5,
        validation_negative_prompt="blurry"))
    jmodel, flux_vars, _, _ = _jax_weights(config, dataclasses.replace(JaxFluxConfig.tiny(), guidance_embed=False))
    model = Flux(config, dataclasses.replace(FluxConfig.tiny(), guidance_embed=False))
    Trainer(model, config, device="cpu").init_preprocessing_models()  # attaches the tiny text encoders
    module = bridge(flux_vars, model.create_module())
    validation = Validation(model, config, device="cpu")
    validation.precompute_embeds()
    out = validation._render_single(module, validation._embeds[0], 0)  # no decode_fn: latents

    cond = jmodel.inference_conditioning(_jax_batch(validation._embeds[0]))
    uncond = jmodel.inference_conditioning(_jax_batch(validation._negative_embeds))
    jsched = jax_build_scheduler(jmodel, config.validation_num_inference_steps, image_seq_len=16)

    # the JAX Validation's CFG settings: rescale, and CFG off while t is above
    # the validation_no_cfg_until_timestep threshold (default 2)
    rescale, no_cfg_t = JaxValidation(jmodel, config)._cfg_params(jsched)
    assert rescale == 0.5 and no_cfg_t is not None

    def sample(v, c, u, n):
        cond_fn, uncond_fn = jmodel.denoise_fn(v, c), jmodel.denoise_fn(v, u)
        return jax_sample_loop(jsched, lambda z, s: jax_cfg(cond_fn(z, s), uncond_fn(z, s),
                                                            jnp.where(s > no_cfg_t, 1.0, 4.0), rescale), n)

    noise = torch.randn((1, 8, 8, 4), generator=noise_generator(7, 0)).numpy()
    ref = np.asarray(jax.jit(sample)(flux_vars, cond, uncond, noise))[0]
    assert rel(out, ref) < 1e-4  # f32, 20 guided steps: only f32 sum order differs


def test_masked_training_flag_renders_unmasked_as_the_jax_validation(tmp_path, monkeypatch):
    """With flux_attention_masked_training the JAX Validation still renders
    unmasked: its batch carries the payload's ``attention_mask``, which
    ``inference_conditioning`` does not read.  The JAX Validation itself
    (precompute_embeds on the JAX tiny encoders, _render_single with the
    port's noise) against the port's on the same weights."""
    config = load_inference_config(_config(tmp_path, validation_prompt=PROMPT, validation_num_inference_steps=4))
    assert config.flux_attention_masked_training
    jmodel, flux_vars, jvae, vae_vars = _jax_weights(config)
    specs = [dataclasses.replace(s, max_length=16) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    jax_encoders = jax_load_text_encoders(specs, tiny=True)
    jmodel.attach_text_encoders(jax_encoders)
    decode = jax.jit(lambda z: jvae.apply(vae_vars, z, method=JaxAutoencoderKL.decode))
    jax_validation = JaxValidation(jmodel, config, decode_fn=decode, output_dir=str(tmp_path / "jax"))
    jax_validation.precompute_embeds()
    assert not jax_validation.disabled
    noise = torch.randn((1, 8, 8, 4), generator=noise_generator(7, 0)).numpy()
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    ref = jax_validation._render_single(flux_vars, jax_validation._embeds[0], 0).astype(np.int32)

    model = Flux(config)
    encoders = load_text_encoders(specs, tiny=True, device="cpu")
    encoders[0].model.load_state_dict(clip_state_dict_from_flax(jax_encoders[0].model.params))
    encoders[1].model.load_state_dict(t5_state_dict_from_flax(jax_encoders[1].model.params))
    model.attach_text_encoders(encoders)
    module = bridge(flux_vars, model.create_module())
    vae = bridge(vae_vars, AutoencoderKL(VAEConfig.tiny(), torch.float32))
    validation = Validation(model, config, decode_fn=vae.decode, device="cpu")
    validation.precompute_embeds()
    payload, jax_payload = validation._embeds[0], jax_validation._embeds[0]
    assert sorted(payload) == sorted(jax_payload) and np.array_equal(payload["attention_mask"],
                                                                      jax_payload["attention_mask"])
    assert 0 < payload["attention_mask"].sum() < payload["attention_mask"].size  # the mask would matter
    image = validation._render_single(module, payload, 0).astype(np.int32)
    # f32 both sides; uint8 truncation can flip a pixel by one level
    diff = np.abs(image - ref)
    assert diff.max() <= 1 and diff.mean() < 0.05

    # the check tells the two apart: the trainer's collated (masked) conditioning renders otherwise
    batch = {"latents": torch.zeros((1, 8, 8, 4))}
    batch.update({k: torch.as_tensor(v) for k, v in model.collate_text_embeds([payload]).items()})
    cond = model.inference_conditioning(batch)
    assert "t5_masks" in cond
    with torch.no_grad():
        latents = sample_loop(build_scheduler(model, 4, image_seq_len=16), model.denoise_fn(module, cond), t(noise))
        masked = vae.decode(latents / model.VAE_SCALING_FACTOR + model.VAE_SHIFT_FACTOR)[0]
    masked = ((masked + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).numpy().astype(np.int32)
    assert np.abs(masked - ref).max() > 1


def test_cli_end_to_end_writes_the_rendered_png(tmp_path):
    config_path = _config(tmp_path, mixed_precision="bf16", vae_dtype="bf16")
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
    with pytest.raises(FileNotFoundError):  # a configured model path must exist: never random weights
        CheckpointInferenceRuntime(config_path=_config(
            tmp_path, model_arch_preset=None, allow_untrained_init=False,
            pretrained_model_name_or_path=str(tmp_path / "missing")), device="cpu")
    with pytest.raises(ValueError):
        CheckpointInferenceRuntime(config_path=_config(
            tmp_path, model_arch_preset=None, allow_untrained_init=False), device="cpu")
    with pytest.raises(NotImplementedError):
        CheckpointInferenceRuntime(config_path=_config(tmp_path, model_family="deepfloyd"), device="cpu")
    # a quantized base needs a frozen one, as the JAX trainer's create_train_state says
    with pytest.raises(ValueError, match="model_type=lora"):
        CheckpointInferenceRuntime(config_path=_config(tmp_path, base_model_precision="int8-quanto"), device="cpu")
    # a checkpoint directory that does not exist is refused, never rendered as the base
    with pytest.raises(FileNotFoundError, match="checkpoint"):
        CheckpointInferenceRuntime(str(tmp_path / "checkpoint-9"), config_path=_config(tmp_path), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            CheckpointInferenceRuntime(config_path=_config(tmp_path), device="cuda")


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
