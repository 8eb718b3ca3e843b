"""The torch port's SDXL family against the JAX package, on the CPU.

The family contract (time ids from the collate's sizes, the refiner's five
ids, the added conditioning), ``encode_text`` on the tiny CLIP-L and CLIP-G,
the diffusers-layout UNet import, adapter files in both layouts, the DDPM
train step with injected noise and timesteps under min-SNR weighting, the
JAX ``Trainer`` against the port's on one cache, and a true-CFG DDIM
validation render: the same seeded numpy weights, inputs and noise go
through both packages.  Every tolerance is stated where it is checked.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.sdxl.model import SDXL as JaxSDXL
from simpletuner_tpu.models.text_encoders import load_text_encoders as jax_load_text_encoders
from simpletuner_tpu.models.weight_import import load_unet_params as jax_load_unet_params
from simpletuner_tpu.training.lora import flatten_lora
from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora
from simpletuner_tpu.training.lora import save_lora_safetensors as jax_save_lora
from simpletuner_tpu.training.lora import unet_key_map as jax_unet_key_map
from simpletuner_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from simpletuner_tpu.training.schedules import get_lr_schedule as jax_get_lr_schedule
from simpletuner_tpu.training.train_state import build_train_step as jax_build_train_step
from simpletuner_tpu.training.train_state import create_train_state as jax_create_train_state
from simpletuner_tpu.training.validation import Validation as JaxValidation
from simpletuner_tpu.training.validation import build_scheduler as jax_build_scheduler

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import unet_checkpoint_shapes
from simpletuner_tpu_torch.models.clip import clip_state_dict_from_flax
from simpletuner_tpu_torch.models.layers import init_adapters
from simpletuner_tpu_torch.models.sdxl import SDXL
from simpletuner_tpu_torch.models.text_encoders import load_text_encoders
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params, lora_to_flax
from simpletuner_tpu_torch.models.weight_import import load_safetensors_file, load_transformer_params, load_unet_params
from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors, unet_key_map
from simpletuner_tpu_torch.training.optimizers import get_optimizer
from simpletuner_tpu_torch.training.schedules import get_lr_schedule
from simpletuner_tpu_torch.training.train_state import build_train_step, create_train_state
from simpletuner_tpu_torch.training.validation import Validation, build_scheduler, noise_generator

from test_torch_quantization import _flat, _sync
from test_torch_weight_import import _assert_trees_bitwise, _seeded
from torch_parity import bridge, fill_numpy, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# gradients and what an AdamW step makes of them: f32 LoRA gradients through
# the whole UNet are 2-3e-5 off a float64 reference on either side
# (test_torch_unet.py), and Adam divides each gradient element by its own
# size, so an element whose gradient is f32 noise (measured: one element of
# a 256-element adapter, 1.5e-8 against 6.7e-8) moves by a different fraction
# of the learning rate on the two sides; grad norms and adapters are held to 1e-4
GRAD_REL = 1e-4
PROMPTS = ["a lighthouse on a basalt cliff at dusk", "", "portrait of a cat"]
BATCH, LATENT, TXT = 2, 8, 12
RENDER_PROMPT = "a seeded lighthouse"


@pytest.fixture(autouse=True)
def _restore_jax_globals():
    """Building a JAX model family installs a process-wide LoRA target
    predicate and int8 matmul mode."""
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jl.set_lora_target(None)
    yield
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])


def _pair(values):
    return JaxSDXL(JaxTrainingConfig(values)), SDXL(config_namespace(values))


def _tiny_values(**extra):
    return {"model_family": "sdxl", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


# ---- the family contract -------------------------------------------------------------------------


@pytest.mark.parametrize("flavour", ["base-1.0", "refiner-1.0"])
def test_model_inputs_match_jax(flavour):
    """get_model_inputs from the collate's sizes, from explicit time ids and
    from the config's resolution; inference_conditioning's time ids."""
    jmodel, model = _pair(_tiny_values(model_flavour=flavour, data_aesthetic_score=6.5, resolution=512))
    rng = np.random.default_rng(0)
    base = {"noisy_latents": rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
            "timesteps": np.asarray([10, 900], np.int32),
            "text_embeds": rng.standard_normal((2, 9, 96), dtype=np.float32),
            "pooled_embeds": rng.standard_normal((2, model._pooled_dim), dtype=np.float32)}
    sizes = {"original_sizes": np.asarray([[512, 640], [700, 512]], np.int32),
             "crop_coordinates": np.asarray([[0, 32], [16, 0]], np.int32),
             "target_sizes": np.asarray([[512, 512], [512, 512]], np.int32)}
    for extra in ({}, sizes, {"time_ids": rng.standard_normal((2, model._num_time_ids), dtype=np.float32)}):
        batch = {**base, **extra}
        ours = model.get_model_inputs({k: t(v) for k, v in batch.items()})
        theirs = jmodel.get_model_inputs({k: jnp.asarray(v) for k, v in batch.items()})
        assert sorted(ours) == sorted(theirs)
        for key in theirs:
            np.testing.assert_allclose(ours[key].numpy(), np.asarray(theirs[key]), rtol=1e-6, atol=1e-6)
    assert model._pooled_dim == jmodel._pooled_dim == (64 if flavour == "base-1.0" else 72)
    cond = model.inference_conditioning({**{k: t(v) for k, v in base.items()}, "latents": t(base["noisy_latents"])})
    jcond = jmodel.inference_conditioning({**{k: jnp.asarray(v) for k, v in base.items()},
                                           "latents": jnp.asarray(base["noisy_latents"])})
    np.testing.assert_array_equal(cond["time_ids"].numpy(), np.asarray(jcond["time_ids"]))


def test_contract_and_refusals():
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR", "DDPM_BETA_START", "DDPM_BETA_END",
                 "DDPM_BETA_SCHEDULE"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch)
    assert not model.is_flow and model.latent_channels == 4
    with pytest.raises(ValueError, match="epsilon"):
        SDXL(config_namespace(_tiny_values(prediction_type="flow_matching"))).check_user_config()
    with pytest.raises(NotImplementedError, match="item 7"):
        model.model_predict(None, {"control_latents": torch.zeros(1)})
    with pytest.raises(NotImplementedError, match="item 4i"):
        model.tokenize_captions(["a"])
    staged = SDXL(config_namespace(_tiny_values(sdxl_validation_pipeline_mode="full-pipeline",
                                                validation_prompt="a")))
    assert staged.supports_multistage_validation()
    with pytest.raises(NotImplementedError, match="item 4d"):
        Validation(staged, staged.config, device="cpu")


@pytest.mark.parametrize("scheduler", ["ddim", "unipc"])
def test_build_scheduler_matches_jax(scheduler):
    values = _tiny_values(validation_noise_scheduler=scheduler, rescale_betas_zero_snr=True,
                          prediction_type="v_prediction")
    jmodel, model = _pair(values)
    ours, theirs = build_scheduler(model, 12), jax_build_scheduler(jmodel, 12)
    assert type(ours).__name__ == type(theirs).__name__ and ours.prediction_type == "v_prediction"
    np.testing.assert_array_equal(ours.timesteps.numpy(), np.asarray(theirs.timesteps))
    ladder = "alphas_cumprod" if scheduler == "ddim" else "lambdas"
    np.testing.assert_allclose(getattr(ours, ladder).numpy(), np.asarray(getattr(theirs, ladder)),
                               rtol=1e-6, atol=1e-6)


# ---- text encoding --------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoders():
    """The JAX package's tiny CLIP-L and CLIP-G (20 tokens) and the port's
    modules with their params."""
    specs = [dataclasses.replace(s, max_length=20) for s in SDXL.TEXT_ENCODER_CONFIGURATION]
    jax_encoders = jax_load_text_encoders(specs, tiny=True)
    ports = load_text_encoders(specs, tiny=True, device="cpu")
    for port, theirs in zip(ports, jax_encoders):
        port.model.load_state_dict(clip_state_dict_from_flax(theirs.model.params))
    return jax_encoders, ports


def test_encode_text_matches_jax(encoders):
    """CLIP-L seq ++ CLIP-G seq on the channels, CLIP-G pooled, CLIP-L's mask."""
    jmodel, model = _pair(_tiny_values())
    jmodel.attach_text_encoders(encoders[0])
    model.attach_text_encoders(encoders[1])
    ours, theirs = model.encode_text(PROMPTS), jmodel.encode_text(PROMPTS)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "pooled_embeds", "text_embeds"]
        assert a["text_embeds"].shape == (20, 96) and a["pooled_embeds"].shape == (64,)
        np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
        for key in ("text_embeds", "pooled_embeds"):
            assert a[key].dtype == b[key].dtype == np.float32
            assert np.abs(a[key] - b[key]).max() <= F32_REL * max(np.abs(b[key]).max(), 1.0), key
    collated = model.collate_text_embeds(ours)
    assert collated["text_embeds"].shape == (3, 20, 96) and sorted(collated) == ["pooled_embeds", "text_embeds"]


# ---- weight import and adapter files ---------------------------------------------------------------


def test_unet_import_matches_jax_bitwise(tmp_path):
    """A seeded tiny_xl diffusers UNet (two shards in ``unet/``): the port's
    tree is bitwise the JAX ``load_unet_params`` tree, the imported module
    bitwise the bridged JAX tree, and the layout the JAX import test's writer's."""
    values = _tiny_values()
    jmodel, model = _pair(values)
    weights = _seeded(unet_checkpoint_shapes(model.arch), seed=4, dtype="f32")
    root = tmp_path / "sdxl" / "unet"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: weights[k] for k in part}, str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_unet_params(jmodel, str(tmp_path / "sdxl"))
    _assert_trees_bitwise(load_unet_params(model, str(tmp_path / "sdxl")), theirs)
    ours = load_transformer_params(model, init_adapters(model.create_module()), str(tmp_path / "sdxl"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name
    from test_unet_import import _params_to_diffusers

    written = _params_to_diffusers(jax.tree_util.tree_map(np.asarray, theirs), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in written.items()} == unet_checkpoint_shapes(model.arch)


def _seeded_adapters(model, seed, scale=1.0):
    module = tl.init_parameters(model.create_module(), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for param in tl.lora_parameters(module).values():
            param.copy_(torch.from_numpy(scale * rng.standard_normal(tuple(param.shape)).astype(np.float32)))
    return module


@pytest.mark.parametrize("fmt", ["diffusers", "comfyui"])
def test_adapter_files_round_trip_with_jax(tmp_path, fmt):
    """Port -> JAX -> port bitwise in the diffusers layout (``unet.`` keys of
    ``unet_key_map``).  A ComfyUI file carries the same tensors under
    ``diffusion_model.`` keys; the JAX loader maps those to ``transformer.``
    and so finds none of a UNet's adapters (ROADMAP Queue 3), and the port
    mirrors it."""
    values = _tiny_values(lora_alpha=8)
    jmodel, model = _pair(values)
    assert unet_key_map(model.arch) == jax_unet_key_map(jmodel.arch)
    module = _seeded_adapters(model, 1)
    original = {k: v.detach().clone() for k, v in tl.lora_parameters(module).items()}
    first, second = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    save_lora_safetensors(model, module, first, format=fmt)
    jax_save_lora(jmodel, lora_to_flax(module), second, format=fmt)
    ours, theirs = load_safetensors_file(first), load_safetensors_file(second)
    assert sorted(ours) == sorted(theirs) and all(torch.equal(ours[k], theirs[k]) for k in theirs)
    template = lora_to_flax(_seeded_adapters(model, 9))
    loaded = jax_load_lora(jmodel, first, template)
    fresh = _seeded_adapters(model, 2)
    kept = {k: v.detach().clone() for k, v in tl.lora_parameters(fresh).items()}
    missing = load_lora_safetensors(model, second, fresh)
    back = {k: v.detach() for k, v in tl.lora_parameters(fresh).items()}
    if fmt == "diffusers":
        assert any(k.startswith("unet.down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.") for k in ours)
        expected, got = flatten_lora(lora_to_flax(module)), flatten_lora(loaded)
        assert all(np.array_equal(got[p][leaf], a) for p, leaves in expected.items() for leaf, a in leaves.items())
        assert missing == [] and all(torch.equal(back[k], original[k]) for k in original)
    else:
        assert all(k.startswith("diffusion_model.") for k in ours)
        expected, got = flatten_lora(template), flatten_lora(loaded)
        assert all(np.array_equal(got[p][leaf], a) for p, leaves in expected.items() for leaf, a in leaves.items())
        assert len(missing) == len(expected) and all(torch.equal(back[k], kept[k]) for k in kept)


# ---- the DDPM LoRA train step ----------------------------------------------------------------------


def _train_values(steps, **extra):
    return _tiny_values(optimizer="adamw", learning_rate=1e-3, adam_weight_decay=0.01, max_grad_norm=1.0,
                        lr_scheduler="constant", max_train_steps=steps, **extra)


def _batches(seed, steps):
    rng = np.random.default_rng(seed)
    batch = {"latents": rng.standard_normal((BATCH, LATENT, LATENT, 4), dtype=np.float32),
             "text_embeds": rng.standard_normal((BATCH, TXT, 96), dtype=np.float32),
             "pooled_embeds": rng.standard_normal((BATCH, 64), dtype=np.float32),
             "original_sizes": np.asarray([[64, 64], [80, 64]], np.int32),
             "crop_coordinates": np.asarray([[0, 0], [8, 0]], np.int32),
             "target_sizes": np.asarray([[64, 64], [64, 64]], np.int32)}
    noises = rng.standard_normal((steps, BATCH, LATENT, LATENT, 4), dtype=np.float32)
    timesteps = rng.integers(0, 1000, (steps, BATCH)).astype(np.int32)
    return [{**batch, "override_noise": noises[i], "override_timesteps": timesteps[i]} for i in range(steps)]


def test_lora_train_steps_match_jax():
    """4 LoRA steps on the same seeded base and adapters, noise and
    timesteps injected, each port step started from the JAX state (adapters
    and Adam moments, ``_sync``): the loss per step within 1e-5 relative,
    the grad norm within ``GRAD_REL``, and the adapters after each step
    within ``GRAD_REL`` in relative L2 over all adapters."""
    # v-prediction on the zero-SNR ladder; epsilon with min-SNR runs through
    # both trainers in test_trainer_matches_jax
    extra = {"prediction_type": "v_prediction", "snr_gamma": 1.0, "rescale_betas_zero_snr": True}
    steps = 4
    values = _train_values(steps, **extra)
    batches = _batches(7, steps)
    jax_model = JaxSDXL(JaxTrainingConfig(values))
    jax_model.alphas_cumprod  # made concrete here: the JAX family caches it on first use, traced or not
    shapes = jax.eval_shape(lambda: jax_model.init_params(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batches[0].items() if not k.startswith("override")}))
    variables = fill_numpy(shapes, seed=11)
    jconfig = JaxTrainingConfig(values)
    schedule_j = jax_get_lr_schedule(jconfig, steps)
    tx_j = jax_get_optimizer(jconfig, schedule_j)
    state_j = jax_create_train_state(jax_model, jax.tree_util.tree_map(jnp.asarray, variables), tx_j)
    step_j = jax.jit(jax_build_train_step(jax_model, tx_j, schedule_j))
    model = SDXL(config_namespace(values))
    schedule_t = get_lr_schedule(model.config, steps)
    tx_t = get_optimizer(model.config, schedule_t)
    state_t = create_train_state(model, bridge(variables, model.create_module()), tx_t)
    step_t = build_train_step(model, tx_t, schedule_t)
    assert set(_flat(lora_to_flax(state_t.module))) == set(_flat(state_j.trainable["lora"]))
    for i, batch in enumerate(batches):
        _sync(state_t, state_j)
        state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(i))
        state_t, m_t = step_t(state_t, {k: t(v) for k, v in batch.items()}, torch.Generator())
        for key, bound in (("loss", F32_REL), ("grad_norm", GRAD_REL)):
            ours, theirs = float(m_t[key]), float(m_j[key])
            assert abs(ours - theirs) <= bound * abs(theirs), (i, key, ours, theirs)
        final_j, final_t = _flat(state_j.trainable["lora"]), _flat(lora_to_flax(state_t.module))
        keys = sorted(final_j)
        assert rel(np.concatenate([final_t[k].ravel() for k in keys]),
                   np.concatenate([np.asarray(final_j[k]).ravel() for k in keys])) < GRAD_REL, i


def test_prepare_batch_draws_timesteps_from_the_family_weights():
    """Without overrides the port draws int32 timesteps from the family's
    weights (here the refiner's window [0, 200)) and builds the epsilon
    target and the noisy latents from them."""
    model = SDXL(config_namespace(_tiny_values(refiner_training=True)))
    latents = torch.randn(64, 4, 4, 4, generator=torch.Generator().manual_seed(0))
    prepared = model.prepare_batch(torch.Generator().manual_seed(1), {"latents": latents})
    assert prepared["timesteps"].dtype == torch.int32 and int(prepared["timesteps"].max()) < 200
    assert torch.equal(prepared["target"], prepared["noise"])
    ac = model.alphas_cumprod[prepared["timesteps"].long()].view(-1, 1, 1, 1)
    torch.testing.assert_close(prepared["noisy_latents"], ac.sqrt() * latents + (1 - ac).sqrt() * prepared["noise"])


# ---- the trainer ---------------------------------------------------------------------------------


def _overriding_ddpm(original):
    """``next_batch`` with the same numpy noise and timesteps for step ``step`` on both sides."""

    def next_batch(self, step=0):
        batch = dict(original(self, step=step))
        rng = np.random.default_rng(2000 + step)
        batch["override_noise"] = rng.standard_normal(batch["latents"].shape).astype(np.float32)
        batch["override_timesteps"] = rng.integers(0, 1000, batch["latents"].shape[0]).astype(np.int32)
        return batch

    return next_batch


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The JAX ``Trainer`` and the port's on one cache: tiny SDXL from one
    seeded diffusers UNet, warm-started from one seeded adapter, 4 steps of
    min-SNR (gamma 5) epsilon training with the same noise and timesteps.
    The port's run also renders its final validation (true CFG, DDIM), and
    ``run_inference`` renders from its ``checkpoint-4``."""
    from simpletuner_tpu_torch import inference
    from simpletuner_tpu.data.dataset import MultiDatasetIterator as JaxIterator
    from simpletuner_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from simpletuner_tpu.training import trainer as jax_trainer_module
    from simpletuner_tpu.training.trainer import Trainer as JaxTrainer

    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
    from simpletuner_tpu_torch.data.dataset import MultiDatasetIterator
    from simpletuner_tpu_torch.models.weight_import import save_safetensors
    from simpletuner_tpu_torch.training.trainer import Trainer

    from test_torch_trainer import _values, _write_images

    root = tmp_path_factory.mktemp("sdxl_trainer")
    _write_images(root / "data")
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    values = lambda out, **extra: _values(root, out, model_family="sdxl", snr_gamma=5.0, **extra)  # noqa: E731
    port_model = SDXL(config_namespace(values("x")))
    unet_path = str(root / "unet.safetensors")
    save_safetensors(_seeded(unet_checkpoint_shapes(port_model.arch), seed=3, dtype="f32"), unet_path)
    lora_path = str(root / "init_lora.safetensors")
    # every A and B nonzero, at the Flux trainer test's scale
    save_lora_safetensors(port_model, _seeded_adapters(port_model, 4, scale=0.05), lora_path)
    extra = {"pretrained_model_name_or_path": unet_path, "init_lora": lora_path}
    # the captions' payloads, cached before either run (the tiny tokenizer's
    # salted hash would give every process other embeds)
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "sdxl")
    rng = np.random.default_rng(5)
    for i in range(4):
        cache.save(f"photo {i}", {"text_embeds": rng.standard_normal((16, 96)).astype(np.float32),
                                  "pooled_embeds": rng.standard_normal(64).astype(np.float32)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_module, "build_mesh", lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        mp.setattr(JaxIterator, "next_batch", _overriding_ddpm(JaxIterator.next_batch))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(values("jax", **extra)))
        jax_trainer.run()
        mp.setattr(MultiDatasetIterator, "next_batch", _overriding_ddpm(MultiDatasetIterator.next_batch))
        render = {"validation_prompt": RENDER_PROMPT, "validation_resolution": 64, "validation_guidance": 7.5,
                  "validation_num_inference_steps": 3, "disable_benchmark": True}
        port_trainer = Trainer(config=values("port", **extra, **render), device="cpu")
        port_trainer.run()
        config_path = root / "render_config.json"
        config_path.write_text(json.dumps(values("unused", **extra, **render)))
        assert inference.run_inference(checkpoint=str(root / "port" / "checkpoint-4"), prompt=RENDER_PROMPT,
                                       config_path=str(config_path), output=str(root / "port_render"), steps=3,
                                       resolution=64, seed=42, device="cpu") == 0
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])
    return root, jax_trainer, port_trainer


def test_trainer_matches_jax(trainer_runs):
    """4 steps, no state shared between the runs: per-step loss within 1e-5
    relative (the Flux trainer test's ``TRAJECTORY_TOL``), grad norm within
    ``GRAD_REL``; the LoRA export holds the JAX ``unet_key_map`` names and
    matches the JAX export within ``GRAD_REL`` in relative L2 over all
    adapters."""
    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    root, jax_trainer, port_trainer = trainer_runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [1, 2, 3, 4]
    for a, b in zip(ours, theirs):
        assert abs(a["loss"] - b["loss"]) <= TRAJECTORY_TOL * max(1.0, abs(b["loss"])), (a["step"], a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_REL * abs(b["grad_norm"]), (a["step"], a, b)
    export = "checkpoint-4/pytorch_lora_weights.safetensors"
    mine, jax_file = load_safetensors_file(str(root / "port" / export)), load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file)
    modules = {k.removeprefix("unet.").rsplit(".lora_", 1)[0] for k in mine}
    names = {v for k, v in jax_unet_key_map(jax_trainer.model.arch).items() if not k.endswith(("proj_in", "proj_out"))}
    assert modules == names
    keys = sorted(mine)
    assert rel(np.concatenate([mine[k].numpy().ravel() for k in keys]),
               np.concatenate([jax_file[k].numpy().ravel() for k in keys])) < GRAD_REL
    with open(root / "port" / "checkpoint-4" / "trainer_state.json") as a, \
            open(root / "jax" / "checkpoint-4" / "trainer_state.json") as b:
        assert json.load(a) == json.load(b)
    assert port_trainer.model.NAME == "sdxl" and port_trainer.vae.config.latent_channels == 4


def test_checkpoint_inference_renders_the_final_validation(trainer_runs):
    """``run_inference`` from the SDXL run's checkpoint-4 renders its final
    validation image (true CFG, DDIM) byte for byte."""
    root = trainer_runs[0]
    final = root / "port" / "validation" / "step_4_0.png"
    rendered = root / "port_render" / "validation" / "step_4_0.png"
    assert final.read_bytes() == rendered.read_bytes() and len(final.read_bytes()) > 100


# ---- validation render ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheduler", ["ddim", "unipc"])
def test_cfg_render_matches_jax(encoders, monkeypatch, scheduler):
    """A true-CFG render through each package's ``Validation``: prompt and
    negative prompt encoded by the tiny encoders (the JAX ones' params in the
    port's modules), the same weights and noise, 6 guided DDPM steps (DDIM,
    the default, or UniPC) with rescale and the no-CFG threshold."""
    config = _tiny_values(model_type="full", validation_prompt=PROMPTS[0], validation_negative_prompt="blurry",
                          validation_guidance=7.5, validation_guidance_rescale=0.3,
                          validation_no_cfg_until_timestep=1, validation_num_inference_steps=6,
                          validation_resolution=64, validation_seed=7, tokenizer_max_length=20,
                          validation_noise_scheduler=scheduler)
    jmodel, model = _pair(config)
    jmodel.attach_text_encoders(encoders[0])
    model.attach_text_encoders(encoders[1])
    jmodel.alphas_cumprod  # made concrete here: the JAX family caches it on first use, traced or not
    shapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jmodel.example_batch(1, 64)))
    variables = fill_numpy(shapes, seed=3)
    module = bridge(variables, model.create_module())

    validation = Validation(model, config_namespace(config), device="cpu")
    validation.precompute_embeds()
    assert validation._wants_cfg() and validation._negative_embeds is not None
    out = validation._render_single(module, validation._embeds[0], 0)  # no decode_fn: the latents
    noise = torch.randn((1, 8, 8, 4), generator=noise_generator(7, 0)).numpy()
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    jvalidation = JaxValidation(jmodel, JaxTrainingConfig(config))
    jvalidation.precompute_embeds()
    for ours, theirs in ((validation._embeds[0], jvalidation._embeds[0]),
                         (validation._negative_embeds, jvalidation._negative_embeds)):
        assert rel(ours["text_embeds"], theirs["text_embeds"]) < F32_REL
    ref = np.asarray(jvalidation._render_single(variables, jvalidation._embeds[0], 0))
    assert out.shape == ref.shape == (8, 8, 4) and np.isfinite(out).all()
    assert rel(out, ref) < 1e-4  # the render tolerance of test_torch_inference.py (f32, sum order only)
