"""The torch port's PixArt-Sigma family against the JAX package, on the CPU.

The diffusers sincos table, the DiT forward and its LoRA gradients (the
learned-range head, head dim 72, remat), the family
contract and its refusals, ``encode_text`` on the tiny T5, the diffusers
import, adapter files, the JAX ``Trainer`` against the port's on one cache
(and ``run_inference`` from the port's checkpoint), and a true-CFG DDIM
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
from simpletuner_tpu.models.pixart.model import PixartSigma as JaxPixartSigma
from simpletuner_tpu.models.pixart.transformer import PixartConfig as JaxPixartConfig
from simpletuner_tpu.models.pixart.transformer import PixartTransformer as JaxPixartTransformer
from simpletuner_tpu.models.pixart.transformer import sincos_pos_embed_2d as jax_sincos
from simpletuner_tpu.models.text_encoders import load_text_encoders as jax_load_text_encoders
from simpletuner_tpu.models.weight_import import load_pixart_params as jax_load_pixart_params
from simpletuner_tpu.training.lora import flatten_lora
from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora
from simpletuner_tpu.training.lora import pixart_key_map as jax_pixart_key_map
from simpletuner_tpu.training.lora import save_lora_safetensors as jax_save_lora
from simpletuner_tpu.training.validation import Validation as JaxValidation
from simpletuner_tpu.training.validation import build_scheduler as jax_build_scheduler

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import pixart_checkpoint_shapes
from simpletuner_tpu_torch.models.layers import init_adapters
from simpletuner_tpu_torch.models.pixart import PixartConfig, PixartSigma, PixartTransformer, sincos_pos_embed_2d
from simpletuner_tpu_torch.models.registry import get_model_family
from simpletuner_tpu_torch.models.t5 import t5_state_dict_from_flax
from simpletuner_tpu_torch.models.text_encoders import load_text_encoders
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params, lora_to_flax
from simpletuner_tpu_torch.models.weight_import import (
    load_pixart_params, load_safetensors_file, load_transformer_params,
)
from simpletuner_tpu_torch.training.lora import load_lora_safetensors, pixart_key_map, save_lora_safetensors
from simpletuner_tpu_torch.training.validation import Validation, build_scheduler, noise_generator

from test_torch_weight_import import _assert_trees_bitwise, _seeded
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# gradient-derived numbers (test_torch_sdxl.py: f32 gradients through a deep
# net are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
PROMPTS = ["a lighthouse on a basalt cliff at dusk", "", "portrait of a cat"]
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


def _tiny_values(**extra):
    return {"model_family": "pixart_sigma", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxPixartSigma(JaxTrainingConfig(values)), PixartSigma(config_namespace(values))


# ---- the transformer ------------------------------------------------------------------------------


@pytest.mark.parametrize("config, grid", [
    (PixartConfig.sigma_1024(), (64, 64)),  # 1024 px: base 64, interpolation 2
    (PixartConfig.sigma_512(), (32, 32)),
    (PixartConfig.sigma_1024(), (48, 80)),  # an aspect bucket off the base grid
])
def test_sincos_table_matches_jax(config, grid):
    """The diffusers table at the presets' ``base_size`` and
    ``interpolation_scale``: float64 bitwise, and the bf16 table the module
    adds bitwise ``jnp.asarray(table, bfloat16)``."""
    ours = sincos_pos_embed_2d(config.hidden_size, *grid, config.base_size, config.interpolation_scale)
    theirs = jax_sincos(config.hidden_size, *grid, config.base_size, config.interpolation_scale)
    assert ours.dtype == np.float64 and ours.shape == theirs.shape == (grid[0] * grid[1], 1152)
    np.testing.assert_array_equal(ours, theirs)
    module = PixartTransformer(dataclasses.replace(config, depth=0))
    table = module.position_table(*grid, "cpu")
    assert table.dtype == torch.bfloat16 and module.position_table(*grid, "cpu") is table
    np.testing.assert_array_equal(table.float().numpy(), np.asarray(jnp.asarray(theirs, jnp.bfloat16), np.float32))


def test_presets_match_jax():
    for name in ("tiny", "sigma_1024", "sigma_512"):
        ours, theirs = getattr(PixartConfig, name)(), getattr(JaxPixartConfig, name)()
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), name
    cfg = PixartConfig.sigma_1024()
    assert (cfg.hidden_size, cfg.depth, cfg.num_heads, cfg.head_dim, cfg.text_dim, cfg.effective_out_channels) == \
        (1152, 28, 16, 72, 4096, 8)


@pytest.mark.parametrize("variant", ["learned_range", "head_dim_72", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """A tiny DiT (f32, rank-4 adapters) on the same seeded weights: the
    epsilon half of the output within ``F32_REL`` in relative L2, and the
    LoRA gradients of a seeded projection of it against ``jax.grad`` within
    ``GRAD_REL``, per adapter."""
    cfg = dataclasses.replace(PixartConfig.tiny(), out_channels=8)
    if variant == "head_dim_72":  # PixArt-Sigma's head dim, inner width 144 != hidden 64
        cfg = dataclasses.replace(cfg, head_dim=72)
    jcfg = JaxPixartConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(0)
    latents = rng.standard_normal((2, 8, 12, 4), dtype=np.float32)
    timesteps = np.asarray([3, 870], np.int32)
    context = rng.standard_normal((2, 7, cfg.text_dim), dtype=np.float32)
    weight = rng.standard_normal((2, 8, 12, 4), dtype=np.float32)
    jmodule = JaxPixartTransformer(config=jcfg, dtype=jnp.float32, lora_rank=4, remat=variant == "remat")
    variables = numpy_variables(jmodule, jnp.asarray(latents), jnp.asarray(timesteps), jnp.asarray(context), seed=1)
    port = bridge(variables, PixartTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=variant == "remat"))

    def jax_loss(lora):
        out = jmodule.apply({"params": variables["params"], "lora": lora}, jnp.asarray(latents),
                            jnp.asarray(timesteps), jnp.asarray(context))
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                                                          variables["lora"]))
    adapters = tl.freeze_base(port)
    out = port(t(latents), t(timesteps), t(context))
    assert tuple(out.shape) == ref.shape == (2, 8, 12, 4) and out.dtype == torch.float32
    assert rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and "block_1/attn2_q/lora_A" in flat
    for path, param in adapters.items():
        assert param.grad is not None and rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


# ---- the family contract ---------------------------------------------------------------------------


def test_contract_and_refusals():
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR", "DDPM_BETA_START", "DDPM_BETA_END",
                 "DDPM_BETA_SCHEDULE", "LATENT_CHANNEL_COUNT", "STAGED_VALIDATION_PREFIX"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch)
    for values in ({}, {"model_flavour": "512-ms"}):
        full = {**_tiny_values(), "model_arch_preset": None, **values}
        assert dataclasses.asdict(PixartSigma(config_namespace(full)).arch) == \
            dataclasses.asdict(JaxPixartSigma(JaxTrainingConfig(full)).arch)
    # the IDDPM linear ladder, at the rtol of tests/test_torch_ddpm.py (f32 products in another order)
    np.testing.assert_allclose(model.alphas_cumprod.numpy(), np.asarray(jmodel.alphas_cumprod), rtol=1e-6)
    assert isinstance(get_model_family(config_namespace({**_tiny_values(), "model_family": "pixart"})), PixartSigma)
    with pytest.raises(NotImplementedError, match="item 7"):
        model.model_predict(None, {"control_latents": torch.zeros(1)})
    with pytest.raises(NotImplementedError, match="item 7"):
        model.controlnet_module()
    with pytest.raises(NotImplementedError, match="item 7"):
        PixartTransformer(PixartConfig.tiny())(torch.zeros(1, 4, 4, 4), torch.zeros(1), torch.zeros(1, 2, 32),
                                               controlnet_block_residuals=[torch.zeros(1)])
    with pytest.raises(NotImplementedError, match="item 6"):
        PixartTransformer(dataclasses.replace(PixartConfig.tiny(), use_additional_conditions=True))
    staged_values = _tiny_values(pixart_validation_pipeline_mode="full-pipeline", validation_prompt="a")
    staged, jstaged = PixartSigma(config_namespace(staged_values)), JaxPixartSigma(JaxTrainingConfig(staged_values))
    assert staged.supports_multistage_validation() and jstaged.supports_multistage_validation()
    with pytest.raises(NotImplementedError, match="item 4d"):
        Validation(staged, staged.config, device="cpu")


def test_build_scheduler_matches_jax():
    """DDIM on PixArt's IDDPM linear ladder, epsilon."""
    jmodel, model = _pair(_tiny_values())
    ours, theirs = build_scheduler(model, 12), jax_build_scheduler(jmodel, 12)
    assert type(ours).__name__ == type(theirs).__name__ == "DDIMScheduler" and ours.prediction_type == "epsilon"
    np.testing.assert_array_equal(ours.timesteps.numpy(), np.asarray(theirs.timesteps))
    np.testing.assert_allclose(ours.alphas_cumprod.numpy(), np.asarray(theirs.alphas_cumprod), rtol=1e-6, atol=1e-6)


# ---- text encoding ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoders():
    """The JAX package's tiny T5 (20 tokens) and the port's module with its params."""
    specs = [dataclasses.replace(s, max_length=20) for s in PixartSigma.TEXT_ENCODER_CONFIGURATION]
    jax_encoders = jax_load_text_encoders(specs, tiny=True)
    ports = load_text_encoders(specs, tiny=True, device="cpu")
    ports[0].model.load_state_dict(t5_state_dict_from_flax(jax_encoders[0].model.params))
    return jax_encoders, ports


def test_encode_text_matches_jax(encoders):
    """The T5 last hidden state and its mask per prompt; the collate drops the mask."""
    jmodel, model = _pair(_tiny_values())
    jmodel.attach_text_encoders(encoders[0])
    model.attach_text_encoders(encoders[1])
    ours, theirs = model.encode_text(PROMPTS), jmodel.encode_text(PROMPTS)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "text_embeds"]
        assert a["text_embeds"].shape == b["text_embeds"].shape == (20, 32) and a["text_embeds"].dtype == np.float32
        np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
        assert rel(a["text_embeds"], b["text_embeds"]) < F32_REL
    collated, jcollated = model.collate_text_embeds(ours), jmodel.collate_text_embeds(theirs)
    assert sorted(collated) == sorted(jcollated) == ["text_embeds"] and collated["text_embeds"].shape == (3, 20, 32)


# ---- weight import and adapter files -------------------------------------------------------------------


@pytest.mark.parametrize("out_channels", [0, 8])
def test_import_matches_jax_bitwise(tmp_path, out_channels):
    """A seeded tiny diffusers PixArt transformer (two shards in
    ``transformer/``; an epsilon head or the Sigma checkpoints' learned-range
    one): the port's tree is bitwise the JAX ``load_pixart_params`` tree, and
    the imported module bitwise the bridged JAX tree."""
    jmodel, model = _pair(_tiny_values())
    arch = dataclasses.replace(model.arch, out_channels=out_channels)
    model.arch, jmodel.arch = arch, JaxPixartConfig(**dataclasses.asdict(arch))
    weights = _seeded(pixart_checkpoint_shapes(arch), seed=4, dtype="f32")
    root = tmp_path / "pixart" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: weights[k] for k in part}, str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_pixart_params(jmodel, str(tmp_path / "pixart"))
    _assert_trees_bitwise(load_pixart_params(model, str(tmp_path / "pixart")), theirs)
    ours = load_transformer_params(model, init_adapters(model.create_module()), str(tmp_path / "pixart"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name
    assert ours.final_proj.weight.shape[0] == 4 * (out_channels or 4)


def _seeded_adapters(model, seed, scale=1.0):
    module = tl.init_parameters(model.create_module(), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for param in tl.lora_parameters(module).values():
            param.copy_(torch.from_numpy(scale * rng.standard_normal(tuple(param.shape)).astype(np.float32)))
    return module


def test_adapter_files_round_trip_with_jax(tmp_path):
    """Port -> JAX -> port bitwise in the diffusers layout
    (``transformer.transformer_blocks.N.attn1.to_q...``; the patch embedding
    and final projection keep their own names, as the JAX export does)."""
    jmodel, model = _pair(_tiny_values(lora_alpha=8))
    assert pixart_key_map(model.arch) == jax_pixart_key_map(jmodel.arch)
    module = _seeded_adapters(model, 1)
    original = {k: v.detach().clone() for k, v in tl.lora_parameters(module).items()}
    first, second = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    save_lora_safetensors(model, module, first)
    jax_save_lora(jmodel, lora_to_flax(module), second)
    ours, theirs = load_safetensors_file(first), load_safetensors_file(second)
    assert sorted(ours) == sorted(theirs) and all(torch.equal(ours[k], theirs[k]) for k in theirs)
    assert any(k.startswith("transformer.transformer_blocks.1.attn2.to_out.0.lora_") for k in ours)
    loaded = jax_load_lora(jmodel, first, lora_to_flax(_seeded_adapters(model, 9)))
    expected, got = flatten_lora(lora_to_flax(module)), flatten_lora(loaded)
    assert all(np.array_equal(got[p][leaf], a) for p, leaves in expected.items() for leaf, a in leaves.items())
    fresh = _seeded_adapters(model, 2)
    assert load_lora_safetensors(model, second, fresh) == []
    assert all(torch.equal(v.detach(), original[k]) for k, v in tl.lora_parameters(fresh).items())


# ---- the trainer -------------------------------------------------------------------------------------


def _overriding_ddpm(original):
    """``next_batch`` with the same numpy noise and timesteps for step ``step`` on both sides."""

    def next_batch(self, step=0):
        batch = dict(original(self, step=step))
        rng = np.random.default_rng(3000 + step)
        batch["override_noise"] = rng.standard_normal(batch["latents"].shape).astype(np.float32)
        batch["override_timesteps"] = rng.integers(0, 1000, batch["latents"].shape[0]).astype(np.int32)
        return batch

    return next_batch


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The JAX ``Trainer`` and the port's on one cache: tiny PixArt-Sigma from
    one seeded diffusers transformer (the 8-channel learned-range head),
    warm-started from one seeded adapter, 4 steps of epsilon training on the
    half the head returns, with the same noise and timesteps.  The port's run
    also renders its final validation (true CFG, DDIM), and
    ``run_inference`` renders from its ``checkpoint-4``."""
    from simpletuner_tpu_torch import inference
    from simpletuner_tpu.data.dataset import MultiDatasetIterator as JaxIterator
    from simpletuner_tpu.models.pixart import model as jax_pixart_module
    from simpletuner_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from simpletuner_tpu.training import trainer as jax_trainer_module
    from simpletuner_tpu.training.trainer import Trainer as JaxTrainer

    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
    from simpletuner_tpu_torch.data.dataset import MultiDatasetIterator
    from simpletuner_tpu_torch.models.pixart import model as pixart_module
    from simpletuner_tpu_torch.models.weight_import import save_safetensors
    from simpletuner_tpu_torch.training.trainer import Trainer

    from test_torch_trainer import _values, _write_images

    root = tmp_path_factory.mktemp("pixart_trainer")
    _write_images(root / "data")
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    values = lambda out, **extra: _values(root, out, model_family="pixart_sigma", **extra)  # noqa: E731
    tiny = dataclasses.replace(PixartConfig.tiny(), out_channels=8)  # the Sigma checkpoints' head
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pixart_module.PixartConfig, "tiny", classmethod(lambda cls: tiny))
        mp.setattr(jax_pixart_module.PixartConfig, "tiny",
                   classmethod(lambda cls: JaxPixartConfig(**dataclasses.asdict(tiny))))
        port_model = PixartSigma(config_namespace(values("x")))
        assert port_model.arch == tiny
        path = str(root / "pixart.safetensors")
        save_safetensors(_seeded(pixart_checkpoint_shapes(port_model.arch), seed=3, dtype="f32"), path)
        lora_path = str(root / "init_lora.safetensors")
        save_lora_safetensors(port_model, _seeded_adapters(port_model, 4, scale=0.05), lora_path)
        extra = {"pretrained_model_name_or_path": path, "init_lora": lora_path}
        # the captions' payloads, cached before either run (the tiny tokenizer's
        # salted hash would give every process other embeds)
        cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "pixart_sigma")
        rng = np.random.default_rng(5)
        for i in range(4):
            cache.save(f"photo {i}", {"text_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                                      "attention_mask": (np.arange(16) < 5).astype(np.int32)})
        mp.setattr(jax_trainer_module, "build_mesh", lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        mp.setattr(JaxIterator, "next_batch", _overriding_ddpm(JaxIterator.next_batch))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(values("jax", **extra)))
        jax_trainer.run()
        mp.setattr(MultiDatasetIterator, "next_batch", _overriding_ddpm(MultiDatasetIterator.next_batch))
        render = {"validation_prompt": RENDER_PROMPT, "validation_resolution": 64, "validation_guidance": 4.5,
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
    relative (``TRAJECTORY_TOL``), grad norm within ``GRAD_REL``; the LoRA
    export matches the JAX export's names and, within ``GRAD_REL`` in
    relative L2, its tensors."""
    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    root, jax_trainer, port_trainer = trainer_runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [1, 2, 3, 4]
    for a, b in zip(ours, theirs):
        assert abs(a["loss"] - b["loss"]) <= TRAJECTORY_TOL * max(1.0, abs(b["loss"])), (a["step"], a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_REL * abs(b["grad_norm"]), (a["step"], a, b)
    export = "checkpoint-4/pytorch_lora_weights.safetensors"
    mine, jax_file = load_safetensors_file(str(root / "port" / export)), load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file) and any(".attn2.to_k.lora_" in k for k in mine)
    keys = sorted(mine)
    assert rel(np.concatenate([mine[k].numpy().ravel() for k in keys]),
               np.concatenate([jax_file[k].numpy().ravel() for k in keys])) < GRAD_REL
    with open(root / "port" / "checkpoint-4" / "trainer_state.json") as a, \
            open(root / "jax" / "checkpoint-4" / "trainer_state.json") as b:
        assert json.load(a) == json.load(b)
    assert port_trainer.model.NAME == "pixart_sigma" and port_trainer.model.arch.effective_out_channels == 8
    assert port_trainer.vae.config.latent_channels == jax_trainer.vae.config.latent_channels == 4


def test_checkpoint_inference_renders_the_final_validation(trainer_runs):
    """``run_inference`` from the PixArt run's checkpoint-4 renders its final
    validation image (true CFG, DDIM) byte for byte."""
    root = trainer_runs[0]
    final = root / "port" / "validation" / "step_4_0.png"
    rendered = root / "port_render" / "validation" / "step_4_0.png"
    assert final.read_bytes() == rendered.read_bytes() and len(final.read_bytes()) > 100


# ---- validation render -----------------------------------------------------------------------------


def test_cfg_render_matches_jax(encoders, monkeypatch):
    """A true-CFG DDIM render through each package's ``Validation``: prompt
    and negative prompt encoded by the tiny T5 (the JAX params in the port's
    module), the same weights and noise, 6 guided steps with rescale and the
    no-CFG threshold, unmasked cross-attention over the 20 caption tokens."""
    config = _tiny_values(model_type="full", validation_prompt=PROMPTS[0], validation_negative_prompt="blurry",
                          validation_guidance=4.5, validation_guidance_rescale=0.3,
                          validation_no_cfg_until_timestep=1, validation_num_inference_steps=6,
                          validation_resolution=64, validation_seed=7, tokenizer_max_length=20)
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
