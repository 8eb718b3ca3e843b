"""The torch port's AuraFlow family against the JAX package, on the CPU.

The DiT forward and its LoRA gradients (the centred crop of the learned
position table at a square, a non-square and an over-wide bucket, register
tokens, the joint and single blocks, remat), the family contract and its
refusals, ``encode_text`` on the tiny T5, the diffusers import of the JAX
exporter's output, the LoRA key map and adapter files, the JAX ``Trainer``
against the port's on one cache, and a true-CFG flow Euler validation
render: the same seeded numpy weights, inputs and noise go through both
packages.  Every tolerance is stated where it is checked.  At the tiny size
the head dim is 32; the head dim 256 kernels are held to their plain
versions in test_torch_kernels_cuda.py, on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.auraflow.model import AuraFlow as JaxAuraFlow
from simpletuner_tpu.models.auraflow.transformer import AuraFlowConfig as JaxAuraFlowConfig
from simpletuner_tpu.models.auraflow.transformer import AuraFlowTransformer as JaxAuraFlowTransformer
from simpletuner_tpu.models.text_encoders import load_text_encoders as jax_load_text_encoders
from simpletuner_tpu.models.weight_export import export_auraflow_to_diffusers
from simpletuner_tpu.models.weight_import import load_auraflow_params as jax_load_auraflow_params
from simpletuner_tpu.training.lora import auraflow_key_map as jax_auraflow_key_map
from simpletuner_tpu.training.lora import flatten_lora
from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora
from simpletuner_tpu.training.lora import save_lora_safetensors as jax_save_lora
from simpletuner_tpu.training.validation import Validation as JaxValidation

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.auraflow import AuraFlow, AuraFlowConfig, AuraFlowTransformer
from simpletuner_tpu_torch.models.checkpoint_layouts import auraflow_checkpoint_shapes
from simpletuner_tpu_torch.models.registry import get_model_family
from simpletuner_tpu_torch.models.t5 import t5_state_dict_from_flax
from simpletuner_tpu_torch.models.text_encoders import load_text_encoders
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params, lora_to_flax
from simpletuner_tpu_torch.models.weight_import import (
    load_auraflow_params, load_safetensors_file, load_transformer_params,
)
from simpletuner_tpu_torch.training.lora import auraflow_key_map, load_lora_safetensors, save_lora_safetensors
from simpletuner_tpu_torch.training.validation import Validation, noise_generator

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# gradient-derived numbers (test_torch_sdxl.py: f32 gradients through a deep
# net are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
PROMPTS = ["a lighthouse on a basalt cliff at dusk", "", "portrait of a cat"]


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
    return {"model_family": "auraflow", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxAuraFlow(JaxTrainingConfig(values)), AuraFlow(config_namespace(values))


# ---- the transformer ------------------------------------------------------------------------------


def test_presets_match_jax():
    for name in ("tiny", None):
        ours = getattr(AuraFlowConfig, name)() if name else AuraFlowConfig()
        theirs = getattr(JaxAuraFlowConfig, name)() if name else JaxAuraFlowConfig()
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), name
        assert (ours.head_dim, ours.ffn_hidden) == (theirs.head_dim, theirs.ffn_hidden)
    cfg = AuraFlowConfig()  # AuraFlow v0.3's published transformer
    assert (cfg.hidden_size, cfg.depth_double, cfg.depth_single, cfg.num_heads, cfg.head_dim, cfg.ffn_hidden,
            cfg.text_dim) == (3072, 4, 32, 12, 256, 8192, 2048)


# (latent height, width): the crop of the tiny 8 x 8 position grid is centred
# on a square bucket, off-centre by the integer division on a non-square one,
# and wraps across the grid's rows on a bucket wider than the grid
BUCKETS = {"square": (8, 8), "non_square": (6, 10), "wider_than_grid": (4, 20)}


@pytest.mark.parametrize("variant", ["square", "non_square", "wider_than_grid", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """A tiny DiT (f32, rank-4 adapters) on the same seeded weights: the
    output within ``F32_REL`` in relative L2, and the LoRA gradients of a
    seeded projection of it against ``jax.grad`` within ``GRAD_REL``, per
    adapter."""
    cfg = AuraFlowConfig.tiny()
    remat = variant == "remat"
    height, width = BUCKETS.get(variant, (6, 10))
    rng = np.random.default_rng(0)
    latents = rng.standard_normal((2, height, width, 4), dtype=np.float32)
    timesteps = np.asarray([0.03, 0.87], np.float32)
    context = rng.standard_normal((2, 7, cfg.text_dim), dtype=np.float32)
    weight = rng.standard_normal((2, height, width, 4), dtype=np.float32)
    jmodule = JaxAuraFlowTransformer(config=JaxAuraFlowConfig.tiny(), dtype=jnp.float32, lora_rank=4, remat=remat)
    variables = numpy_variables(jmodule, jnp.asarray(latents), jnp.asarray(timesteps), jnp.asarray(context), seed=1)
    port = bridge(variables, AuraFlowTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])  # the table is indexed by a jnp array

    def jax_loss(lora):
        out = jmodule.apply({"params": params, "lora": lora}, jnp.asarray(latents),
                            jnp.asarray(timesteps), jnp.asarray(context))
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                                                          variables["lora"]))
    adapters = tl.freeze_base(port)
    out = port(t(latents), t(timesteps), t(context))
    assert tuple(out.shape) == ref.shape == (2, height, width, 4) and out.dtype == torch.float32
    assert rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and "double_0/attn_add_q/lora_A" in flat
    assert "single_1/ff/out_projection/lora_B" in flat and "patch_in/lora_A" in flat
    for path, param in adapters.items():
        assert param.grad is not None and rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


# ---- the family contract ---------------------------------------------------------------------------


def test_contract_and_refusals():
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR", "LATENT_CHANNEL_COUNT"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch) and model.is_flow
    full = {**_tiny_values(), "model_arch_preset": None}
    assert dataclasses.asdict(AuraFlow(config_namespace(full)).arch) == \
        dataclasses.asdict(JaxAuraFlow(JaxTrainingConfig(full)).arch)
    assert isinstance(get_model_family(config_namespace(_tiny_values())), AuraFlow)
    assert {k: tuple(v.shape) for k, v in model.example_batch(2, 128).items()} == \
        {k: tuple(v.shape) for k, v in jmodel.example_batch(2, 128).items()}
    batch = {"noisy_latents": torch.zeros(1), "timesteps": torch.zeros(1), "text_embeds": torch.zeros(1)}
    assert model.get_model_inputs(batch).keys() == jmodel.get_model_inputs(batch).keys()
    assert model.inference_conditioning(batch).keys() == jmodel.inference_conditioning(batch).keys()
    with pytest.raises(NotImplementedError, match="item 7"):
        model.model_predict(None, {"control_latents": torch.zeros(1)})


# ---- text encoding ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoders():
    """The JAX package's tiny T5 (20 tokens) and the port's module with its params."""
    specs = [dataclasses.replace(s, max_length=20) for s in AuraFlow.TEXT_ENCODER_CONFIGURATION]
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


def _jax_params(jmodel, seed):
    shapes = jax.eval_shape(lambda: JaxAuraFlowTransformer(config=jmodel.arch).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros(1), jnp.zeros((1, 4, jmodel.arch.text_dim))))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's diffusers file of a seeded tiny transformer (two
    shards in ``transformer/``): its names and shapes are the port's layout,
    the port's tree is bitwise the JAX ``load_auraflow_params`` tree, and the
    imported module bitwise the bridged JAX tree."""
    jmodel, model = _pair(_tiny_values())
    weights = export_auraflow_to_diffusers(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == auraflow_checkpoint_shapes(model.arch)
    root = tmp_path / "auraflow" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_auraflow_params(jmodel, str(tmp_path / "auraflow"))
    _assert_trees_bitwise(load_auraflow_params(model, str(tmp_path / "auraflow")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "auraflow"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name
    assert ours.pos_embed.shape == (64, 64) and ours.register_tokens.shape == (8, 64)


def _seeded_adapters(model, seed, scale=1.0):
    module = tl.init_parameters(model.create_module(), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for param in tl.lora_parameters(module).values():
            param.copy_(torch.from_numpy(scale * rng.standard_normal(tuple(param.shape)).astype(np.float32)))
    return module


def test_key_map_and_adapter_files_round_trip_with_jax(tmp_path):
    """``auraflow_key_map`` equal to the JAX map; port -> JAX -> port
    bitwise in the diffusers layout (``transformer.joint_transformer_blocks.N
    .attn.add_q_proj...``), and a ComfyUI-layout file (``diffusion_model.``
    prefix, ``lora_down`` / ``lora_up``) loads into the port."""
    jmodel, model = _pair(_tiny_values(lora_alpha=8))
    assert auraflow_key_map(model.arch) == jax_auraflow_key_map(jmodel.arch)
    module = _seeded_adapters(model, 1)
    original = {k: v.detach().clone() for k, v in tl.lora_parameters(module).items()}
    first, second = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    save_lora_safetensors(model, module, first)
    jax_save_lora(jmodel, lora_to_flax(module), second)
    ours, theirs = load_safetensors_file(first), load_safetensors_file(second)
    assert sorted(ours) == sorted(theirs) and all(torch.equal(ours[k], theirs[k]) for k in theirs)
    assert any(k.startswith("transformer.joint_transformer_blocks.0.ff_context.out_projection.lora_") for k in ours)
    assert any(k.startswith("transformer.single_transformer_blocks.1.attn.to_out.0.lora_") for k in ours)
    loaded = jax_load_lora(jmodel, first, lora_to_flax(_seeded_adapters(model, 9)))
    expected, got = flatten_lora(lora_to_flax(module)), flatten_lora(loaded)
    assert all(np.array_equal(got[p][leaf], a) for p, leaves in expected.items() for leaf, a in leaves.items())
    fresh = _seeded_adapters(model, 2)
    assert load_lora_safetensors(model, second, fresh) == []
    assert all(torch.equal(v.detach(), original[k]) for k, v in tl.lora_parameters(fresh).items())
    comfy = {}
    for key, value in ours.items():
        key = "diffusion_model." + key.removeprefix("transformer.")
        comfy[key.replace(".lora_A.weight", ".lora_down.weight").replace(".lora_B.weight", ".lora_up.weight")] = value
    comfy_path = str(tmp_path / "comfy.safetensors")
    from simpletuner_tpu_torch.models.weight_import import save_safetensors

    save_safetensors(comfy, comfy_path)
    fresh = _seeded_adapters(model, 3)
    assert load_lora_safetensors(model, comfy_path, fresh) == []
    assert all(torch.equal(v.detach(), original[k]) for k, v in tl.lora_parameters(fresh).items())


# ---- the trainer -------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The JAX ``Trainer`` and the port's on one cache: tiny AuraFlow from the
    JAX exporter's file of one seeded tree, warm-started from one seeded
    adapter, 2 steps with the same noise and sigmas (the Flux trainer test's
    recipe, cut to 2 steps)."""
    from simpletuner_tpu.data.dataset import MultiDatasetIterator as JaxIterator
    from simpletuner_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from simpletuner_tpu.training import trainer as jax_trainer_module
    from simpletuner_tpu.training.trainer import Trainer as JaxTrainer

    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
    from simpletuner_tpu_torch.data.dataset import MultiDatasetIterator
    from simpletuner_tpu_torch.training.trainer import Trainer

    from test_torch_trainer import _overriding, _values, _write_images

    root = tmp_path_factory.mktemp("auraflow_trainer")
    _write_images(root / "data")
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    values = lambda out, **extra: _values(root, out, model_family="auraflow", max_train_steps=2,  # noqa: E731
                                          **extra)
    jmodel, port_model = _pair(values("x"))
    path = str(root / "auraflow.safetensors")
    exported = export_auraflow_to_diffusers(_jax_params(jmodel, 3), jmodel.arch)
    np_save_file({k: np.ascontiguousarray(v) for k, v in exported.items()}, path)
    lora_path = str(root / "init_lora.safetensors")
    save_lora_safetensors(port_model, _seeded_adapters(port_model, 4, scale=0.05), lora_path)
    extra = {"pretrained_model_name_or_path": path, "init_lora": lora_path}
    # the captions' payloads, cached before either run (the tiny tokenizer's
    # salted hash would give every process other embeds)
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "auraflow")
    rng = np.random.default_rng(5)
    for i in range(4):
        cache.save(f"photo {i}", {"text_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                                  "attention_mask": (np.arange(16) < 5).astype(np.int32)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_module, "build_mesh", lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        mp.setattr(JaxIterator, "next_batch", _overriding(JaxIterator.next_batch))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(values("jax", **extra)))
        jax_trainer.run()
        mp.setattr(MultiDatasetIterator, "next_batch", _overriding(MultiDatasetIterator.next_batch))
        port_trainer = Trainer(config=values("port", **extra), device="cpu")
        port_trainer.run()
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])
    return root, jax_trainer, port_trainer


def test_trainer_matches_jax(trainer_runs):
    """2 steps, no state shared between the runs: per-step loss within 1e-5
    relative (``TRAJECTORY_TOL``), grad norm within ``GRAD_REL``; the LoRA
    export holds the JAX map's names and, within ``GRAD_REL`` in relative L2,
    its tensors; both trainers build the 4-channel VAE."""
    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    root, jax_trainer, port_trainer = trainer_runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [1, 2]
    for a, b in zip(ours, theirs):
        assert abs(a["loss"] - b["loss"]) <= TRAJECTORY_TOL * max(1.0, abs(b["loss"])), (a["step"], a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_REL * abs(b["grad_norm"]), (a["step"], a, b)
    export = "checkpoint-2/pytorch_lora_weights.safetensors"
    mine, jax_file = load_safetensors_file(str(root / "port" / export)), load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file) and any(".attn.add_k_proj.lora_" in k for k in mine)
    keys = sorted(mine)
    assert rel(np.concatenate([mine[k].numpy().ravel() for k in keys]),
               np.concatenate([jax_file[k].numpy().ravel() for k in keys])) < GRAD_REL
    assert port_trainer.model.NAME == "auraflow"
    assert port_trainer.vae.config.latent_channels == jax_trainer.vae.config.latent_channels == 4


# ---- validation render -----------------------------------------------------------------------------


def test_cfg_render_matches_jax(encoders, monkeypatch):
    """A true-CFG flow Euler render (AuraFlow has no guidance embedding)
    through each package's ``Validation``: prompt and negative prompt encoded
    by the tiny T5 (the JAX params in the port's module), the same weights and
    noise, 6 guided steps with rescale, unmasked attention over the 8 register
    and 20 caption tokens and the image."""
    config = _tiny_values(model_type="full", validation_prompt=PROMPTS[0], validation_negative_prompt="blurry",
                          validation_guidance=3.5, validation_guidance_rescale=0.3,
                          validation_num_inference_steps=6, validation_resolution=64, validation_seed=7,
                          tokenizer_max_length=20)
    jmodel, model = _pair(config)
    jmodel.attach_text_encoders(encoders[0])
    model.attach_text_encoders(encoders[1])
    variables = {"params": _jax_params(jmodel, 3)}
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
    ref = np.asarray(jvalidation._render_single(jax.tree_util.tree_map(jnp.asarray, variables),
                                                jvalidation._embeds[0], 0))
    assert out.shape == ref.shape == (8, 8, 4) and np.isfinite(out).all()
    assert rel(out, ref) < 1e-4  # the render tolerance of test_torch_inference.py (f32, sum order only)
