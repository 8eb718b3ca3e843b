"""The torch port's Wan family against the JAX package, on the CPU.

The video DiT forward and its LoRA gradients (T2V, remat, and the I2V input
of noisy latents, the clean first frame and the frame-0 mask through the
family's ``model_predict``), the family contract with the flavours' archs and
the Wan 2.2 stage defaults, ``encode_text`` on the tiny T5, the diffusers
import of the JAX exporter's output (T2V and I2V), the LoRA key map and
adapter files, the JAX ``Trainer`` against the port's on one cache of mp4
clips (video buckets, 5-D latents), checkpoint inference writing an mp4,
and a true-CFG flow Euler validation render decoded by the video VAE: the
same seeded numpy weights, inputs and noise go through both packages.  Every
tolerance is stated where it is checked.  At the tiny size the head dim is
32; Wan's shapes at head dim 128 are held on the card
(test_torch_kernels_cuda.py, chip_smoke.py phases 3, 7 and 23).
"""

import dataclasses
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.text_encoders import load_text_encoders as jax_load_text_encoders
from simpletuner_tpu.models.video_vae import VideoAutoencoderKL as JaxVideoAutoencoderKL
from simpletuner_tpu.models.video_vae import VideoVAEConfig as JaxVideoVAEConfig
from simpletuner_tpu.models.wan.model import Wan as JaxWan
from simpletuner_tpu.models.wan.transformer import WanConfig as JaxWanConfig
from simpletuner_tpu.models.wan.transformer import WanTransformer as JaxWanTransformer
from simpletuner_tpu.models.weight_export import export_wan_to_diffusers
from simpletuner_tpu.models.weight_import import load_wan_params as jax_load_wan_params
from simpletuner_tpu.training.lora import flatten_lora
from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora
from simpletuner_tpu.training.lora import save_lora_safetensors as jax_save_lora
from simpletuner_tpu.training.lora import wan_key_map as jax_wan_key_map
from simpletuner_tpu.training.validation import Validation as JaxValidation

from simpletuner_tpu_torch.configuration import TrainingConfig
from simpletuner_tpu_torch.inference import config_namespace, run_inference
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import wan_checkpoint_shapes
from simpletuner_tpu_torch.models.registry import get_model_family
from simpletuner_tpu_torch.models.t5 import t5_state_dict_from_flax
from simpletuner_tpu_torch.models.text_encoders import load_text_encoders
from simpletuner_tpu_torch.models.video_vae import VideoAutoencoderKL, VideoVAEConfig
from simpletuner_tpu_torch.models.wan import Wan, WanConfig, WanTransformer
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params, lora_to_flax
from simpletuner_tpu_torch.models.weight_import import load_safetensors_file, load_transformer_params, load_wan_params
from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors, wan_key_map
from simpletuner_tpu_torch.training.validation import Validation, noise_generator

from test_torch_video import write_clip
from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# gradient-derived numbers (test_torch_sdxl.py: f32 gradients through a deep
# net are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
PROMPTS = ["a lighthouse on a basalt cliff at dusk", "", "a cat walking through snow"]


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
    return {"model_family": "wan", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxWan(JaxTrainingConfig(values)), Wan(config_namespace(values))


# ---- the transformer ------------------------------------------------------------------------------


def test_presets_match_jax():
    for name in ("b1_3", "b14", "tiny"):
        ours, theirs = getattr(WanConfig, name)(), getattr(JaxWanConfig, name)()
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), name
    cfg = WanConfig.b1_3()  # the JAX preset of Wan 2.1 T2V-1.3B
    assert (cfg.hidden_size, cfg.depth, cfg.num_heads, cfg.head_dim, cfg.ffn_hidden, sum(cfg.axes_dim)) == \
        (1536, 30, 12, 128, 6144, 128)
    assert (WanConfig.b14().hidden_size, WanConfig.b14().ffn_hidden) == (5120, 20480)


@pytest.mark.parametrize("variant", ["t2v", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """A tiny DiT (f32, rank-4 adapters) on the same seeded weights, 3 x 4 x 6
    latents (3 x 2 x 3 tokens) and 5 text tokens: the output within
    ``F32_REL`` in relative L2, and the LoRA gradients of a seeded
    projection of it against ``jax.grad`` within ``GRAD_REL``, per adapter."""
    remat = variant == "remat"
    rng = np.random.default_rng(0)
    latents = rng.standard_normal((2, 3, 4, 6, 4), dtype=np.float32)
    timesteps = np.asarray([0.03, 0.87], np.float32)
    context = rng.standard_normal((2, 5, 32), dtype=np.float32)
    weight = rng.standard_normal((2, 3, 4, 6, 4), dtype=np.float32)
    jmodule = JaxWanTransformer(config=JaxWanConfig.tiny(), dtype=jnp.float32, lora_rank=4, remat=remat)
    variables = numpy_variables(jmodule, jnp.asarray(latents), jnp.asarray(timesteps), jnp.asarray(context), seed=1)
    port = bridge(variables, WanTransformer(WanConfig.tiny(), dtype=torch.float32, lora_rank=4, remat=remat))

    def jax_loss(lora):
        out = jmodule.apply({"params": variables["params"], "lora": lora}, jnp.asarray(latents),
                            jnp.asarray(timesteps), jnp.asarray(context))
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(variables["lora"])
    adapters = tl.freeze_base(port)
    out = port(t(latents), t(timesteps), t(context))
    assert tuple(out.shape) == ref.shape == (2, 3, 4, 6, 4) and out.dtype == torch.float32
    assert rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and "block_1/cross_attn_k/lora_A" in flat
    assert "patch_in/lora_B" in flat and "text_in2/lora_A" in flat and "time_proj/lora_A" not in flat
    for path, param in adapters.items():
        assert param.grad is not None and rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_i2v_model_predict_matches_jax():
    """The I2V flavour (tiny: 4 latent channels, 12 in, 4 out): the family's
    ``model_predict`` on noisy and clean latents (the clean frame 0 over time
    and the frame-0 mask joined on the channels) within ``F32_REL``."""
    values = _tiny_values(model_flavour="i2v-14b-480p")
    jmodel, model = _pair(values)
    assert model.is_i2v and (model.arch.in_channels, model.arch.out_channels, model.latent_channels) == (12, 4, 4)
    assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch)
    rng = np.random.default_rng(2)
    prepared = {"noisy_latents": rng.standard_normal((2, 3, 4, 4, 4), dtype=np.float32),
                "latents": rng.standard_normal((2, 3, 4, 4, 4), dtype=np.float32),
                "timesteps": np.asarray([0.4, 0.9], np.float32),
                "text_embeds": rng.standard_normal((2, 5, 32), dtype=np.float32)}
    jmodule = jmodel.create_module()
    inputs = jmodel.get_model_inputs({k: jnp.asarray(v) for k, v in prepared.items()})
    assert inputs["latents"].shape == (2, 3, 4, 4, 12)
    variables = numpy_variables(jmodule, **inputs, seed=3)
    ref = np.asarray(jmodel.model_predict(variables, {k: jnp.asarray(v) for k, v in prepared.items()}))
    port = bridge(variables, model.create_module())
    ours = model.get_model_inputs({k: t(v) for k, v in prepared.items()})
    assert np.array_equal(ours["latents"].numpy(), np.asarray(inputs["latents"]))
    out = model.model_predict(port, {k: t(v) for k, v in prepared.items()}).detach().numpy()
    assert out.shape == ref.shape == (2, 3, 4, 4, 4) and rel(out, ref) < F32_REL


# ---- the family contract ---------------------------------------------------------------------------


def test_contract_flavours_and_stage_defaults():
    """The class attributes, each flavour's arch (``ti2v-5b-2.2`` built as
    the 1.3B arch with the I2V input, as in the JAX family), the example batch, the stage
    defaults of the Wan 2.2 expert flavours (kept where the user set a
    value), and the refusals: epsilon prediction, and the two-expert
    validation render by name."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "MODALITY", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR",
                 "HUGGINGFACE_PATHS", "WAN_STAGE_OVERRIDES", "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR",
                 "VAE_SHIFT_FACTOR", "LATENT_CHANNEL_COUNT"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert model.video_vae_config().__dict__ == jmodel.video_vae_config().__dict__ and model.is_flow
    for flavour in ("t2v-1.3b", "t2v-14b", "i2v-14b-480p", "ti2v-5b-2.2", "i2v-14b-2.2-high"):
        values = {"model_family": "wan", "model_flavour": flavour}
        ours, theirs = Wan(config_namespace(values)), JaxWan(JaxTrainingConfig(values))
        assert dataclasses.asdict(ours.arch) == dataclasses.asdict(theirs.arch), flavour
        assert ours.latent_channels == theirs.latent_channels == 16
        assert ours.video_vae_config() == VideoVAEConfig.wan()
    # "ti2v" holds "i2v": the 1.3B arch with the I2V input, as in the JAX family
    assert Wan(config_namespace({"model_flavour": "ti2v-5b-2.2"})).arch == dataclasses.replace(
        WanConfig.b1_3(), in_channels=36, out_channels=16)
    assert Wan(config_namespace({"model_flavour": "i2v-14b-480p"})).arch.in_channels == 36
    assert {k: tuple(v.shape) for k, v in model.example_batch(2, 64).items()} == \
        {k: tuple(v.shape) for k, v in jmodel.example_batch(2, 64).items()}
    batch = {"noisy_latents": torch.zeros(1, 1, 2, 2, 4), "timesteps": torch.zeros(1), "text_embeds": torch.zeros(1)}
    assert model.get_model_inputs(batch).keys() == {"latents", "timesteps", "context"}
    assert model.inference_conditioning(batch).keys() == {"text_embeds"}
    for extra in ({}, {"flow_schedule_shift": 2.0, "validation_guidance": 6.0}):
        values = {"model_family": "wan", "model_flavour": "i2v-14b-2.2-high", **extra}
        ours, theirs = TrainingConfig(values), JaxTrainingConfig(values)
        get_model_family(ours)
        JaxWan(theirs).check_user_config()
        for key in ("flow_schedule_shift", "validation_num_inference_steps", "validation_guidance"):
            assert getattr(ours, key) == getattr(theirs, key), (extra, key)
        assert ours.validation_num_inference_steps == 40
        assert ours.flow_schedule_shift == extra.get("flow_schedule_shift", 5.0)
    with pytest.raises(ValueError, match="flow-matching"):
        get_model_family(TrainingConfig({"model_family": "wan", "prediction_type": "epsilon"}))
    staged = Wan(config_namespace({"model_flavour": "animegen-t2v-low", "wan_validation_load_other_stage": True,
                                   "validation_prompt": "a"}))
    assert staged.supports_multistage_validation() and not model.supports_multistage_validation()
    with pytest.raises(NotImplementedError, match="item 4d"):
        staged.validation_stage_plan(None)
    with pytest.raises(NotImplementedError, match="item 4d"):
        Validation(staged, staged.config, device="cpu")


# ---- text encoding ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoders():
    """The JAX package's tiny T5 (20 tokens) and the port's module with its params."""
    specs = [dataclasses.replace(s, max_length=20) for s in Wan.TEXT_ENCODER_CONFIGURATION]
    jax_encoders = jax_load_text_encoders(specs, tiny=True)
    ports = load_text_encoders(specs, tiny=True, device="cpu")
    ports[0].model.load_state_dict(t5_state_dict_from_flax(jax_encoders[0].model.params))
    return jax_encoders, ports


def test_encode_text_matches_jax(encoders):
    """The umT5 last hidden state (pad positions kept) and its mask per
    prompt; the collate drops the mask."""
    jmodel, model = _pair(_tiny_values())
    jmodel.attach_text_encoders(encoders[0])
    model.attach_text_encoders(encoders[1])
    ours, theirs = model.encode_text(PROMPTS), jmodel.encode_text(PROMPTS)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "text_embeds"]
        assert a["text_embeds"].shape == b["text_embeds"].shape == (20, 32) and a["text_embeds"].dtype == np.float32
        np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
        assert rel(a["text_embeds"], b["text_embeds"]) < F32_REL
    assert ours[1]["attention_mask"].sum() < 20 and np.abs(ours[1]["text_embeds"][-1]).sum() > 0  # pads kept
    collated, jcollated = model.collate_text_embeds(ours), jmodel.collate_text_embeds(theirs)
    assert sorted(collated) == sorted(jcollated) == ["text_embeds"] and collated["text_embeds"].shape == (3, 20, 32)


# ---- weight import and adapter files -------------------------------------------------------------------


def _jax_params(jmodel, seed):
    arch = jmodel.arch
    shapes = jax.eval_shape(lambda: JaxWanTransformer(config=arch).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 4, 4, arch.in_channels)), jnp.zeros(1),
        jnp.zeros((1, 5, arch.text_dim))))
    return fill_numpy(shapes, seed)["params"]


@pytest.mark.parametrize("flavour", ["t2v-1.3b", "i2v-14b-480p"])
def test_import_matches_jax_bitwise(tmp_path, flavour):
    """The JAX exporter's diffusers file of a seeded tiny transformer (two
    shards in ``transformer/``; the I2V file also carries an image embedder
    and ``add_k_proj``, which neither importer reads): its Wan tensors have
    the names and shapes of ``wan_checkpoint_shapes``, the port's tree is
    bitwise the JAX ``load_wan_params`` tree, and the imported module
    bitwise the bridged JAX tree."""
    jmodel, model = _pair(_tiny_values(model_flavour=flavour))
    weights = export_wan_to_diffusers(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == wan_checkpoint_shapes(model.arch)
    if model.is_i2v:
        weights["condition_embedder.image_embedder.ff.net.0.proj.weight"] = np.ones((8, 4), np.float32)
        weights["blocks.0.attn2.add_k_proj.weight"] = np.ones((64, 64), np.float32)
    root = tmp_path / "wan" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_wan_params(jmodel, str(tmp_path / "wan"))
    _assert_trees_bitwise(load_wan_params(model, str(tmp_path / "wan")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "wan"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name
    assert ours.patch_in.weight.shape == (64, 4 * model.arch.in_channels)


def _seeded_adapters(model, seed, scale=1.0):
    module = tl.init_parameters(model.create_module(), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for param in tl.lora_parameters(module).values():
            param.copy_(torch.from_numpy(scale * rng.standard_normal(tuple(param.shape)).astype(np.float32)))
    return module


def test_key_map_and_adapter_files_round_trip_with_jax(tmp_path):
    """``wan_key_map`` equal to the JAX map; port -> JAX -> port bitwise in
    the diffusers layout (``transformer.blocks.N.attn1.to_q.lora_A...``); the
    diffusers targets ``to_q`` / ``to_k`` / ``to_v`` / ``to_out.0`` adapt the
    eight attention projections of every block and nothing else."""
    jmodel, model = _pair(_tiny_values(lora_alpha=8))
    assert wan_key_map(model.arch) == jax_wan_key_map(jmodel.arch)
    module = _seeded_adapters(model, 1)
    original = {k: v.detach().clone() for k, v in tl.lora_parameters(module).items()}
    first, second = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    save_lora_safetensors(model, module, first)
    jax_save_lora(jmodel, lora_to_flax(module), second)
    ours, theirs = load_safetensors_file(first), load_safetensors_file(second)
    assert sorted(ours) == sorted(theirs) and all(torch.equal(ours[k], theirs[k]) for k in theirs)
    assert any(k.startswith("transformer.blocks.1.attn2.to_out.0.lora_") for k in ours)
    assert any(k.startswith("transformer.blocks.0.ffn.net.0.proj.lora_") for k in ours)
    loaded = jax_load_lora(jmodel, first, lora_to_flax(_seeded_adapters(model, 9)))
    expected, got = flatten_lora(lora_to_flax(module)), flatten_lora(loaded)
    assert all(np.array_equal(got[p][leaf], a) for p, leaves in expected.items() for leaf, a in leaves.items())
    fresh = _seeded_adapters(model, 2)
    assert load_lora_safetensors(model, second, fresh) == []
    assert all(torch.equal(v.detach(), original[k]) for k, v in tl.lora_parameters(fresh).items())
    targeted = Wan(config_namespace(_tiny_values(lora_target_modules=["to_q", "to_k", "to_v", "to_out.0"])))
    adapted = {path.rsplit("/", 2)[-2] for path in tl.lora_parameters(targeted.create_module())}
    assert adapted == {f"{a}_{p}" for a in ("self_attn", "cross_attn") for p in ("q", "k", "v", "proj")}


# ---- the trainer and checkpoint inference --------------------------------------------------------------


def _write_clips(directory):
    """Four 9-frame clips in two buckets (32x32 and 48x32), with captions."""
    os.makedirs(directory, exist_ok=True)
    for i in range(4):
        width = 48 if i % 2 else 32
        write_clip(os.path.join(directory, f"clip_{i}.mp4"), 9, width, 32, seed=i)
        with open(os.path.join(directory, f"clip_{i}.txt"), "w") as handle:
            handle.write(f"clip {i}")


def _trainer_values(root, out, **extra):
    return {
        "model_family": "wan", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
        "optimizer": "adamw", "learning_rate": 1e-3, "lr_scheduler": "constant", "max_train_steps": 2,
        "train_batch_size": 1, "resolution": 40, "report_to": "jsonl", "mixed_precision": "fp32",
        "tokenizer_max_length": 16, "cache_dir": str(root / "cache"), "output_dir": str(root / out),
        "checkpointing_steps": 2, "seed": 42,
        "data_backend_config": [
            {"id": "clips", "dataset_type": "video", "type": "local", "instance_data_dir": str(root / "data"),
             "resolution": 40, "resolution_type": "pixel_area", "aspect_bucket_alignment": 16,
             "caption_strategy": "textfile", "cache_dir_vae": str(root / "cache" / "vae"), "repeats": 1,
             "video": {"num_frames": 9}},
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": str(root / "cache" / "text")},
        ],
        **extra,
    }


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The JAX ``Trainer`` and the port's on one cache: tiny Wan from the JAX
    exporter's file of one seeded tree, warm-started from one seeded adapter,
    2 steps over four clips in two video buckets with the same noise and
    sigmas (the Flux trainer test's recipe).  The JAX run writes the latent
    cache with its video VAE; the port reads it."""
    from simpletuner_tpu import native as jax_native
    from simpletuner_tpu.data.dataset import MultiDatasetIterator as JaxIterator
    from simpletuner_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from simpletuner_tpu.training import trainer as jax_trainer_module
    from simpletuner_tpu.training.trainer import Trainer as JaxTrainer

    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
    from simpletuner_tpu_torch.data.dataset import MultiDatasetIterator
    from simpletuner_tpu_torch.training.trainer import Trainer

    from test_torch_trainer import _overriding

    root = tmp_path_factory.mktemp("wan_trainer")
    _write_clips(root / "data")
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jmodel, port_model = _pair(_trainer_values(root, "x"))
    path = str(root / "wan.safetensors")
    exported = export_wan_to_diffusers(_jax_params(jmodel, 3), jmodel.arch)
    np_save_file({k: np.ascontiguousarray(v) for k, v in exported.items()}, path)
    lora_path = str(root / "init_lora.safetensors")
    save_lora_safetensors(port_model, _seeded_adapters(port_model, 4, scale=0.05), lora_path)
    extra = {"pretrained_model_name_or_path": path, "init_lora": lora_path}
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "wan")
    rng = np.random.default_rng(5)
    for i in range(4):
        cache.save(f"clip {i}", {"text_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                                 "attention_mask": (np.arange(16) < 4).astype(np.int32)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        mp.setattr(jax_trainer_module, "build_mesh", lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        mp.setattr(JaxIterator, "next_batch", _overriding(JaxIterator.next_batch))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(_trainer_values(root, "jax", **extra)))
        jax_trainer.run()
        mp.setattr(MultiDatasetIterator, "next_batch", _overriding(MultiDatasetIterator.next_batch))
        port_trainer = Trainer(config=_trainer_values(root, "port", **extra), device="cpu")
        port_trainer.run()
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])
    return root, jax_trainer, port_trainer


def test_trainer_matches_jax(trainer_runs):
    """2 steps over 5-D latents, no state shared between the runs: per-step
    loss within 1e-5 relative (``TRAJECTORY_TOL``), grad norm within
    ``GRAD_REL``; the LoRA export holds the JAX map's names and, within
    ``GRAD_REL`` in relative L2, its tensors; both trainers built the tiny
    video VAE and saw the two video buckets."""
    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    root, jax_trainer, port_trainer = trainer_runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [1, 2]
    for a, b in zip(ours, theirs):
        assert abs(a["loss"] - b["loss"]) <= TRAJECTORY_TOL * max(1.0, abs(b["loss"])), (a["step"], a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_REL * abs(b["grad_norm"]), (a["step"], a, b)
    export = "checkpoint-2/pytorch_lora_weights.safetensors"
    mine, jax_file = load_safetensors_file(str(root / "port" / export)), load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file) and any(".attn1.to_q.lora_" in k for k in mine)
    keys = sorted(mine)
    assert rel(np.concatenate([mine[k].numpy().ravel() for k in keys]),
               np.concatenate([jax_file[k].numpy().ravel() for k in keys])) < GRAD_REL
    assert isinstance(port_trainer.vae, VideoAutoencoderKL) and port_trainer.vae.config == VideoVAEConfig.tiny()
    assert jax_trainer.vae.config == JaxVideoVAEConfig.tiny()
    bundle = port_trainer.data_plane.bundles["clips"]
    assert sorted(bundle.metadata_backend.aspect_ratio_bucket_indices) == ["1.0x9", "1.5x9"]
    latents = bundle.vae_cache.load(bundle.metadata_backend.aspect_ratio_bucket_indices["1.5x9"][0])
    assert latents.shape == (3, 16, 24, 4)


def _read_mp4(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


def test_checkpoint_inference_writes_mp4(trainer_runs):
    """``run_inference`` from the port's checkpoint-2 on the CPU (the tiny T5
    encodes the prompt): one mp4 of ``validation_num_video_frames`` frames at
    the validation resolution, square."""
    import json

    root, _, _ = trainer_runs
    config = root / "render.json"
    values = _trainer_values(root, "port", pretrained_model_name_or_path=str(root / "wan.safetensors"),
                             validation_resolution=32, validation_num_video_frames=5, validation_guidance=2.0)
    config.write_text(json.dumps(values))
    output = str(root / "render")
    assert run_inference("a clip of waves", checkpoint=str(root / "port" / "checkpoint-2"), config_path=str(config),
                         output=output, steps=2, device="cpu") == 0
    (path,) = [os.path.join(output, "validation", f) for f in os.listdir(os.path.join(output, "validation"))]
    assert path.endswith(".mp4") and _read_mp4(path).shape == (5, 32, 32, 3)


# ---- validation render -----------------------------------------------------------------------------


def test_cfg_render_matches_jax(encoders, monkeypatch, tmp_path):
    """A true-CFG flow Euler render (Wan has no guidance embedding) through
    each package's ``Validation``: prompt and negative prompt encoded by the
    tiny T5 (the JAX params in the port's module), the same DiT weights and
    noise, 4 guided steps over 3 latent frames (9 frames) of 16 x 16, then
    the tiny video VAE's decode on one seeded tree: the latents within 1e-4
    (the render tolerance of test_torch_inference.py: f32, sum order only),
    the uint8 frames within one level, and both packages' mp4 files of 9
    frames at 32 x 32."""
    config = _tiny_values(model_type="full", validation_prompt=PROMPTS[0], validation_negative_prompt="blurry",
                          validation_guidance=3.5, validation_num_inference_steps=4, validation_resolution=32,
                          validation_seed=7, tokenizer_max_length=20)
    jmodel, model = _pair(config)
    jmodel.attach_text_encoders(encoders[0])
    model.attach_text_encoders(encoders[1])
    variables = {"params": _jax_params(jmodel, 3)}
    module = bridge(variables, model.create_module())
    jvae = JaxVideoAutoencoderKL(JaxVideoVAEConfig.tiny(), dtype=jnp.float32)
    vae_vars = numpy_variables(jvae, jnp.zeros((1, 5, 16, 16, 3)), seed=6)
    vae = bridge(vae_vars, VideoAutoencoderKL(VideoVAEConfig.tiny(), torch.float32))

    validation = Validation(model, config_namespace(config), device="cpu")
    validation.precompute_embeds()
    assert validation._wants_cfg() and validation._latent_shape(1) == (1, 3, 16, 16, 4)
    latents = validation._render_single(module, validation._embeds[0], 0)  # no decode_fn: the latents
    validation.decode_fn, validation.output_dir = vae.decode, str(tmp_path / "port")
    frames = validation._render_single(module, validation._embeds[0], 0)
    noise = torch.randn((1, 3, 16, 16, 4), generator=noise_generator(7, 0)).numpy()
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    jvalidation = JaxValidation(jmodel, JaxTrainingConfig(config))
    jvalidation.precompute_embeds()
    for ours, theirs in ((validation._embeds[0], jvalidation._embeds[0]),
                         (validation._negative_embeds, jvalidation._negative_embeds)):
        assert rel(ours["text_embeds"], theirs["text_embeds"]) < F32_REL
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    ref = np.asarray(jvalidation._render_single(jvars, jvalidation._embeds[0], 0))
    assert latents.shape == ref.shape == (3, 16, 16, 4) and np.isfinite(latents).all()
    assert rel(latents, ref) < 1e-4
    jvalidation = JaxValidation(jmodel, JaxTrainingConfig(config), output_dir=str(tmp_path / "jax"),
                                decode_fn=lambda z: jvae.apply(vae_vars, z, method=JaxVideoAutoencoderKL.decode))
    jvalidation.precompute_embeds()
    ref_frames = np.asarray(jvalidation._render_single(jvars, jvalidation._embeds[0], 0))
    assert frames.shape == ref_frames.shape == (9, 32, 32, 3) and frames.dtype == ref_frames.dtype == np.uint8
    assert np.abs(frames.astype(int) - ref_frames.astype(int)).max() <= 1
    (path,) = validation.run_validations(module, 3, force=True)
    (jax_path,) = jvalidation.run_validations(jvars, 3, force=True)
    assert os.path.basename(path) == os.path.basename(jax_path) == "step_3_0.mp4"
    assert _read_mp4(path).shape == _read_mp4(jax_path).shape == (9, 32, 32, 3)
