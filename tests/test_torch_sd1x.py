"""The torch port's SD 1.x / 2.x families against the JAX package, on the CPU.

The family contract and its refusals, the tiny UNet's prediction and LoRA
gradients through each family's loss (epsilon for ``sd1x``, the v target
under min-SNR for ``sd2x``) against ``jax.grad``, ``encode_text`` on the tiny
CLIP-L, SD 2.1's OpenCLIP-H text encoder read from its ``config.json``, the
diffusers UNet import (SD 1.5's 1x1-conv ``proj_in`` / ``proj_out`` and SD
2.1's Linear ones), adapter files, the JAX ``Trainer`` against the port's on
one cache (and ``run_inference`` from the port's checkpoint), and a true-CFG
DDIM render under v-prediction: the same seeded numpy weights, inputs and
noise go through both packages.  Every tolerance is stated where it is
checked.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.sd1x.model import SD1x as JaxSD1x
from simpletuner_tpu.models.sd1x.model import SD2x as JaxSD2x
from simpletuner_tpu.models.text_encoders import load_text_encoders as jax_load_text_encoders
from simpletuner_tpu.models.weight_import import load_unet_params as jax_load_unet_params
from simpletuner_tpu.training.lora import flatten_lora
from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora
from simpletuner_tpu.training.lora import save_lora_safetensors as jax_save_lora
from simpletuner_tpu.training.validation import Validation as JaxValidation
from simpletuner_tpu.training.validation import build_scheduler as jax_build_scheduler

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import unet_checkpoint_shapes
from simpletuner_tpu_torch.models.clip import CLIPTextConfig, clip_state_dict_from_flax
from simpletuner_tpu_torch.models.layers import init_adapters
from simpletuner_tpu_torch.models.registry import get_model_family
from simpletuner_tpu_torch.models.sd1x import SD1x, SD2x
from simpletuner_tpu_torch.models.text_encoders import load_text_encoders
from simpletuner_tpu_torch.models.unet import UNetConfig
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params, lora_to_flax
from simpletuner_tpu_torch.models.weight_import import load_safetensors_file, load_transformer_params, load_unet_params
from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors
from simpletuner_tpu_torch.training.validation import Validation, build_scheduler, noise_generator

from test_torch_weight_import import _assert_trees_bitwise, _seeded
from torch_parity import bridge, fill_numpy, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# gradient-derived numbers: f32 LoRA gradients through the whole UNet are
# 2-3e-5 off a float64 reference on either side (test_torch_unet.py)
GRAD_REL = 1e-4
PROMPTS = ["a lighthouse on a basalt cliff at dusk", "", "portrait of a cat"]
RENDER_PROMPT = "a seeded lighthouse"
FAMILIES = {"sd1x": (JaxSD1x, SD1x), "sd2x": (JaxSD2x, SD2x)}
# stabilityai/stable-diffusion-2-1's text_encoder/config.json (the values the port reads)
SD21_TEXT_ENCODER = {"architectures": ["CLIPTextModel"], "bos_token_id": 0, "eos_token_id": 2, "hidden_act": "gelu",
                     "hidden_size": 1024, "intermediate_size": 4096, "layer_norm_eps": 1e-05,
                     "max_position_embeddings": 77, "model_type": "clip_text_model", "num_attention_heads": 16,
                     "num_hidden_layers": 23, "pad_token_id": 1, "projection_dim": 512, "torch_dtype": "float32",
                     "vocab_size": 49408}


@pytest.fixture(autouse=True)
def _restore_jax_globals():
    """Building a JAX model family installs a process-wide LoRA target
    predicate and int8 matmul mode."""
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jl.set_lora_target(None)
    yield
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])


def _tiny_values(family, **extra):
    return {"model_family": family, "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    jax_cls, port_cls = FAMILIES[values["model_family"]]
    return jax_cls(JaxTrainingConfig(values)), port_cls(config_namespace(values))


# ---- the family contract ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_contract_and_refusals(family):
    jmodel, model = _pair(_tiny_values(family))
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR", "DDPM_BETA_START", "DDPM_BETA_END",
                 "DDPM_BETA_SCHEDULE", "LATENT_CHANNEL_COUNT", "SUPPORTS_TEXT_ENCODER_TRAINING"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch) == dataclasses.asdict(UNetConfig.tiny())
    full = {**_tiny_values(family), "model_arch_preset": None}
    preset = UNetConfig.sd15() if family == "sd1x" else UNetConfig.sd21()
    assert dataclasses.asdict(FAMILIES[family][1](config_namespace(full)).arch) == \
        dataclasses.asdict(FAMILIES[family][0](JaxTrainingConfig(full)).arch) == dataclasses.asdict(preset)
    assert model.prediction_type == ("epsilon" if family == "sd1x" else "v_prediction") and not model.is_flow
    alias = {"sd1x": "sd15", "sd2x": "sd21"}[family]
    assert type(get_model_family(config_namespace({**_tiny_values(family), "model_family": alias}))) is type(model)
    with pytest.raises(NotImplementedError, match="item 7"):
        FAMILIES[family][1](config_namespace(_tiny_values(family, max_grounding_entities=4)))
    with pytest.raises(NotImplementedError, match="item 7"):
        model.model_predict(None, {"control_latents": torch.zeros(1)})
    with pytest.raises(NotImplementedError, match="item 7"):
        model.controlnet_module()
    with pytest.raises(NotImplementedError, match="item 4i"):
        model.tokenize_captions(["a"])
    with pytest.raises(NotImplementedError, match="item 4i"):
        get_model_family(config_namespace(_tiny_values(family, train_text_encoder=True)))


def test_published_head_split_is_not_the_presets():
    """The JAX presets read ``attention_head_dim`` 64 as the head *dim*, and
    the port builds what they build: 5 / 10 / 20 heads of 64 at the three
    attention levels.  SD 2.1's published UNet has that split; SD 1.5's runs
    8 heads at every level (head dims 40 / 80 / 160), which a real file does
    not show: the weight shapes are the same (ROADMAP Queue 3)."""
    from simpletuner_tpu_torch.models.unet import UNet2DCondition

    for preset, context in ((UNetConfig.sd15(), 768), (UNetConfig.sd21(), 1024)):
        with torch.device("meta"):
            module = UNet2DCondition(preset)
        splits = [(getattr(module, f"down_{level}_attn_0").blocks_0.attn1.num_heads,
                   getattr(module, f"down_{level}_attn_0").blocks_0.attn1.head_dim) for level in range(3)]
        assert splits == [(5, 64), (10, 64), (20, 64)] and module.mid_attn.blocks_0.attn2.num_heads == 20
        assert module.down_0_attn_0.blocks_0.attn2.to_k.in_features == context
        assert not hasattr(module, "down_3_attn_0")  # the fourth level has no attention


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_build_scheduler_matches_jax(family):
    jmodel, model = _pair(_tiny_values(family))
    ours, theirs = build_scheduler(model, 12), jax_build_scheduler(jmodel, 12)
    assert type(ours).__name__ == type(theirs).__name__ == "DDIMScheduler"
    assert ours.prediction_type == theirs.prediction_type == model.prediction_type
    np.testing.assert_array_equal(ours.timesteps.numpy(), np.asarray(theirs.timesteps))
    np.testing.assert_allclose(ours.alphas_cumprod.numpy(), np.asarray(theirs.alphas_cumprod), rtol=1e-6, atol=1e-6)


# ---- the loss and its LoRA gradients ----------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_lora_grads_match_jax(family):
    """One batch through each family's ``loss_fn`` (noise and timesteps
    injected; ``sd2x`` on the v target with min-SNR gamma 5): the loss within
    ``F32_REL`` and every LoRA gradient against ``jax.grad`` within
    ``GRAD_REL`` in relative L2."""
    values = _tiny_values(family, snr_gamma=5.0 if family == "sd2x" else None)
    jmodel, model = _pair(values)
    rng = np.random.default_rng(3)
    batch = {"latents": rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
             "text_embeds": rng.standard_normal((2, 9, 32), dtype=np.float32),
             "override_noise": rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
             "override_timesteps": np.asarray([17, 803], np.int32)}
    jmodel.alphas_cumprod  # made concrete here: the JAX family caches it on first use, traced or not
    shapes = jax.eval_shape(lambda: jmodel.init_params(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items() if not k.startswith("override")}))
    variables = fill_numpy(shapes, seed=11)
    module = bridge(variables, model.create_module())

    def jax_loss(lora):
        return jmodel.loss_fn({"params": variables["params"], "lora": lora}, jax.random.PRNGKey(0),
                              {k: jnp.asarray(v) for k, v in batch.items()})[0]

    ref, grads = jax.jit(jax.value_and_grad(jax_loss))(jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(module)
    loss, aux = model.loss_fn(module, torch.Generator(), {k: t(v) for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - float(ref)) <= F32_REL * abs(float(ref))
    np.testing.assert_array_equal(aux["timesteps"].numpy(), batch["override_timesteps"])
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters)
    for path, param in adapters.items():
        assert param.grad is not None and rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


# ---- text encoding ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoders():
    """The JAX package's tiny CLIP-L (20 tokens) and the port's module with its params."""
    specs = [dataclasses.replace(s, max_length=20) for s in SD1x.TEXT_ENCODER_CONFIGURATION]
    jax_encoders = jax_load_text_encoders(specs, tiny=True)
    ports = load_text_encoders(specs, tiny=True, device="cpu")
    ports[0].model.load_state_dict(clip_state_dict_from_flax(jax_encoders[0].model.params))
    return jax_encoders, ports


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_encode_text_matches_jax(encoders, family):
    """The CLIP last hidden state and its mask per prompt; the collate drops the mask."""
    jmodel, model = _pair(_tiny_values(family))
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


def test_sd21_text_encoder_reads_its_config(tmp_path):
    """SD 2.1's ``text_encoder`` is OpenCLIP-H exported as an HF
    ``CLIPTextModel``: its published ``config.json`` reads as
    ``CLIPTextConfig.open_clip_h()`` (1024 wide, 23 layers, 16 heads, the exact
    erf ``gelu``), and a file of that layout (at a tiny width, written by
    transformers into ``SD2x``'s ``text_encoder`` subfolder) loads and
    encodes as the HF model does, within ``F32_REL`` in relative L2."""
    assert CLIPTextConfig.from_hf(SD21_TEXT_ENCODER) == CLIPTextConfig.open_clip_h()
    assert CLIPTextConfig.open_clip_h().hidden_act == "gelu"
    torch.manual_seed(0)
    tiny = {**SD21_TEXT_ENCODER, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 2, "vocab_size": 1000}
    config = transformers.CLIPTextConfig(**{k: v for k, v in tiny.items() if k not in ("architectures", "torch_dtype")})
    hf = transformers.CLIPTextModel(config).eval()
    hf.save_pretrained(str(tmp_path / "text_encoder"), safe_serialization=True)
    from simpletuner_tpu_torch.models.clip import load_clip_text

    port = load_clip_text(str(tmp_path / SD2x.TEXT_ENCODER_CONFIGURATION[0].subfolder))
    assert port.config.hidden_act == "gelu" and port.config.eos_token_id == 2
    ids = torch.from_numpy(np.random.default_rng(0).integers(3, 1000, (2, 77))).long()
    mask = torch.ones_like(ids)
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        out = port(ids, mask)["last_hidden_state"]
    assert rel(out.numpy(), ref.numpy()) < F32_REL


# ---- weight import and adapter files ---------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_unet_import_matches_jax_bitwise(tmp_path, family):
    """A seeded tiny diffusers UNet (two shards in ``unet/``; SD 1.5's
    ``proj_in`` / ``proj_out`` as 1x1 convs, SD 2.1's as Linear): the port's
    tree is bitwise the JAX ``load_unet_params`` tree, and the imported
    module bitwise the bridged JAX tree."""
    jmodel, model = _pair(_tiny_values(family))
    conv = family == "sd1x"
    weights = _seeded(unet_checkpoint_shapes(model.arch, conv_proj=conv), seed=4, dtype="f32")
    assert weights["down_blocks.0.attentions.0.proj_in.weight"].ndim == (4 if conv else 2)
    root = tmp_path / family / "unet"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: weights[k] for k in part}, str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_unet_params(jmodel, str(tmp_path / family))
    _assert_trees_bitwise(load_unet_params(model, str(tmp_path / family)), theirs)
    ours = load_transformer_params(model, init_adapters(model.create_module()), str(tmp_path / family))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def _seeded_adapters(model, seed, scale=1.0):
    module = tl.init_parameters(model.create_module(), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for param in tl.lora_parameters(module).values():
            param.copy_(torch.from_numpy(scale * rng.standard_normal(tuple(param.shape)).astype(np.float32)))
    return module


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_adapter_files_round_trip_with_jax(tmp_path, family):
    """Port -> JAX -> port bitwise in the diffusers layout (``unet.`` keys of
    ``unet_key_map``)."""
    jmodel, model = _pair(_tiny_values(family, lora_alpha=8))
    module = _seeded_adapters(model, 1)
    original = {k: v.detach().clone() for k, v in tl.lora_parameters(module).items()}
    first, second = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    save_lora_safetensors(model, module, first)
    jax_save_lora(jmodel, lora_to_flax(module), second)
    ours, theirs = load_safetensors_file(first), load_safetensors_file(second)
    assert sorted(ours) == sorted(theirs) and all(torch.equal(ours[k], theirs[k]) for k in theirs)
    assert any(k.startswith("unet.up_blocks.0.attentions.1.transformer_blocks.0.attn2.to_k.") for k in ours)
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
        rng = np.random.default_rng(4000 + step)
        batch["override_noise"] = rng.standard_normal(batch["latents"].shape).astype(np.float32)
        batch["override_timesteps"] = rng.integers(0, 1000, batch["latents"].shape[0]).astype(np.int32)
        return batch

    return next_batch


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def trainer_runs(request, tmp_path_factory):
    """The JAX ``Trainer`` and the port's on one cache: the tiny UNet from one
    seeded diffusers file, warm-started from one seeded adapter, 4 steps with
    the same noise and timesteps (``sd1x`` epsilon; ``sd2x`` the v target
    under min-SNR gamma 5).  The port's run also renders its final
    validation (true CFG, DDIM), and ``run_inference`` renders from its
    ``checkpoint-4``."""
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

    family = request.param
    root = tmp_path_factory.mktemp(f"{family}_trainer")
    _write_images(root / "data")
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    snr = {"snr_gamma": 5.0} if family == "sd2x" else {}
    values = lambda out, **extra: _values(root, out, model_family=family, **snr, **extra)  # noqa: E731
    port_model = FAMILIES[family][1](config_namespace(values("x")))
    unet_path = str(root / "unet.safetensors")
    save_safetensors(_seeded(unet_checkpoint_shapes(port_model.arch, conv_proj=family == "sd1x"), seed=3,
                             dtype="f32"), unet_path)
    lora_path = str(root / "init_lora.safetensors")
    save_lora_safetensors(port_model, _seeded_adapters(port_model, 4, scale=0.05), lora_path)
    extra = {"pretrained_model_name_or_path": unet_path, "init_lora": lora_path}
    # the captions' payloads, cached before either run (the tiny tokenizer's
    # salted hash would give every process other embeds)
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), family)
    rng = np.random.default_rng(5)
    for i in range(4):
        cache.save(f"photo {i}", {"text_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                                  "attention_mask": (np.arange(16) < 5).astype(np.int32)})
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
    return family, root, jax_trainer, port_trainer


def test_trainer_matches_jax(trainer_runs):
    """4 steps, no state shared between the runs: per-step loss within 1e-5
    relative (``TRAJECTORY_TOL``), grad norm within ``GRAD_REL``; the LoRA
    export matches the JAX export's names and, within ``GRAD_REL`` in
    relative L2, its tensors."""
    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    family, root, jax_trainer, port_trainer = trainer_runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [1, 2, 3, 4]
    for a, b in zip(ours, theirs):
        assert abs(a["loss"] - b["loss"]) <= TRAJECTORY_TOL * max(1.0, abs(b["loss"])), (a["step"], a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_REL * abs(b["grad_norm"]), (a["step"], a, b)
    export = "checkpoint-4/pytorch_lora_weights.safetensors"
    mine, jax_file = load_safetensors_file(str(root / "port" / export)), load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file)
    keys = sorted(mine)
    assert rel(np.concatenate([mine[k].numpy().ravel() for k in keys]),
               np.concatenate([jax_file[k].numpy().ravel() for k in keys])) < GRAD_REL
    with open(root / "port" / "checkpoint-4" / "trainer_state.json") as a, \
            open(root / "jax" / "checkpoint-4" / "trainer_state.json") as b:
        assert json.load(a) == json.load(b)
    assert port_trainer.model.NAME == jax_trainer.model.NAME == family
    assert port_trainer.model.prediction_type == jax_trainer.model.prediction_type


def test_checkpoint_inference_renders_the_final_validation(trainer_runs):
    """``run_inference`` from the run's checkpoint-4 renders its final
    validation image (true CFG, DDIM; v-prediction for ``sd2x``) byte for byte."""
    root = trainer_runs[1]
    final = root / "port" / "validation" / "step_4_0.png"
    rendered = root / "port_render" / "validation" / "step_4_0.png"
    assert final.read_bytes() == rendered.read_bytes() and len(final.read_bytes()) > 100


# ---- validation render -----------------------------------------------------------------------------


def test_v_prediction_cfg_render_matches_jax(encoders, monkeypatch):
    """A true-CFG DDIM render of ``sd2x`` (the v branch of DDIM) through each
    package's ``Validation``: prompt and negative prompt encoded by the tiny
    CLIP-L (the JAX params in the port's module), the same weights and noise,
    6 guided steps with rescale and the no-CFG threshold."""
    config = _tiny_values("sd2x", model_type="full", validation_prompt=PROMPTS[0],
                          validation_negative_prompt="blurry", validation_guidance=7.5,
                          validation_guidance_rescale=0.3, validation_no_cfg_until_timestep=1,
                          validation_num_inference_steps=6, validation_resolution=64, validation_seed=7,
                          tokenizer_max_length=20)
    jmodel, model = _pair(config)
    jmodel.attach_text_encoders(encoders[0])
    model.attach_text_encoders(encoders[1])
    jmodel.alphas_cumprod  # made concrete here: the JAX family caches it on first use, traced or not
    shapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jmodel.example_batch(1, 64)))
    variables = fill_numpy(shapes, seed=3)
    module = bridge(variables, model.create_module())

    validation = Validation(model, config_namespace(config), device="cpu")
    validation.precompute_embeds()
    assert validation._wants_cfg() and build_scheduler(model, 6).prediction_type == "v_prediction"
    out = validation._render_single(module, validation._embeds[0], 0)  # no decode_fn: the latents
    noise = torch.randn((1, 8, 8, 4), generator=noise_generator(7, 0)).numpy()
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    jvalidation = JaxValidation(jmodel, JaxTrainingConfig(config))
    jvalidation.precompute_embeds()
    ref = np.asarray(jvalidation._render_single(variables, jvalidation._embeds[0], 0))
    assert out.shape == ref.shape == (8, 8, 4) and np.isfinite(out).all()
    assert rel(out, ref) < 1e-4  # the render tolerance of test_torch_inference.py (f32, sum order only)
