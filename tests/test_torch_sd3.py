"""The torch port's SD3 family against the JAX package, on the CPU.

The transformer (sincos and learned position tables, qk RMSNorm on and off,
the ``context_pre_only`` last block), the diffusers-layout import, the
triple-encoder ``encode_text`` under both uncond behaviours, the LoRA train
step (30 steps on a dense base, 10 on an int8 base with int8 forward and dx
products), the trainer on one cache, and a true-CFG validation render: the
same seeded numpy weights, inputs and noise go through both packages.  Every
tolerance is stated where it is checked.

The JAX tiny SD3 takes its latent width from the data it is initialised on
(Flax infers ``patch_in``'s input), while its config, its example batch, its
import template and its render say 16 channels; the port builds the module
from the config.  So every case here feeds 16-channel latents, and the
trainer case gives both packages' tiny VAEs 16 latent channels.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models import vae as jvae_module
from simpletuner_tpu.models.sd3 import transformer as jt
from simpletuner_tpu.models.sd3.model import SD3 as JaxSD3
from simpletuner_tpu.models.text_encoders import load_text_encoders as jax_load_text_encoders
from simpletuner_tpu.models.weight_import import load_sd3_params as jax_load_sd3_params
from simpletuner_tpu.training import quantization as jq
from simpletuner_tpu.training.lora import sd3_key_map as jax_sd3_key_map
from simpletuner_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from simpletuner_tpu.training.schedules import get_lr_schedule as jax_get_lr_schedule
from simpletuner_tpu.training.train_state import build_train_step as jax_build_train_step
from simpletuner_tpu.training.train_state import create_train_state as jax_create_train_state
from simpletuner_tpu.training.validation import Validation as JaxValidation

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models import vae as tvae_module
from simpletuner_tpu_torch.models.checkpoint_layouts import sd3_checkpoint_shapes
from simpletuner_tpu_torch.models.clip import clip_state_dict_from_flax
from simpletuner_tpu_torch.models.layers import init_adapters
from simpletuner_tpu_torch.models.sd3 import SD3, SD3Config, SD3Transformer
from simpletuner_tpu_torch.models.sd3 import transformer as tt
from simpletuner_tpu_torch.models.t5 import t5_state_dict_from_flax
from simpletuner_tpu_torch.models.text_encoders import load_text_encoders
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params, lora_to_flax
from simpletuner_tpu_torch.models.weight_import import load_sd3_params, load_transformer_params
from simpletuner_tpu_torch.training.optimizers import get_optimizer
from simpletuner_tpu_torch.training.schedules import get_lr_schedule
from simpletuner_tpu_torch.training.train_state import build_train_step, create_train_state
from simpletuner_tpu_torch.training.validation import Validation, noise_generator

from test_torch_quantization import _assert_tracks, _code_flips, _flat, _recording_codes, _sync
from test_torch_weight_import import _assert_trees_bitwise, _seeded
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
PROMPTS = ["a lighthouse on a basalt cliff at dusk", "", "portrait of a cat", "   "]


@pytest.fixture(autouse=True)
def _restore_jax_globals():
    """Building a JAX model family installs a process-wide LoRA target
    predicate and int8 matmul mode; the module-level cases adapt every LoRADense."""
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jl.set_lora_target(None)
    yield
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])


def _tiny(**changes):
    return (dataclasses.replace(jt.SD3Config.tiny(), **changes), dataclasses.replace(SD3Config.tiny(), **changes))


def _inputs(seed, batch=2, height=8, width=12, txt=10):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, height, width, 16), dtype=np.float32),
            rng.uniform(0.05, 0.95, batch).astype(np.float32),
            rng.standard_normal((batch, txt, 96), dtype=np.float32),
            rng.standard_normal((batch, 96), dtype=np.float32))


# ---- the transformer ----------------------------------------------------------------------------


def test_posemb_2d_sincos_matches_jax():
    np.testing.assert_allclose(tt.posemb_2d_sincos(6, 10, 64).numpy(), np.asarray(jt.posemb_2d_sincos(6, 10, 64)),
                               atol=1e-6)  # f32 sin/cos of the same arguments


@pytest.mark.parametrize("context_pre_only", [False, True])
def test_mmdit_block_matches_jax(context_pre_only):
    cfg_j, cfg_t = _tiny()
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 24, 64), dtype=np.float32)
    txt = rng.standard_normal((2, 7, 64), dtype=np.float32)
    vec = rng.standard_normal((2, 64), dtype=np.float32)
    block = jt.MMDiTBlock(cfg_j, context_pre_only=context_pre_only, dtype=jnp.float32, lora_rank=4)
    variables = numpy_variables(block, img, txt, vec)
    ref_img, ref_txt = jax.jit(block.apply)(variables, img, txt, vec)
    port = bridge(variables, tt.MMDiTBlock(cfg_t, context_pre_only=context_pre_only, dtype=torch.float32,
                                           lora_rank=4))
    assert hasattr(port, "txt_mlp_in") != context_pre_only and len(port.txt_mod(t(vec))) == (2 if context_pre_only else 6)
    with torch.no_grad():
        out_img, out_txt = port(t(img), t(txt), t(vec))
    assert rel(out_img.numpy(), np.asarray(ref_img)) < F32_REL
    assert rel(out_txt.numpy(), np.asarray(ref_txt)) < F32_REL
    if context_pre_only:  # the text stream passes through untouched
        np.testing.assert_array_equal(out_txt.numpy(), txt)


@pytest.mark.parametrize("qk_norm", [True, False], ids=["qk_norm", "no_qk_norm"])
@pytest.mark.parametrize("pos_embed_max_size", [0, 8], ids=["sincos", "learned"])
def test_sd3_transformer_matches_jax(pos_embed_max_size, qk_norm):
    # the learned table (8 x 8) is centre-cropped to the 4 x 6 patch grid
    cfg_j, cfg_t = _tiny(pos_embed_max_size=pos_embed_max_size, qk_norm=qk_norm)
    inputs = _inputs(2)
    model = jt.SD3Transformer(config=cfg_j, dtype=jnp.float32, lora_rank=4)
    variables = numpy_variables(model, *inputs)
    ref = np.asarray(jax.jit(model.apply)(variables, *inputs))
    port = bridge(variables, SD3Transformer(cfg_t, dtype=torch.float32, lora_rank=4))
    with torch.no_grad():
        out = port(*(t(x) for x in inputs))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel(out.numpy(), ref) < F32_REL  # measured: 1.3e-6 to 2.7e-6


def test_sd3_transformer_refusals_and_init():
    port = SD3Transformer(SD3Config.tiny(), dtype=torch.float32)
    inputs = [t(x) for x in _inputs(3, height=4, width=4)]
    with pytest.raises(NotImplementedError, match="item 4d"):
        port(*inputs, skip_layers=(0,))
    with pytest.raises(NotImplementedError, match="item 7"):
        port(*inputs, controlnet_block_residuals=(inputs[0],))
    learned = tl.init_parameters(SD3Transformer(_tiny(pos_embed_max_size=8)[1]), torch.Generator().manual_seed(0))
    assert learned.pos_embed.dtype == torch.float32 and abs(learned.pos_embed.std().item() - 0.02) < 4e-3
    assert (learned.block_1.txt_mod.lin.weight == 0).all()  # AdaLN-Zero


# ---- weight import ------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sd3_import_matches_jax_bitwise(tmp_path, dtype):
    """A seeded diffusers file (learned table, qk norm, two shards): the port's
    import is bitwise the bridged ``sd3_params_from_diffusers`` tree."""
    arch_j, arch_t = _tiny(pos_embed_max_size=8, depth=3)
    weights = _seeded(sd3_checkpoint_shapes(arch_t), seed=4, dtype=dtype)
    root = tmp_path / "sd3" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: weights[k] for k in part}, str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    config = {"model_family": "sd3", "model_type": "lora", "lora_rank": 4, "mixed_precision": "fp32"}
    jmodel = JaxSD3(JaxTrainingConfig(config), arch=arch_j)
    model = SD3(config_namespace(config), arch=arch_t)
    theirs = jax_load_sd3_params(jmodel, str(tmp_path / "sd3"))
    _assert_trees_bitwise(load_sd3_params(model, str(tmp_path / "sd3")), theirs)
    ours = load_transformer_params(model, init_adapters(model.create_module()), str(tmp_path / "sd3"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name
    # the layout is the one the JAX package's own SD3 import test writes
    from test_sd3_import import _params_to_diffusers

    written = _params_to_diffusers(jax.tree_util.tree_map(np.asarray, theirs), arch_j)
    assert {k: tuple(v.shape) for k, v in written.items()} == sd3_checkpoint_shapes(arch_t)
    # the last block's context modulation and norm_out arrive with their halves swapped
    raw = weights["transformer_blocks.2.norm1_context.linear.weight"].astype(np.float32)
    got = ours.block_2.txt_mod.lin.weight.detach().numpy()
    np.testing.assert_array_equal(got, np.concatenate([raw[64:], raw[:64]]))


# ---- text encoding ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoders():
    """The JAX package's tiny CLIP-L, CLIP-G and T5 (24 tokens) and the port's
    modules with their params."""
    specs = [dataclasses.replace(s, max_length=24) for s in SD3.TEXT_ENCODER_CONFIGURATION]
    jax_encoders = jax_load_text_encoders(specs, tiny=True)
    ports = load_text_encoders(specs, tiny=True, device="cpu")
    for port, theirs, convert in zip(ports, jax_encoders, (clip_state_dict_from_flax, clip_state_dict_from_flax,
                                                            t5_state_dict_from_flax)):
        port.model.load_state_dict(convert(theirs.model.params))
    return jax_encoders, ports


@pytest.mark.parametrize("clip, t5", [("empty_string", None), ("zero", None), ("empty_string", "zero"),
                                      ("zero", "empty_prompt")])
def test_encode_text_matches_jax(encoders, clip, t5):
    """SD3.encode_text on the JAX package's tiny CLIP-L, CLIP-G and T5 and on
    the port's modules with their params: the cache payload, key for key,
    with the empty prompts' segments zeroed as each uncond behaviour asks."""
    config = {"model_family": "sd3", "model_arch_preset": "tiny", "sd3_clip_uncond_behaviour": clip,
              "sd3_t5_uncond_behaviour": t5}
    jmodel, model = JaxSD3(JaxTrainingConfig(config)), SD3(config_namespace(config))
    jmodel.attach_text_encoders(encoders[0])
    model.attach_text_encoders(encoders[1])
    ours, theirs = model.encode_text(PROMPTS), jmodel.encode_text(PROMPTS)
    for prompt, a, b in zip(PROMPTS, ours, theirs):
        assert sorted(a) == sorted(b) == ["pooled_embeds", "text_embeds"]
        assert a["text_embeds"].shape == b["text_embeds"].shape == (48, 96) and a["pooled_embeds"].shape == (96,)
        for key in b:
            assert a[key].dtype == b[key].dtype == np.float32
            # f32 encoders on both sides; a zeroed segment is exactly zero on both
            assert np.abs(a[key] - b[key]).max() <= F32_REL * max(np.abs(b[key]).max(), 1.0), (prompt, key)
        if not prompt.strip():
            assert (not a["pooled_embeds"].any()) == (clip == "zero")
            assert (not a["text_embeds"][24:].any()) == ((t5 or clip) == "zero")


# ---- the LoRA train step ------------------------------------------------------------------------

BATCH, LATENT, TXT = 2, 8, 20


def _train_config(steps, **extra):
    return {"model_family": "sd3", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", "optimizer": "adamw", "learning_rate": 1e-3, "adam_weight_decay": 0.01,
            "max_grad_norm": 1.0, "lr_scheduler": "constant", "max_train_steps": steps, **extra}


def _steps(seed, steps):
    rng = np.random.default_rng(seed)
    batch = {"latents": rng.standard_normal((BATCH, LATENT, LATENT, 16), dtype=np.float32),
             "text_embeds": rng.standard_normal((BATCH, TXT, 96), dtype=np.float32),
             "pooled_embeds": rng.standard_normal((BATCH, 96), dtype=np.float32)}
    noises = rng.standard_normal((steps, BATCH, LATENT, LATENT, 16), dtype=np.float32)
    sigmas = rng.uniform(0.05, 0.95, (steps, BATCH)).astype(np.float32)
    return [{**batch, "override_noise": noises[i], "override_sigmas": sigmas[i]} for i in range(steps)]


def _pair(config, batches, quantize=False):
    """JAX and port train states and steps on the same seeded weights."""
    jax_model = JaxSD3(JaxTrainingConfig(config))  # installs the LoRA target and int8 matmul mode
    shapes = jax.eval_shape(lambda: jax_model.init_params(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batches[0].items() if not k.startswith("override")}))
    variables = fill_numpy(shapes, seed=11)
    jconfig = JaxTrainingConfig(config)
    schedule_j = jax_get_lr_schedule(jconfig, len(batches))
    tx_j = jax_get_optimizer(jconfig, schedule_j)
    state_j = jax_create_train_state(jax_model, jax.tree_util.tree_map(jnp.asarray, variables), tx_j,
                                     quantize_mode=jq.resolve_precision(jconfig) if quantize else None)
    model = SD3(config_namespace(config))
    schedule_t = get_lr_schedule(model.config, len(batches))
    tx_t = get_optimizer(model.config, schedule_t)
    state_t = create_train_state(model, bridge(variables, model.create_module()), tx_t,
                                 quantize_mode=model.base_precision)
    return (state_j, jax.jit(jax_build_train_step(jax_model, tx_j, schedule_j)),
            state_t, build_train_step(model, tx_t, schedule_t))


def test_lora_trajectory_tracks_jax():
    steps = 30
    batches = _steps(7, steps)
    state_j, step_j, state_t, step_t = _pair(_train_config(steps), batches)
    assert set(_flat(lora_to_flax(state_t.module))) == set(_flat(state_j.trainable["lora"]))
    ours, theirs, norms = [], [], []
    for i, batch in enumerate(batches):
        state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(i))
        state_t, m_t = step_t(state_t, {k: t(v) for k, v in batch.items()}, torch.Generator())
        ours.append(float(m_t["loss"]))
        theirs.append(float(m_j["loss"]))
        norms.append((float(m_t["grad_norm"]), float(m_j["grad_norm"])))
        assert float(m_t["skipped_nonfinite"]) == 0.0
    assert max(n for _, n in norms) > 1.0  # the clip at max_grad_norm 1.0 is exercised
    # f32, the same math on both sides: the curves stay within 1e-6 of each
    # other over 30 steps (measured), checked at the Flux trajectory's 1e-4
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    np.testing.assert_allclose([n for n, _ in norms], [n for _, n in norms], rtol=1e-4)
    assert ours[-1] < ours[0]
    final_j, final_t = _flat(state_j.trainable["lora"]), _flat(lora_to_flax(state_t.module))
    for key in final_j:
        assert rel(final_t[key], final_j[key]) < 1e-4, key


def test_int8_full_trajectory_tracks_jax():
    """10 steps on an int8 base with int8 forward and dx products, every port
    step started from the JAX state: each step whose int8 codes agree on both
    sides within 1e-5, a step with a flipped code within 5e-3 (the Flux int8 runs'
    flip-counted bounds, ``test_torch_quantization._assert_tracks``)."""
    steps = 10
    config = _train_config(steps, base_model_precision="int8-quanto", quantized_matmul="full")
    batches = _steps(8, steps)
    out = {"ours": [], "theirs": [], "norm_ours": [], "norm_theirs": [], "adapters": [], "flips": []}
    with _recording_codes() as codes:
        state_j, step_j, state_t, step_t = _pair(config, batches, quantize=True)
        assert all(m.quant == "int8" and m.quantized_matmul == "full"
                   for m in state_t.module.modules() if isinstance(m, tl.LoRADense))
        for i, batch in enumerate(batches):
            _sync(state_t, state_j)
            for log in codes:
                log.clear()
            state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(i))
            state_t, m_t = step_t(state_t, {k: t(v) for k, v in batch.items()}, torch.Generator())
            jax.effects_barrier()
            out["flips"].append(_code_flips(*codes))
            out["ours"].append(float(m_t["loss"]))
            out["theirs"].append(float(m_j["loss"]))
            out["norm_ours"].append(float(m_t["grad_norm"]))
            out["norm_theirs"].append(float(m_j["grad_norm"]))
            final_j, final_t = _flat(state_j.trainable["lora"]), _flat(lora_to_flax(state_t.module))
            out["adapters"].append(max(rel(final_t[key], final_j[key]) for key in final_j))
    _assert_tracks(out, int8_products=True)


# ---- validation render --------------------------------------------------------------------------


def test_cfg_render_matches_jax(encoders, monkeypatch):
    """A true-CFG render (SD3 has no guidance embedding) through each
    package's ``Validation``: prompt and negative prompt encoded by the tiny
    encoders (the JAX ones' params in the port's modules), the same weights and
    noise, 8 guided Euler steps with rescale and the no-CFG threshold."""
    config = {"model_family": "sd3", "model_arch_preset": "tiny", "mixed_precision": "fp32", "model_type": "full",
              "validation_prompt": PROMPTS[0], "validation_negative_prompt": "blurry", "validation_guidance": 5.0,
              "validation_guidance_rescale": 0.5, "validation_num_inference_steps": 8, "validation_resolution": 64,
              "validation_seed": 7, "tokenizer_max_length": 24}
    jmodel, model = JaxSD3(JaxTrainingConfig(config)), SD3(config_namespace(config))
    jmodel.attach_text_encoders(encoders[0])
    model.attach_text_encoders(encoders[1])
    latents = np.zeros((1, 8, 8, 16), np.float32)
    variables = numpy_variables(jmodel.module, latents, np.zeros(1, np.float32), np.zeros((1, 48, 96), np.float32),
                                np.zeros((1, 96), np.float32), seed=3)
    module = bridge(variables, model.create_module())

    validation = Validation(model, config_namespace(config), device="cpu")
    validation.precompute_embeds()
    assert validation._wants_cfg() and validation._negative_embeds is not None
    out = validation._render_single(module, validation._embeds[0], 0)  # no decode_fn: the latents
    noise = torch.randn((1, 8, 8, 16), generator=noise_generator(7, 0)).numpy()
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    jvalidation = JaxValidation(jmodel, JaxTrainingConfig(config))
    jvalidation.precompute_embeds()
    for ours, theirs in ((validation._embeds[0], jvalidation._embeds[0]),
                         (validation._negative_embeds, jvalidation._negative_embeds)):
        assert rel(ours["text_embeds"], theirs["text_embeds"]) < F32_REL
    ref = np.asarray(jvalidation._render_single(variables, jvalidation._embeds[0], 0))
    assert out.shape == ref.shape == (8, 8, 16)
    assert rel(out, ref) < 1e-4  # the render tolerance of test_torch_inference.py (f32, sum order only)


# ---- the trainer --------------------------------------------------------------------------------


def _tiny_vae_16(module):
    """Give a package's tiny VAE 16 latent channels, SD3's width."""
    original = module.VAEConfig.tiny

    def tiny(cls):
        return dataclasses.replace(original(), latent_channels=16)

    return classmethod(tiny)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The JAX ``Trainer`` and the port's on one cache: tiny SD3 from one
    seeded diffusers file, warm-started from one seeded adapter, 4 steps
    with the same noise and sigmas (the Flux trainer test's recipe)."""
    from simpletuner_tpu.data.dataset import MultiDatasetIterator as JaxIterator
    from simpletuner_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from simpletuner_tpu.training import trainer as jax_trainer_module
    from simpletuner_tpu.training.trainer import Trainer as JaxTrainer

    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
    from simpletuner_tpu_torch.data.dataset import MultiDatasetIterator
    from simpletuner_tpu_torch.models.weight_import import save_safetensors
    from simpletuner_tpu_torch.training.lora import save_lora_safetensors
    from simpletuner_tpu_torch.training.trainer import Trainer

    from test_torch_trainer import _overriding, _values, _write_images

    root = tmp_path_factory.mktemp("sd3_trainer")
    _write_images(root / "data")
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    values = lambda out, **extra: _values(root, out, model_family="sd3", **extra)  # noqa: E731
    port_model = SD3(config_namespace(values("x")))
    sd3_path = str(root / "sd3.safetensors")
    save_safetensors(_seeded(sd3_checkpoint_shapes(port_model.arch), seed=3, dtype="f32"), sd3_path)
    module = port_model.create_module()
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for param in tl.lora_parameters(module).values():
            param.copy_(torch.randn(param.shape, generator=gen) * 0.05)
    lora_path = str(root / "init_lora.safetensors")
    save_lora_safetensors(port_model, module, lora_path)
    extra = {"pretrained_model_name_or_path": sd3_path, "init_lora": lora_path}
    # the captions' payloads, cached before either run (the tiny tokenizer's
    # salted hash would give every process other embeds)
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "sd3")
    rng = np.random.default_rng(5)
    for i in range(4):
        cache.save(f"photo {i}", {"text_embeds": rng.standard_normal((32, 96)).astype(np.float32),
                                  "pooled_embeds": rng.standard_normal(96).astype(np.float32)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvae_module.VAEConfig, "tiny", _tiny_vae_16(jvae_module))
        mp.setattr(tvae_module.VAEConfig, "tiny", _tiny_vae_16(tvae_module))
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
    """Per-step loss and grad norm within 1e-5 relative (f32 on both sides);
    the LoRA export holds the JAX ``sd3_key_map`` names, and its tensors
    match the JAX export within 1e-5 in relative L2."""
    from simpletuner_tpu_torch.models.weight_import import load_safetensors_file

    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    root, jax_trainer, port_trainer = trainer_runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [1, 2, 3, 4]
    for a, b in zip(ours, theirs):
        for key in ("loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= TRAJECTORY_TOL * max(1.0, abs(b[key])), (a["step"], key, a[key], b[key])
    export = "checkpoint-4/pytorch_lora_weights.safetensors"
    mine, jax_file = load_safetensors_file(str(root / "port" / export)), load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file)
    # every JAX map entry but the last block's text projection and MLP, which
    # a context_pre_only block does not have; patch_in and context_in keep their names
    arch = jax_trainer.model.arch
    last = f"block_{arch.depth - 1}/"
    names = {theirs for ours, theirs in jax_sd3_key_map(arch).items()
             if not ours.startswith((last + "txt_attn_proj", last + "txt_mlp"))}
    modules = {k.removeprefix("transformer.").rsplit(".lora_", 1)[0] for k in mine}
    assert modules == names | {"patch_in", "context_in"}
    for key in mine:
        assert rel(mine[key].numpy(), jax_file[key].numpy()) < TRAJECTORY_TOL, key
    with open(root / "port" / "checkpoint-4" / "trainer_state.json") as a, \
            open(root / "jax" / "checkpoint-4" / "trainer_state.json") as b:
        assert json.load(a) == json.load(b)
    assert port_trainer.model.NAME == "sd3" and os.path.exists(root / "port" / "checkpoint-2")
