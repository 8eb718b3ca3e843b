"""The torch port's Kolors family against the JAX package, on the CPU.

The presets (the SDXL UNet with a 4,096-wide cross-attention and a 4,096
pooled vector; the tiny preset narrowed to the tiny ChatGLM's 32), the
family contract, ``encode_text`` on a tiny ``chatglm`` trunk (the pooled
vector the last valid token's state, the mask dropped by the collate), the
UNet forward through ``model_predict`` and LoRA DDPM train steps with
injected noise and timesteps, the import of a seeded diffusers UNet and the
key map with an adapter file: the same seeded numpy weights and inputs go
through both packages.  The trainers' trajectories are in
test_torch_kolors_trainer.py.  Every tolerance is stated where it is
checked.
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
from simpletuner_tpu.models.kolors.model import Kolors as JaxKolors
from simpletuner_tpu.models.llm_encoder import LLMEncoder as JaxLLMEncoder
from simpletuner_tpu.models.llm_encoder import LLMEncoderConfig as JaxLLMConfig
from simpletuner_tpu.models.registry import ModelRegistry as JaxModelRegistry
from simpletuner_tpu.models.text_encoders import LLMTextEncoder as JaxLLMTextEncoder
from simpletuner_tpu.models.weight_import import load_unet_params as jax_load_unet_params
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS
from simpletuner_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from simpletuner_tpu.training.schedules import get_lr_schedule as jax_get_lr_schedule
from simpletuner_tpu.training.train_state import build_train_step as jax_build_train_step
from simpletuner_tpu.training.train_state import create_train_state as jax_create_train_state

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import unet_checkpoint_shapes
from simpletuner_tpu_torch.models.common import TextEncoderSpec
from simpletuner_tpu_torch.models.kolors import Kolors
from simpletuner_tpu_torch.models.llm_encoder import LLMEncoder, LLMEncoderConfig
from simpletuner_tpu_torch.models.registry import PORTED, ModelRegistry, get_model_family
from simpletuner_tpu_torch.models.text_encoders import LLMTextEncoder, _TinyTokenizer
from simpletuner_tpu_torch.models.unet import UNetConfig
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params, lora_to_flax
from simpletuner_tpu_torch.models.weight_import import load_transformer_params, load_unet_params
from simpletuner_tpu_torch.training.lora import _key_map_for, unet_key_map
from simpletuner_tpu_torch.training.optimizers import get_optimizer
from simpletuner_tpu_torch.training.schedules import get_lr_schedule
from simpletuner_tpu_torch.training.train_state import build_train_step, create_train_state

from test_torch_quantization import _flat, _sync
from test_torch_weight_import import _assert_trees_bitwise, _seeded
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# gradients and what an AdamW step makes of them (test_torch_sdxl.py: f32
# LoRA gradients through the whole UNet are 2-3e-5 off float64 on either side)
GRAD_REL = 1e-4
PROMPTS = ["a lighthouse on a basalt cliff at dusk", "", "portrait of a cat"]
BATCH, LATENT, TXT = 2, 8, 12


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
    return {"model_family": "kolors", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxKolors(JaxTrainingConfig(values)), Kolors(config_namespace(values))


@pytest.mark.parametrize("preset", ["tiny", None])
def test_presets_and_contract_match_jax(preset):
    """The tiny and published archs as the JAX family builds them (the
    published one SDXL's UNet with ``cross_attention_dim`` 4096 and
    ``addition_embed_dim`` 6 x 256 + 4096: 2.94B parameters in the diffusers
    layout, the cross-attention k / v 4,096 wide); the constants, the
    ChatGLM spec at 256 tokens, the pooled width, the example batch; the
    registry builds it; a flow-matching prediction type is refused."""
    values = _tiny_values(model_arch_preset=preset)
    jmodel, model = _pair(values)
    assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch)
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "MODALITY", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR",
                 "HUGGINGFACE_PATHS", "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR",
                 "LATENT_CHANNEL_COUNT", "DDPM_BETA_START", "DDPM_BETA_END", "DDPM_BETA_SCHEDULE"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert model.TEXT_ENCODER_CONFIGURATION[0].max_length == 256 and not model.is_flow
    assert model._pooled_dim == jmodel._pooled_dim == (32 if preset else 4096)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 128).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 128).items()}
    assert "kolors" in PORTED and type(get_model_family(config_namespace(values))) is Kolors
    assert JaxModelRegistry.metadata("kolors") == ModelRegistry.metadata("kolors")
    with pytest.raises(ValueError, match="epsilon"):
        Kolors(config_namespace(_tiny_values(prediction_type="flow_matching"))).check_user_config()
    if preset is None:
        assert model.arch == dataclasses.replace(UNetConfig.sdxl(), cross_attention_dim=4096,
                                                 addition_embed_dim=6 * 256 + 4096)
        shapes = unet_checkpoint_shapes(model.arch)
        assert sum(int(np.prod(s)) for s in shapes.values()) == 2_935_236_164
        assert shapes["down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_k.weight"] == (640, 4096)
        assert shapes["add_embedding.linear_1.weight"] == (1280, 5632)


def _chatglm_pair(seed=5, max_length=12):
    """The tiny ``chatglm`` trunk in both packages on one seeded numpy tree
    (f32), behind one tokenizer (the tiny one's ids are per process)."""
    from simpletuner_tpu.models.common import TextEncoderSpec as JaxSpec

    jmodule = JaxLLMEncoder(JaxLLMConfig.tiny("chatglm"), dtype=jnp.float32)
    variables = numpy_variables(jmodule, jnp.zeros((1, 8), jnp.int32), seed=seed)
    tokenizer = _TinyTokenizer(max_length)
    fields = dict(name="chatglm", family="chatglm", subfolder="text_encoder", max_length=max_length)
    jenc = JaxLLMTextEncoder(JaxSpec(**fields), JaxLLMConfig.tiny("chatglm"),
                             jax.tree_util.tree_map(jnp.asarray, variables["params"]), tokenizer)
    jenc.module = jmodule  # f32: read when the encode is traced
    port = bridge(variables, LLMEncoder(LLMEncoderConfig.tiny("chatglm"), dtype=torch.float32)).eval()
    return jenc, LLMTextEncoder(TextEncoderSpec(**fields), port, tokenizer)


def test_encode_text_matches_jax():
    """``encode_text`` on a tiny ``chatglm`` trunk (fused qkv with biases,
    partial interleaved rope) in f32, both packages on one tree: the states
    (12 tokens x 32) and the pooled vector within ``F32_REL``, the masks
    equal; the pooled vector is the state of each prompt's last valid token
    (the empty prompt's is its eos token's); the collate keeps the states and
    the pooled vectors and drops the mask."""
    jmodel, model = _pair(_tiny_values())
    jenc, enc = _chatglm_pair()
    jmodel.attach_text_encoders([jenc])
    model.attach_text_encoders([enc])
    ours, theirs = model.encode_text(PROMPTS), jmodel.encode_text(PROMPTS)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "pooled_embeds", "text_embeds"]
        assert a["text_embeds"].shape == (12, 32) and a["pooled_embeds"].shape == (32,)
        np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
        for key in ("text_embeds", "pooled_embeds"):
            assert a[key].dtype == b[key].dtype == np.float32 and rel(a[key], b[key]) < F32_REL, key
        last = int(a["attention_mask"].sum()) - 1
        np.testing.assert_array_equal(a["pooled_embeds"], a["text_embeds"][last])
    assert [int(a["attention_mask"].sum()) for a in ours] == [9, 1, 5]  # 8 words + eos, eos, 4 words + eos
    collated, jcollated = model.collate_text_embeds(ours), jmodel.collate_text_embeds(theirs)
    assert sorted(collated) == sorted(jcollated) == ["pooled_embeds", "text_embeds"]
    for key in collated:
        np.testing.assert_array_equal(collated[key], np.stack([a[key] for a in ours]))
        assert rel(collated[key], jcollated[key]) < F32_REL


# ---- the UNet forward and the DDPM LoRA train step -------------------------------------------------


def _batches(seed, steps):
    rng = np.random.default_rng(seed)
    batch = {"latents": rng.standard_normal((BATCH, LATENT, LATENT, 4), dtype=np.float32),
             "text_embeds": rng.standard_normal((BATCH, TXT, 32), dtype=np.float32),
             "pooled_embeds": rng.standard_normal((BATCH, 32), dtype=np.float32),
             "original_sizes": np.asarray([[64, 64], [80, 64]], np.int32),
             "crop_coordinates": np.asarray([[0, 0], [8, 0]], np.int32),
             "target_sizes": np.asarray([[64, 64], [64, 64]], np.int32)}
    noises = rng.standard_normal((steps, BATCH, LATENT, LATENT, 4), dtype=np.float32)
    timesteps = rng.integers(0, 1000, (steps, BATCH)).astype(np.int32)
    return [{**batch, "override_noise": noises[i], "override_timesteps": timesteps[i]} for i in range(steps)]


def _variables(jax_model, batch, seed):
    jax_model.alphas_cumprod  # made concrete here: the JAX family caches it on first use, traced or not
    shapes = jax.eval_shape(lambda: jax_model.init_params(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items() if not k.startswith("override")}))
    return fill_numpy(shapes, seed=seed)


def test_unet_forward_matches_jax():
    """The tiny Kolors UNet through ``model_predict`` (the added conditioning
    from the collate's sizes and the 32-wide pooled vector, the
    cross-attention over 12 unmasked ChatGLM tokens) and ``denoise_fn`` (the
    default time ids) at two timesteps: within ``F32_REL`` of the JAX family's."""
    values = _tiny_values()
    jmodel, model = _pair(values)
    batch = _batches(3, 1)[0]
    variables = _variables(jmodel, batch, seed=12)
    module = bridge(variables, model.create_module())
    prepared = {**{k: v for k, v in batch.items() if not k.startswith("override")},
                "noisy_latents": batch["latents"], "timesteps": np.asarray([10, 900], np.int32)}
    theirs = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                      jax.tree_util.tree_map(jnp.asarray, prepared)))
    cond_keys = ("text_embeds", "pooled_embeds")
    jcond = jmodel.inference_conditioning({k: jnp.asarray(batch[k]) for k in ("latents",) + cond_keys})
    jden = np.asarray(jmodel.denoise_fn(jax.tree_util.tree_map(jnp.asarray, variables), jcond)(
        jnp.asarray(batch["latents"]), 500))
    with torch.no_grad():
        ours = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
        cond = model.inference_conditioning({k: t(batch[k]) for k in ("latents",) + cond_keys})
        den = model.denoise_fn(module, cond)(t(batch["latents"]), torch.tensor(500)).numpy()
    assert ours.shape == theirs.shape == batch["latents"].shape and rel(ours, theirs) < F32_REL
    assert rel(den, jden) < F32_REL


def test_lora_train_steps_match_jax():
    """3 LoRA DDPM steps (epsilon, min-SNR gamma 5) on the same seeded base
    and adapters, noise and timesteps injected, each port step started from
    the JAX state (adapters and Adam moments, ``_sync``): the loss per step
    within 1e-5 relative, the grad norm within ``GRAD_REL``, and the adapters
    after each step within ``GRAD_REL`` in relative L2 over all adapters."""
    steps = 3
    values = _tiny_values(optimizer="adamw", learning_rate=1e-3, adam_weight_decay=0.01, max_grad_norm=1.0,
                          lr_scheduler="constant", max_train_steps=steps, snr_gamma=5.0)
    batches = _batches(7, steps)
    jax_model = JaxKolors(JaxTrainingConfig(values))
    variables = _variables(jax_model, batches[0], seed=11)
    jconfig = JaxTrainingConfig(values)
    schedule_j = jax_get_lr_schedule(jconfig, steps)
    tx_j = jax_get_optimizer(jconfig, schedule_j)
    state_j = jax_create_train_state(jax_model, jax.tree_util.tree_map(jnp.asarray, variables), tx_j)
    step_j = jax.jit(jax_build_train_step(jax_model, tx_j, schedule_j))
    model = Kolors(config_namespace(values))
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


# ---- weight import and adapter files ---------------------------------------------------------------


def test_unet_import_matches_jax_bitwise(tmp_path):
    """A seeded tiny Kolors diffusers UNet (two shards in ``unet/``) through
    ``load_transformer_params``, which dispatches the family to the UNet
    importer in both packages: the port's tree is bitwise the JAX
    ``load_unet_params`` tree, and the imported module bitwise the bridged
    JAX tree."""
    jmodel, model = _pair(_tiny_values())
    weights = _seeded(unet_checkpoint_shapes(model.arch), seed=4, dtype="f32")
    assert weights["add_embedding.linear_1.weight"].shape == (model.arch.block_out_channels[0] * 4, 6 * 8 + 32)
    root = tmp_path / "kolors" / "unet"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: weights[k] for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_unet_params(jmodel, str(tmp_path / "kolors"))
    _assert_trees_bitwise(load_unet_params(model, str(tmp_path / "kolors")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "kolors"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_key_map_and_adapter_file_match_jax(tmp_path):
    """``_key_map_for`` gives ``unet_key_map`` as the JAX ``_KEY_MAPS["kolors"]``
    does; an adapter file written by the port (``unet.`` keys) loads back
    bitwise and into the JAX template."""
    from simpletuner_tpu.training.lora import flatten_lora
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    assert _key_map_for(model) == JAX_KEY_MAPS["kolors"](jmodel) == unet_key_map(model.arch)
    source = _seeded_adapters(model, 4, scale=0.05)
    path = str(tmp_path / "adapter.safetensors")
    save_lora_safetensors(model, source, path)
    target = model.create_module()
    assert load_lora_safetensors(model, path, target) == []
    for (name, a), b in zip(tl.lora_parameters(target).items(), tl.lora_parameters(source).values()):
        assert torch.equal(a, b), name
    loaded = jax_load_lora(jmodel, path, lora_to_flax(_seeded_adapters(model, 9)))
    expected, got = flatten_lora(lora_to_flax(source)), flatten_lora(loaded)
    assert all(np.array_equal(got[p][leaf], a) for p, leaves in expected.items() for leaf, a in leaves.items())
