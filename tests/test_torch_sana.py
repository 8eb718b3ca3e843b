"""The torch port's Sana family against the JAX package, on the CPU.

The presets (the published 1600M's parameters against the JAX
``eval_shape``), ``relu_linear_attention`` from bf16 and f32 inputs, the
GLUMBConv Mix-FFN, the unmasked cross-attention at head dim 112 through
``dot_product_attention`` against the JAX op, the DiT with its LoRA gradients
against ``jax.grad`` (and under remat) and in bf16; the family contract (raw
sigmas, ``CHI_TEMPLATE``, the collate that keeps only ``text_embeds``); the
32-channel wall, the flavours and the VAE factors as the JAX family keeps
them; the import of the JAX exporter's file bitwise, the key map and adapter
files.  Each JAX reference is computed once (the ``jax_dit`` fixture).  The
trainer's trajectory is in test_torch_longcat_sana_trainer.py.  Every
tolerance is stated where it is checked.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu import ops as jops
from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.sana import transformer as jst
from simpletuner_tpu.models.sana.model import Sana as JaxSana
from simpletuner_tpu.models.vae import VAEConfig as JaxVAEConfig
from simpletuner_tpu.models.weight_export import export_sana_to_diffusers
from simpletuner_tpu.models.weight_import import load_sana_params as jax_load_params
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import sana_checkpoint_shapes
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.sana import Sana, SanaConfig, SanaTransformer, relu_linear_attention
from simpletuner_tpu_torch.models.sana.transformer import GLUMBConv
from simpletuner_tpu_torch.models.vae import VAEConfig
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_sana_params, load_transformer_params
from simpletuner_tpu_torch.ops import dot_product_attention
from simpletuner_tpu_torch.training.lora import _key_map_for, sana_key_map

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# f32 LoRA gradients (test_torch_sdxl.py: f32 gradients through a deep net
# are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
# bf16 on both sides: each rounds its own intermediates
BF16_REL = 2e-2
SIGMAS = np.asarray([0.13, 0.91], np.float32)


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
    return {"model_family": "sana", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxSana(JaxTrainingConfig(values)), Sana(config_namespace(values))


def _inputs(cfg, seed=0):
    """Two 4 x 6 latents (24 tokens), raw sigmas, 7 Gemma tokens."""
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((2, 4, 6, cfg.in_channels), dtype=np.float32), "timesteps": SIGMAS,
            "context": rng.standard_normal((2, 7, cfg.text_dim), dtype=np.float32)}


def _variables(jmodule, cfg, seed):
    return numpy_variables(jmodule, **{k: jnp.asarray(v) for k, v in _inputs(cfg).items()}, seed=seed)


@pytest.fixture(scope="module")
def jax_dit():
    """The tiny JAX DiT's output and LoRA gradients of a seeded projection
    (f32, rank-4 adapters), computed once (a module fixture is set up before
    ``_restore_jax_globals`` runs, so it clears the LoRA target itself)."""
    previous = jl._LORA_TARGET
    jl.set_lora_target(None)
    cfg = SanaConfig.tiny()
    inputs = _inputs(cfg, seed=4)
    jmodule = jst.SanaTransformer(config=jst.SanaConfig.tiny(), dtype=jnp.float32, lora_rank=4)
    variables = _variables(jmodule, cfg, seed=5)
    weight = np.random.default_rng(6).standard_normal((2, 4, 6, cfg.in_channels)).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jargs = {k: jnp.asarray(v) for k, v in inputs.items()}

    def jax_loss(lora):
        out = jmodule.apply({"params": params, "lora": lora}, **jargs)
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    jl.set_lora_target(previous)
    return inputs, variables, weight, np.asarray(ref), flat


def test_presets_flavours_and_contract_match_jax():
    """The presets (tiny and published: 2240 wide, 70 x 32 linear heads, 20
    x 112 cross heads, Mix-FFN 5600; 77.9M a block and 1.60B in the
    checkpoint layout, the JAX ``eval_shape`` at 2 blocks giving the same
    count); quirk kept: ``600m-1024`` builds the same ``SanaConfig()`` as
    ``1600m-1024``; the family's constants, its ``gemma`` spec at 300
    tokens and example batch as the JAX family's."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "LATENT_CHANNEL_COUNT", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR",
                 "CHI_TEMPLATE"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    for ours, theirs in ((SanaConfig.tiny(), jst.SanaConfig.tiny()), (SanaConfig(), jst.SanaConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert (ours.num_heads, ours.head_dim) == (theirs.num_heads, theirs.head_dim)
    for flavour in ("1600m-1024", "600m-1024"):
        values = {"model_family": "sana", "model_flavour": flavour}
        assert Sana(config_namespace(values)).arch == SanaConfig()
        assert dataclasses.asdict(JaxSana(JaxTrainingConfig(values)).arch) == dataclasses.asdict(SanaConfig())
    full = SanaConfig()
    shapes = sana_checkpoint_shapes(full)
    per_block = sum(math.prod(s) for k, s in shapes.items() if k.startswith("transformer_blocks.0."))
    assert per_block == 77_927_360 and sum(math.prod(s) for s in shapes.values()) == 1_604_597_152
    two = dataclasses.replace(jst.SanaConfig(), depth=2)
    example = {"latents": jnp.zeros((1, 2, 2, 32)), "timesteps": jnp.zeros((1,)), "context": jnp.zeros((1, 3, 2304))}
    tree = jax.eval_shape(lambda: jst.SanaTransformer(config=two).init(jax.random.PRNGKey(0), **example))
    assert sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree)) == \
        sum(math.prod(s) for s in sana_checkpoint_shapes(dataclasses.replace(full, depth=2)).values())
    assert "sana" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), Sana)
    with pytest.raises(ValueError, match="flow-matching"):
        Sana(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 64).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 64).items()}
    assert model.latent_channels == jmodel.latent_channels == 4


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_relu_linear_attention_matches_jax(dtype):
    """``relu_linear_attention`` (f32 products, eps 1e-15) from bf16 and f32
    (B, S, H, D) inputs against the JAX function: within ``F32_REL``."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 24, 4, 16)).astype(np.float32) for _ in range(3))
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jst.relu_linear_attention(*(jnp.asarray(x).astype(jdtype) for x in (q, k, v))))
    out = relu_linear_attention(*(t(x).to(tdtype) for x in (q, k, v)))
    assert out.dtype == torch.float32 and ref.dtype == np.float32 and rel(out.numpy(), ref) < F32_REL


def test_glumbconv_matches_jax():
    """The Mix-FFN (1 x 1 expand to 2 x 2.5 dim, silu, depthwise 3 x 3
    "SAME", GLU with the value first, bias-free 1 x 1) on a 5 x 7 grid, f32:
    within ``F32_REL`` of the JAX module."""
    x = np.random.default_rng(2).standard_normal((2, 5, 7, 16)).astype(np.float32)
    jmodule = jst.GLUMBConv(16, 2.5, dtype=jnp.float32)
    variables = numpy_variables(jmodule, jnp.asarray(x), seed=3)
    ref = np.asarray(jmodule.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x)))
    port = bridge(variables, GLUMBConv(16, 2.5, torch.float32))
    with torch.no_grad():
        assert rel(port(t(x)).numpy(), ref) < F32_REL


@pytest.mark.parametrize("keys", [300, 7])
def test_cross_attention_at_head_dim_112_matches_the_jax_op(keys):
    """The unmasked cross-attention at Sana's head dim 112 (scale
    112^-1/2): 24 queries against 300 (the published caption length) and 7
    keys, 20 and 2 heads, through ``dot_product_attention`` against the JAX
    ``ops.dot_product_attention``: within ``F32_REL``."""
    heads = 20 if keys == 300 else 2
    rng = np.random.default_rng(keys)
    q = rng.standard_normal((1, 24, heads, 112)).astype(np.float32)
    k, v = (rng.standard_normal((1, keys, heads, 112)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jops.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert rel(dot_product_attention(t(q), t(k), t(v)).numpy(), ref) < F32_REL


@pytest.mark.parametrize("remat", [False, True])
def test_transformer_forward_and_lora_grads_match_jax(jax_dit, remat):
    """The tiny DiT (f32, rank-4 adapters; the port also under remat): the
    output within ``F32_REL`` of the JAX module's, the LoRA gradients of a
    seeded projection against ``jax.grad`` within ``GRAD_REL``, per adapter
    (the caption MLP's too; none on the time MLP or ``final_proj``)."""
    inputs, variables, weight, ref, flat = jax_dit
    port = bridge(variables, SanaTransformer(SanaConfig.tiny(), dtype=torch.float32, lora_rank=4, remat=remat))
    adapters = tl.freeze_base(port)
    out = port(**{k: t(v) for k, v in inputs.items()})
    assert tuple(out.shape) == ref.shape and rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    assert sorted(flat) == sorted(adapters) and "caption_in_1/lora_A" in flat and "block_1/attn2_proj/lora_B" in flat
    assert not any(name.startswith(("time_", "final_proj")) for name in flat)
    for path, param in adapters.items():
        assert rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_transformer_bf16_matches_jax():
    """The tiny DiT in bf16 (f32 adapters and tables) against the JAX module
    in bf16: within ``BF16_REL``."""
    cfg = SanaConfig.tiny()
    inputs = _inputs(cfg, seed=7)
    jmodule = jst.SanaTransformer(config=jst.SanaConfig.tiny(), dtype=jnp.bfloat16, lora_rank=4)
    variables = _variables(jmodule, cfg, seed=8)
    port = bridge(variables, SanaTransformer(cfg, dtype=torch.bfloat16, lora_rank=4))
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                            **{k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}).numpy()
    assert out.dtype == ref.dtype == np.float32 and rel(out, ref) < BF16_REL


class _Encoder:
    """A Gemma encoder's ``encode`` output, fixed; records the prompts."""

    def __init__(self, states, mask):
        self.states, self.mask, self.prompts = states, mask, []

    def encode(self, prompts):
        self.prompts.append(list(prompts))
        n = len(prompts)
        return {"last_hidden_state": self.states[:n], "attention_mask": self.mask[:n]}


@pytest.mark.parametrize("chi", [False, True])
def test_family_inputs_prediction_and_text_match_jax(jax_dit, chi):
    """``get_model_inputs`` (raw sigmas) equal to the JAX family's and
    ``model_predict`` within ``F32_REL`` of the JAX module (the ``jax_dit``
    output); ``encode_text`` (with and without
    ``sana_complex_human_instruction``: the prompts each package hands its
    encoder, then the states and the mask) equal to the JAX family's; quirk
    kept (ROADMAP Queue 3): the collate keeps only ``text_embeds`` in both
    packages, so the DiT attends Gemma's pad keys."""
    values = _tiny_values(sana_complex_human_instruction=chi)
    jmodel, model = _pair(values)
    inputs, variables, _, ref, _ = jax_dit
    prepared = {"noisy_latents": inputs["latents"], "timesteps": SIGMAS, "text_embeds": inputs["context"]}
    ours = model.get_model_inputs({k: t(v) for k, v in prepared.items()})
    theirs = jmodel.get_model_inputs({k: jnp.asarray(v) for k, v in prepared.items()})
    assert sorted(ours) == sorted(theirs) == ["context", "latents", "timesteps"]
    for key in ours:
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    module = bridge(variables, model.create_module())
    with torch.no_grad():
        out = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
    assert out.shape == ref.shape and rel(out, ref) < F32_REL
    rng = np.random.default_rng(9)
    states = rng.standard_normal((2, 7, 32)).astype(np.float32)
    mask = (np.arange(7)[None] < np.asarray([7, 3])[:, None]).astype(np.int32)
    encoders = [_Encoder(states, mask), _Encoder(states, mask)]
    for m, encoder in zip((jmodel, model), encoders):
        m.attach_text_encoders([encoder])
    mine, jax_payloads = model.encode_text(["a cat", "a dog"]), jmodel.encode_text(["a cat", "a dog"])
    assert encoders[0].prompts == encoders[1].prompts
    assert (encoders[1].prompts[0][0] == Sana.CHI_TEMPLATE.format(prompt="a cat")) == chi
    for a, b in zip(mine, jax_payloads):
        assert sorted(a) == sorted(b) == ["attention_mask", "text_embeds"]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    collated, jcollated = model.collate_text_embeds(mine), jmodel.collate_text_embeds(jax_payloads)
    assert sorted(collated) == sorted(jcollated) == ["text_embeds"]
    np.testing.assert_array_equal(collated["text_embeds"], jcollated["text_embeds"])
    assert sorted(model.inference_conditioning({"text_embeds": t(states), "text_attention_mask": t(mask)})) == \
        sorted(jmodel.inference_conditioning({"text_embeds": states, "text_attention_mask": mask})) == ["text_embeds"]


def test_thirty_two_channel_wall_and_vae_factors_in_both_packages():
    """Quirks kept (ROADMAP Queue 3): ``LATENT_CHANNEL_COUNT`` is 32 and both
    trainers build ``VAEConfig.flux()`` (16 latent channels) for every
    family of 16 or more, so the published ``patch_in`` (32 features) meets
    16-channel latents and both modules refuse them; the tiny preset caches
    with the tiny SD VAE's factor 0.18215 while ``VAE_SCALING_FACTOR`` is
    DC-AE's 0.41407, which both packages' validation divides by before the
    VAE's own decode divides by 0.18215."""
    assert Sana.LATENT_CHANNEL_COUNT == JaxSana.LATENT_CHANNEL_COUNT == 32
    assert VAEConfig.flux().latent_channels == JaxVAEConfig.flux().latent_channels == 16
    assert VAEConfig.tiny().scaling_factor == JaxVAEConfig.tiny().scaling_factor == 0.18215
    assert Sana.VAE_SCALING_FACTOR == JaxSana.VAE_SCALING_FACTOR == 0.41407
    wide = dataclasses.replace(SanaConfig.tiny(), in_channels=32)
    jwide = dataclasses.replace(jst.SanaConfig.tiny(), in_channels=32)
    values = _tiny_values()
    jmodel, model = JaxSana(JaxTrainingConfig(values), arch=jwide), Sana(config_namespace(values), arch=wide)
    rng = np.random.default_rng(11)
    prepared = {"noisy_latents": rng.standard_normal((1, 4, 4, 16)).astype(np.float32),
                "timesteps": np.asarray([0.5], np.float32),
                "text_embeds": rng.standard_normal((1, 4, wide.text_dim)).astype(np.float32)}
    jmodule = jmodel.create_module()
    example = {"latents": jnp.zeros((1, 4, 4, 32)), "timesteps": jnp.zeros((1,)), "context": jnp.zeros((1, 4, 32))}
    variables = numpy_variables(jmodule, **example, seed=12)
    with pytest.raises(Exception):
        jmodel.model_predict(jax.tree_util.tree_map(jnp.asarray, variables),
                             jax.tree_util.tree_map(jnp.asarray, prepared))
    module = bridge(variables, model.create_module())
    with pytest.raises(RuntimeError):
        model.model_predict(module, {k: t(v) for k, v in prepared.items()})


def _jax_params(jmodel, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(jmodel.arch).items()}
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0), **example))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's file of a seeded tiny transformer (two shards): its
    names and shapes are the port's layout, the port's tree bitwise the JAX
    ``load_sana_params`` tree (the patch conv as a (p, p, C) dense kernel,
    the tables reshaped, the Mix-FFN convs), the imported module bitwise the
    bridged JAX tree."""
    jmodel, model = _pair(_tiny_values())
    weights = export_sana_to_diffusers(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == sana_checkpoint_shapes(model.arch)
    root = tmp_path / "sana" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_params(jmodel, str(tmp_path / "sana"))
    _assert_trees_bitwise(load_sana_params(model, str(tmp_path / "sana")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "sana"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_key_map_and_adapter_file_match_jax(tmp_path):
    """``sana_key_map`` equals the JAX map; an adapter file written by the
    port round-trips bitwise and loads into the JAX template bitwise."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    assert _key_map_for(model) == JAX_KEY_MAPS["sana"](jmodel) == sana_key_map(model.arch)
    source = _seeded_adapters(model, 4, scale=0.05)
    path = str(tmp_path / "adapter.safetensors")
    save_lora_safetensors(model, source, path)
    target = model.create_module()
    assert load_lora_safetensors(model, path, target) == []
    for (name, a), b in zip(tl.lora_parameters(target).items(), tl.lora_parameters(source).values()):
        assert torch.equal(a, b), name
    template = _variables(jmodel.create_module(), model.arch, seed=1)["lora"]
    loaded = jax_load_lora(jmodel, path, template)
    loaded = loaded[0] if isinstance(loaded, tuple) else loaded
    for name, param in tl.lora_parameters(source).items():
        node = loaded
        for part in name.split("/"):
            node = node[part]
        assert np.array_equal(np.asarray(node), param.detach().numpy().T), name
