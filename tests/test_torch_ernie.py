"""The torch port's ERNIE-Image family against the JAX package, on the CPU.

The presets (the published one's parameter count against the JAX
``eval_shape``), the pairwise-duplicated angles applied rotate-half, a block
with its key mask, the DiT with its LoRA gradients against ``jax.grad``
(masked by the text lengths, unmasked, remat) and in bf16; the family
contract (the (ph, pw, c) pack, sigma x 1000, the text lengths from the mask,
``encode_text``'s final-norm states, the collate); the 32-channel wall in
both packages; the import of the JAX exporter's file with its unpermuted
``x_embedder``, the key map and adapter files; a test per kept quirk.  The
trainer's trajectory is in test_torch_omnigen_ernie_ideogram_trainer.py.
Every tolerance is stated where it is checked.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.ernie import transformer as jet
from simpletuner_tpu.models.ernie.model import Ernie as JaxErnie
from simpletuner_tpu.models.vae import VAEConfig as JaxVAEConfig
from simpletuner_tpu.models.weight_export import export_ernie_to_checkpoint
from simpletuner_tpu.models.weight_import import load_ernie_params as jax_load_params
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import ernie_checkpoint_shapes
from simpletuner_tpu_torch.models.ernie import Ernie, ErnieConfig, ErnieTransformer
from simpletuner_tpu_torch.models.ernie.transformer import ErnieBlock, apply_ernie_rope, ernie_rope_angles
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.vae import VAEConfig
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import (
    _flux_pack_permutation, load_ernie_params, load_transformer_params,
)
from simpletuner_tpu_torch.ops import key_mask_segments
from simpletuner_tpu_torch.training.lora import _key_map_for, ernie_key_map

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# f32 LoRA gradients (test_torch_sdxl.py: f32 gradients through a deep net
# are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
# bf16 on both sides: each rounds its own intermediates
BF16_REL = 2e-2
# torch's and XLA's f32 cos and sin differ by at most a few ulps of 1.0
ROPE_ATOL = 2.0 ** -21


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
    return {"model_family": "ernie", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxErnie(JaxTrainingConfig(values)), Ernie(config_namespace(values))


def _inputs(cfg, lens=(6, 3), seed=0, height=4, width=6, txt_len=6):
    rng = np.random.default_rng(seed)
    return {
        "latents": rng.standard_normal((2, height, width, cfg.in_channels), dtype=np.float32),
        "timesteps": np.asarray([130.0, 910.0], np.float32),
        "text_embeds": rng.standard_normal((2, txt_len, cfg.text_in_dim), dtype=np.float32),
        "text_lens": np.asarray(lens, np.int32),
    }


def _variables(jmodule, cfg, seed):
    """Seeded weights for every leaf (the zero-init AdaLN and final linear drawn)."""
    example = {k: jnp.asarray(v) for k, v in _inputs(cfg).items()}
    return numpy_variables(jmodule, **example, seed=seed)


def test_presets_and_contract_match_jax():
    """The presets (tiny and published: 3072 wide, 24 layers of 113.2M, the
    6 x 3072^2 shared AdaLN and the 2560 -> 3072 ``text_proj``; 2.82B
    parameters in the checkpoint layout, as the JAX ``eval_shape``), the
    family's constants, its ``qwen2.5`` spec at 512 tokens and example batch
    as the JAX family's; a non-flow prediction type is refused."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "LATENT_CHANNEL_COUNT", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    for ours, theirs in ((ErnieConfig.tiny(), jet.ErnieConfig.tiny()), (ErnieConfig(), jet.ErnieConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs) and ours.head_dim == theirs.head_dim
    full = Ernie(config_namespace({**_tiny_values(), "model_arch_preset": None})).arch
    shapes = ernie_checkpoint_shapes(full)
    per_layer = sum(math.prod(s) for k, s in shapes.items() if k.startswith("layers.0."))
    assert per_layer == 113_252_608 and shapes["text_proj.weight"] == (3072, 2560)
    example = {k: (v.shape, v.dtype) for k, v in _inputs(full).items()}
    tree = jax.eval_shape(lambda: jet.ErnieTransformer(config=jet.ErnieConfig()).init(
        jax.random.PRNGKey(0), **{k: jnp.zeros(*spec) for k, spec in example.items()}))
    total = sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree))
    assert sum(math.prod(s) for s in shapes.values()) == total
    assert "ernie" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), Ernie)
    with pytest.raises(ValueError, match="flow-matching"):
        Ernie(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 64).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 64).items()}
    assert model.latent_channels == jmodel.latent_channels == 4


def test_rope_angles_and_rotation_match_jax():
    """``ernie_rope_angles`` (duplicated pairwise) bitwise the JAX angles at
    the published axes (32, 48, 48) over image ids (text_len, y, x) and text
    ids (i, 0, 0); the rotate-half rotation over them within ``ROPE_ATOL``
    times the input scale of the JAX one; rotating by pairs instead gives
    another result."""
    rng = np.random.default_rng(1)
    ids = np.concatenate([np.stack([np.full(12, 7), np.repeat(np.arange(3), 4), np.tile(np.arange(4), 3)], -1),
                          np.stack([np.arange(7), np.zeros(7), np.zeros(7)], -1)])[None].astype(np.float32)
    ids = np.concatenate([ids, ids + 1], 0)
    ours = ernie_rope_angles(t(ids), (32, 48, 48), 256.0)
    theirs = np.asarray(jet.ernie_rope_angles(jnp.asarray(ids), (32, 48, 48), 256.0))
    assert np.array_equal(ours.numpy(), theirs) and np.array_equal(theirs[..., 0::2], theirs[..., 1::2])
    x = rng.standard_normal((2, 19, 3, 128)).astype(np.float32)
    rotated = apply_ernie_rope(t(x), ours).numpy()
    ref = np.asarray(jet._apply_ernie_rope(jnp.asarray(x), jnp.asarray(theirs)))
    assert np.abs(rotated - ref).max() <= ROPE_ATOL * np.abs(x).max() * 2
    pairs = x.reshape(*x.shape[:-1], 64, 2)
    c, s = np.cos(theirs[..., 0::2])[:, :, None], np.sin(theirs[..., 0::2])[:, :, None]
    interleaved = np.stack([pairs[..., 0] * c - pairs[..., 1] * s, pairs[..., 1] * c + pairs[..., 0] * s], -1)
    assert rel(interleaved.reshape(x.shape), ref) > 1e-2


def test_block_matches_jax():
    """A block (modulation, masked keys: 10 and 7 of 10 valid, rank-4
    adapters, f32): within ``F32_REL`` of the JAX block."""
    cfg = ErnieConfig.tiny()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, cfg.hidden_size)).astype(np.float32)
    ids = rng.integers(0, 5, (2, 10, 3)).astype(np.float32)
    angles = np.asarray(jet.ernie_rope_angles(jnp.asarray(ids), cfg.rope_axes_dim, cfg.rope_theta))
    temb6 = [rng.standard_normal((2, 1, cfg.hidden_size)).astype(np.float32) * 0.3 for _ in range(6)]
    mask = np.arange(10)[None] < np.asarray([10, 7])[:, None]
    jblock = jet.ErnieBlock(jet.ErnieConfig.tiny(), dtype=jnp.float32, lora_rank=4)
    args = (jnp.asarray(x), jnp.asarray(angles), [jnp.asarray(m) for m in temb6], jnp.asarray(mask))
    variables = numpy_variables(jblock, *args, seed=3)
    ref = np.asarray(jblock.apply(jax.tree_util.tree_map(jnp.asarray, variables), *args))
    port = bridge(variables, ErnieBlock(cfg, torch.float32, lora_rank=4))
    with torch.no_grad():
        out = port(t(x), t(angles), [t(m) for m in temb6], key_mask_segments(t(mask))).numpy()
    assert rel(out, ref) < F32_REL


@pytest.mark.parametrize("variant", ["masked", "unmasked", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny DiT (f32, rank-4 adapters): text lengths 6 and 3 of 6,
    all 6 valid, and masked under remat: the output within ``F32_REL``, the
    LoRA gradients of a seeded projection of it against ``jax.grad`` within
    ``GRAD_REL``, per adapter."""
    cfg = ErnieConfig.tiny()
    remat = variant == "remat"
    inputs = _inputs(cfg, (6, 6) if variant == "unmasked" else (6, 3), seed=4)
    jmodule = jet.ErnieTransformer(config=jet.ErnieConfig.tiny(), dtype=jnp.float32, lora_rank=4, remat=remat)
    variables = _variables(jmodule, cfg, seed=5)
    port = bridge(variables, ErnieTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    weight = np.random.default_rng(6).standard_normal((2, 4, 6, cfg.out_channels)).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jargs = {k: jnp.asarray(v) for k, v in inputs.items()}

    def jax_loss(lora):
        out = jmodule.apply({"params": params, "lora": lora}, **jargs)
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(port)
    out = port(**{k: t(v) for k, v in inputs.items()})
    assert tuple(out.shape) == ref.shape and rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and "layer_1/linear_fc2/lora_B" in flat and "x_embedder/lora_A" in flat
    for path, param in adapters.items():
        assert rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_transformer_bf16_matches_jax():
    """The tiny DiT in bf16 (f32 adapters, norms, time MLP and AdaLN), text
    lengths 6 and 2, against the JAX module in bf16: within ``BF16_REL``."""
    cfg = ErnieConfig.tiny()
    inputs = _inputs(cfg, (6, 2), seed=7)
    jmodule = jet.ErnieTransformer(config=jet.ErnieConfig.tiny(), dtype=jnp.bfloat16, lora_rank=4)
    variables = _variables(jmodule, cfg, seed=8)
    port = bridge(variables, ErnieTransformer(cfg, dtype=torch.bfloat16, lora_rank=4))
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                            **{k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}).numpy()
    assert out.dtype == ref.dtype == np.float32 and rel(out, ref) < BF16_REL


class _Encoder:
    """A decoder LLM's ``encode`` output, fixed."""

    def __init__(self, states, mask):
        self.states, self.mask = states, mask

    def encode(self, prompts):
        n = len(prompts)
        return {"last_hidden_state": self.states[:n], "attention_mask": self.mask[:n], "pooled": self.states[:n, 0]}


@pytest.mark.parametrize("masked", [True, False])
def test_family_inputs_prediction_and_text_match_jax(masked):
    """``get_model_inputs`` (the (ph, pw, c) pack, sigma x 1000, the text
    lengths from the mask or the full length) equal to the JAX family's;
    the unpacked prediction within ``F32_REL`` of the JAX ``model_predict``;
    ``encode_text`` (the final-norm states and the mask) and the collate
    (the mask as ``text_attention_mask``) equal to the JAX family's."""
    jmodel, model = _pair(_tiny_values())
    cfg = model.arch
    rng = np.random.default_rng(9)
    prepared = {"noisy_latents": rng.standard_normal((2, 8, 12, 4)).astype(np.float32),
                "timesteps": np.asarray([0.2, 0.7], np.float32),
                "text_embeds": rng.standard_normal((2, 6, cfg.text_in_dim)).astype(np.float32)}
    if masked:
        prepared["text_attention_mask"] = (np.arange(6)[None] < np.asarray([6, 4])[:, None]).astype(np.int32)
    ours = model.get_model_inputs({k: t(v) for k, v in prepared.items()})
    theirs = jmodel.get_model_inputs({k: jnp.asarray(v) for k, v in prepared.items()})
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    jmodule = jmodel.create_module()
    variables = _variables(jmodule, cfg, seed=10)
    module = bridge(variables, model.create_module())
    with torch.no_grad():
        out = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
    ref = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                   jax.tree_util.tree_map(jnp.asarray, prepared)))
    assert out.shape == ref.shape == (2, 8, 12, 4) and rel(out, ref) < F32_REL
    states = rng.standard_normal((3, 7, cfg.text_in_dim)).astype(np.float32)
    mask = (np.arange(7)[None] < np.asarray([7, 2, 4])[:, None]).astype(np.int32)
    for m in (jmodel, model):
        m.attach_text_encoders([_Encoder(states, mask)])
    mine, jax_payloads = model.encode_text(["a", "b", "c"]), jmodel.encode_text(["a", "b", "c"])
    for a, b in zip(mine, jax_payloads):
        assert sorted(a) == sorted(b) == ["attention_mask", "text_embeds"]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    collated, jcollated = model.collate_text_embeds(mine), jmodel.collate_text_embeds(jax_payloads)
    assert sorted(collated) == sorted(jcollated) == ["text_attention_mask", "text_embeds"]
    for key in collated:
        np.testing.assert_array_equal(collated[key], jcollated[key])


def test_thirty_two_channel_wall_in_both_packages():
    """Quirk kept (ROADMAP Queue 3): ``LATENT_CHANNEL_COUNT`` is 32, and both
    trainers build ``VAEConfig.flux()`` (16 latent channels) for every family
    of 16 or more, so the published ``x_embedder`` (128 features: 32 channels
    packed 2 x 2) meets 64 packed features and both modules refuse them; the
    tiny preset's 16 packed channels are the tiny VAE's 4."""
    assert Ernie.LATENT_CHANNEL_COUNT == JaxErnie.LATENT_CHANNEL_COUNT == 32
    assert VAEConfig.flux().latent_channels == JaxVAEConfig.flux().latent_channels == 16
    wide = dataclasses.replace(ErnieConfig.tiny(), in_channels=128, out_channels=128)
    jwide = dataclasses.replace(jet.ErnieConfig.tiny(), in_channels=128, out_channels=128)
    values = _tiny_values()
    jmodel, model = JaxErnie(JaxTrainingConfig(values), arch=jwide), Ernie(config_namespace(values), arch=wide)
    rng = np.random.default_rng(11)
    prepared = {"noisy_latents": rng.standard_normal((1, 8, 8, 16)).astype(np.float32),
                "timesteps": np.asarray([0.5], np.float32),
                "text_embeds": rng.standard_normal((1, 4, wide.text_in_dim)).astype(np.float32)}
    jmodule = jmodel.create_module()
    example = {"latents": jnp.zeros((1, 4, 4, 128)), "timesteps": jnp.zeros((1,)),
               "text_embeds": jnp.zeros((1, 4, wide.text_in_dim)), "text_lens": jnp.zeros((1,), jnp.int32)}
    variables = numpy_variables(jmodule, **example, seed=12)
    with pytest.raises(Exception):
        jmodel.model_predict(jax.tree_util.tree_map(jnp.asarray, variables),
                             jax.tree_util.tree_map(jnp.asarray, prepared))
    module = bridge(variables, model.create_module())
    with pytest.raises(RuntimeError):
        model.model_predict(module, {k: t(v) for k, v in prepared.items()})
    assert model.latent_channels == jmodel.latent_channels == 32


def test_render_payload_is_unmasked_in_both_packages():
    """Quirk kept (ROADMAP Queue 3): the render batch takes ``encode_text``'s
    payload keys as they are, so the mask rides as ``attention_mask``, which
    ``inference_conditioning`` does not read in either package: a render
    takes every text token as valid (``text_lens`` the full length)."""
    jmodel, model = _pair(_tiny_values())
    payload = {"text_embeds": np.zeros((1, 6, 32), np.float32),
               "attention_mask": (np.arange(6) < 3).astype(np.int32)[None]}
    assert sorted(model.inference_conditioning({k: t(v) for k, v in payload.items()})) == \
        sorted(jmodel.inference_conditioning(payload)) == ["text_embeds"]


def _jax_params(jmodel, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(jmodel.arch).items()}
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0), **example))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise_and_keeps_x_embedder_unpermuted(tmp_path):
    """The JAX exporter's file of a seeded tiny transformer with a
    ``text_proj`` (text width 48, two shards): its names and shapes are the
    port's layout, the port's tree bitwise the JAX ``load_ernie_params``
    tree, the imported module bitwise the bridged JAX tree.  Quirk kept
    (ROADMAP Queue 3): the k = 1 ``x_embedder`` conv is read in the file's
    feature order, not permuted from a (c, ph, pw) packing to the port's
    (ph, pw, c), as Chroma's is read."""
    values = _tiny_values()
    arch, jarch = (dataclasses.replace(c, text_in_dim=48) for c in (ErnieConfig.tiny(), jet.ErnieConfig.tiny()))
    jmodel, model = JaxErnie(JaxTrainingConfig(values), arch=jarch), Ernie(config_namespace(values), arch=arch)
    weights = export_ernie_to_checkpoint(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == ernie_checkpoint_shapes(model.arch)
    root = tmp_path / "ernie" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_params(jmodel, str(tmp_path / "ernie"))
    _assert_trees_bitwise(load_ernie_params(model, str(tmp_path / "ernie")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "ernie"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name
    conv = torch.from_numpy(weights["x_embedder.proj.weight"][:, :, 0, 0])
    perm = _flux_pack_permutation(model.arch.in_channels)
    assert torch.equal(ours.x_embedder.weight, conv) and not torch.equal(ours.x_embedder.weight, conv[:, perm])


def test_seeded_init_key_map_and_adapter_file_match_jax(tmp_path):
    """Quirk kept: ``init_parameters`` zeroes ``adaLN_modulation`` and
    ``final_linear`` as the Flax initialisers do, so from a seeded base with
    fresh adapters every AdaLN gate is 0 and only ``final_linear``'s B
    gradient can be nonzero (the chip phase draws them); ``ernie_key_map``
    equals the JAX map; an adapter file written by the port round-trips
    bitwise and loads into the JAX template bitwise."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    module = tl.init_parameters(model.create_module(), torch.Generator().manual_seed(0))
    assert not module.adaLN_modulation.weight.any() and not module.final_linear.weight.any()
    assert module.time_in.weight.abs().sum() > 0
    assert _key_map_for(model) == JAX_KEY_MAPS["ernie"](jmodel) == ernie_key_map(model.arch)
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
