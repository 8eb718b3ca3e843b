"""The torch port's Qwen-Image, Z-Image and MageFlow families against the JAX package, on the CPU.

The rope tables, the interleaved rotation, the double-stream block (with
and without text rope), the DiT with its LoRA gradients (square and
non-square grids, remat, MageFlow's ``txt_rope=False``), the family
contract of all three names, ``encode_text`` / collate, the import of the
JAX exporter's output through every name, the key map and the quirks kept
from the JAX families: the same seeded numpy weights and inputs go through
both packages.  The trainers' trajectories are in
test_torch_qwen_image_trainer.py.  Every tolerance is stated where it is
checked.  At the tiny size the head dim is 32; the published D = 128
shapes are held to the plain version on the card (test_torch_kernels_cuda.py).
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
from simpletuner_tpu.models.mageflow.model import MageFlow as JaxMageFlow
from simpletuner_tpu.models.mageflow.model import ZImage as JaxZImage
from simpletuner_tpu.models.qwen_image import transformer as jax_qi
from simpletuner_tpu.models.qwen_image.model import QwenImage as JaxQwenImage
from simpletuner_tpu.models.registry import ModelRegistry as JaxModelRegistry
from simpletuner_tpu.models.weight_export import export_qwen_image_to_diffusers
from simpletuner_tpu.models.weight_import import load_qwen_image_params as jax_load_qwen_image_params
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import qwen_image_checkpoint_shapes
from simpletuner_tpu_torch.models.mageflow import MageFlow, ZImage
from simpletuner_tpu_torch.models.qwen_image import QwenImage, QwenImageConfig, QwenImageTransformer
from simpletuner_tpu_torch.models.qwen_image import transformer as qi
from simpletuner_tpu_torch.models.registry import PORTED, ModelRegistry, get_model_family
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_qwen_image_params, load_transformer_params
from simpletuner_tpu_torch.training.lora import _key_map_for, qwen_image_key_map

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# gradient-derived numbers (test_torch_sdxl.py: f32 gradients through a deep
# net are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
# bf16 on both sides: each rounds its own intermediates (the kernels' plain
# version against XLA's bf16 products)
BF16_REL = 2e-2

FAMILIES = {"qwen_image": (JaxQwenImage, QwenImage), "z_image": (JaxZImage, ZImage), "mageflow": (JaxMageFlow, MageFlow)}


@pytest.fixture(autouse=True)
def _restore_jax_globals():
    """Building a JAX model family installs a process-wide LoRA target
    predicate and int8 matmul mode."""
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jl.set_lora_target(None)
    yield
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])


def _tiny_values(family="qwen_image", **extra):
    return {"model_family": family, "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    jax_cls, port_cls = FAMILIES[values["model_family"]]
    return jax_cls(JaxTrainingConfig(values)), port_cls(config_namespace(values))


def _jax_config(cfg):
    return jax_qi.QwenImageConfig(**dataclasses.asdict(cfg))


def test_presets_match_jax():
    """The tiny and published presets and the three families' archs (the
    published ones through a config without the tiny preset) as the JAX
    ones; the published sizes' parameter counts from the checkpoint layout."""
    for ours, theirs in ((QwenImageConfig.tiny(), jax_qi.QwenImageConfig.tiny()),
                         (QwenImageConfig(), jax_qi.QwenImageConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    counts = {}
    for family in FAMILIES:
        for preset in ("tiny", None):
            jmodel, model = _pair(_tiny_values(family, model_arch_preset=preset))
            assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch), (family, preset)
            assert model.latent_channels == jmodel.latent_channels
        counts[family] = sum(int(np.prod(s)) for s in qwen_image_checkpoint_shapes(model.arch).values())
        assert model.arch.txt_rope == (family == "qwen_image")
    assert counts == {"qwen_image": 20_430_401_088, "z_image": 6_494_171_200, "mageflow": 4_115_745_408}
    assert (MageFlow.LATENT_CHANNEL_COUNT, ZImage.LATENT_CHANNEL_COUNT, QwenImage.LATENT_CHANNEL_COUNT) == (32, 16, 16)


@pytest.mark.parametrize("grid", [(4, 4), (3, 5), (64, 64), (1, 7)])
def test_rope_tables_match_jax_bitwise(grid):
    """The image and text angle tables (float64 on the host, rounded to f32:
    centred image coordinates, text from max(hh // 2, ww // 2)) bitwise the
    JAX tables at the tiny and the published axes; the rotation within
    ``F32_REL``."""
    for cfg in (QwenImageConfig.tiny(), QwenImageConfig()):
        ours = qi.qwen_rope_angles(cfg, *grid, 9)
        theirs = jax_qi.qwen_rope_angles(_jax_config(cfg), *grid, 9)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
        assert ours[0].shape == (grid[0] * grid[1], cfg.head_dim // 2) and ours[1].shape == (9, cfg.head_dim // 2)
    rng = np.random.default_rng(2)
    angles = rng.uniform(0, 6, (7, 16)).astype(np.float32)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    assert rel(qi.apply_interleaved_rope(t(x), t(angles)).numpy(),
               np.asarray(jax_qi.apply_interleaved_rope(jnp.asarray(x), jnp.asarray(angles)))) < F32_REL


@pytest.mark.parametrize("txt_rope", [True, False])
def test_block_matches_jax(txt_rope):
    """One double-stream block in f32 with rank-4 adapters (text rope on for
    Qwen-Image, off for MageFlow / Z-Image): both streams within ``F32_REL``."""
    cfg = dataclasses.replace(QwenImageConfig.tiny(), txt_rope=txt_rope)
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 12, cfg.hidden_size), dtype=np.float32)
    txt = rng.standard_normal((2, 5, cfg.hidden_size), dtype=np.float32)
    temb = rng.standard_normal((2, cfg.hidden_size), dtype=np.float32)
    rope_img, rope_txt = qi.qwen_rope_angles(cfg, 3, 4, 5)
    args = (img, txt, temb, rope_img, rope_txt)
    jblock = jax_qi.QwenImageBlock(_jax_config(cfg), dtype=jnp.float32, lora_rank=4)
    variables = numpy_variables(jblock, *map(jnp.asarray, args), seed=2)
    port = bridge(variables, qi.QwenImageBlock(cfg, dtype=torch.float32, lora_rank=4))
    ref = jblock.apply(jax.tree_util.tree_map(jnp.asarray, variables), *map(jnp.asarray, args))
    with torch.no_grad():
        out = port(*map(t, args))
    for a, b in zip(out, ref):
        assert tuple(a.shape) == b.shape and rel(a.numpy(), b) < F32_REL


def _inputs(cfg, hh, ww, text_len=7, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((2, hh * ww, cfg.in_channels), dtype=np.float32)
    txt = rng.standard_normal((2, text_len, cfg.txt_in_features), dtype=np.float32)
    timesteps = rng.uniform(0.05, 0.95, 2).astype(np.float32)
    return img, txt, timesteps


@pytest.mark.parametrize("variant", ["square", "non_square", "no_txt_rope", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny DiT (f32, rank-4 adapters) on the same seeded weights: the
    output within ``F32_REL`` on a 3 x 3 and a 2 x 5 grid, without text rope
    (MageFlow / Z-Image) and under remat; the LoRA gradients of a seeded
    projection of it against ``jax.grad`` within ``GRAD_REL``, per adapter
    (the last block's text-only adapters get zero on both sides)."""
    cfg = dataclasses.replace(QwenImageConfig.tiny(), txt_rope=variant != "no_txt_rope")
    hh, ww = (2, 5) if variant == "non_square" else (3, 3)
    remat = variant == "remat"
    img, txt, timesteps = _inputs(cfg, hh, ww)
    weight = np.random.default_rng(9).standard_normal(img.shape).astype(np.float32)
    jmodule = jax_qi.QwenImageTransformer(config=_jax_config(cfg), dtype=jnp.float32, lora_rank=4, remat=remat)
    jargs = [jnp.asarray(img), jnp.zeros((hh, ww)), jnp.asarray(txt), jnp.asarray(timesteps)]
    variables = numpy_variables(jmodule, *jargs, seed=1)
    port = bridge(variables, QwenImageTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

    def jax_loss(lora):
        out = jmodule.apply({"params": params, "lora": lora}, *jargs)
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(port)
    out = port(t(img), (hh, ww), t(txt), t(timesteps))
    assert tuple(out.shape) == ref.shape == weight.shape and out.dtype == torch.float32
    assert rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and {"img_in/lora_A", "txt_in/lora_B", "block_1/txt_mlp_out/lora_A"} \
        <= set(flat)
    assert not any("_mod" in path or path.startswith(("time_in", "final_")) for path in flat)
    for path, param in adapters.items():
        grad = torch.zeros_like(param) if param.grad is None else param.grad  # None: off autograd's graph
        assert _grad_close(grad.numpy().T, flat[path]), path
    # the last block's text queries, projection and MLP reach no output: zero on both sides
    assert not np.any(flat["block_1/txt_attn_q/lora_A"]) and not np.any(flat["block_1/txt_mlp_out/lora_B"])


def _grad_close(ours, theirs):
    """Within ``GRAD_REL``, or exactly zero on both sides (an adapter no output reads)."""
    if not np.any(theirs):
        return not np.any(ours)
    return rel(ours, theirs) < GRAD_REL


def test_transformer_bf16_matches_jax():
    """The tiny DiT in bf16 (the trainer's compute dtype; f32 adapters and
    norm scales) against the JAX module in bf16 on the same weights: within
    ``BF16_REL``, each side rounding its own intermediates."""
    cfg = QwenImageConfig.tiny()
    img, txt, timesteps = _inputs(cfg, 3, 3, seed=3)
    jmodule = jax_qi.QwenImageTransformer(config=_jax_config(cfg), dtype=jnp.bfloat16, lora_rank=4)
    jargs = [jnp.asarray(img), jnp.zeros((3, 3)), jnp.asarray(txt), jnp.asarray(timesteps)]
    variables = numpy_variables(jmodule, *jargs, seed=4)
    port = bridge(variables, QwenImageTransformer(cfg, dtype=torch.bfloat16, lora_rank=4))
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables), *jargs))
    with torch.no_grad():
        out = port(t(img), (3, 3), t(txt), t(timesteps)).numpy()
    assert out.dtype == ref.dtype == np.float32 and rel(out, ref) < BF16_REL


# ---- the family contract -----------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_contract_matches_jax(family):
    """Each family's constants, specs, arch and example batch as the JAX
    family's; ``model_predict`` (Flux's 2x2 packing) and ``denoise_fn``
    equal to the JAX ``model_predict`` within ``F32_REL``; the registry
    builds it; a non-flow prediction type is refused; the intermediates tap
    is refused by name."""
    jmodel, model = _pair(_tiny_values(family))
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "MODALITY", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR",
                 "HUGGINGFACE_PATHS", "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR",
                 "LATENT_CHANNEL_COUNT"):
        assert getattr(model, attr) == getattr(jmodel, attr), (family, attr)
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert model.is_flow and {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                              for k, v in model.example_batch(2, 128).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 128).items()}
    assert family in PORTED and type(get_model_family(config_namespace(_tiny_values(family)))) is type(model)
    assert JaxModelRegistry.metadata(family) == ModelRegistry.metadata(family)
    with pytest.raises(ValueError, match="flow-matching"):
        type(model)(config_namespace(_tiny_values(family, prediction_type="epsilon"))).check_user_config()
    with pytest.raises(NotImplementedError, match="item 4h"):
        model.model_predict_with_intermediates(None, {})

    rng = np.random.default_rng(5)
    latents = rng.standard_normal((2, 6, 10, model.latent_channels)).astype(np.float32)
    prepared = {"noisy_latents": latents, "timesteps": np.asarray([0.2, 0.7], np.float32),
                "text_embeds": rng.standard_normal((2, 7, model.arch.txt_in_features)).astype(np.float32)}
    jmodule = jmodel.create_module()
    jin = jmodel.get_model_inputs(jax.tree_util.tree_map(jnp.asarray, prepared))
    variables = numpy_variables(jmodule, **jin, seed=6)
    module = bridge(variables, model.create_module())
    inputs = model.get_model_inputs({k: t(v) for k, v in prepared.items()})
    assert inputs.keys() == jin.keys() and inputs["img_hw"] == jin["img_hw"].shape == (3, 5)
    np.testing.assert_array_equal(inputs["img"].numpy(), np.asarray(jin["img"]))
    with torch.no_grad():
        ours = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
        denoised = model.denoise_fn(module, model.inference_conditioning({"text_embeds": t(prepared["text_embeds"][:1])}))(
            t(latents[:1]), torch.tensor(0.2))
    theirs = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                      jax.tree_util.tree_map(jnp.asarray, prepared)))
    assert ours.shape == theirs.shape == latents.shape and rel(ours, theirs) < F32_REL
    assert rel(denoised.numpy(), theirs[:1]) < F32_REL


class _StandIn:
    """A text encoder's ``encode`` output, fixed: the packaging is what is compared."""

    def __init__(self, out):
        self.out = out

    def encode(self, prompts):
        return {k: v[:len(prompts)] for k, v in self.out.items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_encode_text_and_collate_drop_the_mask_as_jax(family):
    """Quirk kept (ROADMAP Queue 3): ``encode_text`` keeps the Qwen states
    with their pads and the mask per prompt, as the JAX family;
    ``collate_text_embeds`` drops the mask, and ``get_model_inputs`` passes
    no segment ids, so every padded token attends (1024 at Qwen-Image's
    length, 4096 at Z-Image's and MageFlow's)."""
    jmodel, model = _pair(_tiny_values(family))
    rng = np.random.default_rng(3)
    qwen = {"last_hidden_state": rng.standard_normal((3, 9, 32)).astype(np.float32),
            "attention_mask": (np.arange(9)[None] < np.asarray([[9], [2], [5]])).astype(np.int32)}
    for m in (jmodel, model):
        m.attach_text_encoders([_StandIn(qwen)])
    prompts = ["a", "b", "c"]
    ours, theirs = model.encode_text(prompts), jmodel.encode_text(prompts)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "text_embeds"]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    collated, jcollated = model.collate_text_embeds(ours), jmodel.collate_text_embeds(theirs)
    assert sorted(collated) == sorted(jcollated) == ["text_embeds"]
    np.testing.assert_array_equal(collated["text_embeds"], jcollated["text_embeds"])
    inputs = model.get_model_inputs({"noisy_latents": torch.zeros(1, 4, 4, model.latent_channels),
                                     "text_embeds": t(collated["text_embeds"]), "timesteps": torch.zeros(1)})
    assert "segment_ids" not in inputs
    assert model.TEXT_ENCODER_CONFIGURATION[0].max_length == (1024 if family == "qwen_image" else 4096)


def test_text_pads_reach_the_image_stream_as_in_jax():
    """Quirk kept (ROADMAP Queue 3): with no mask, changing the features at a
    prompt's pad positions moves its image prediction, in both packages alike
    (within ``F32_REL``)."""
    cfg = QwenImageConfig.tiny()
    img, txt, timesteps = _inputs(cfg, 3, 3, seed=4)
    jmodule = jax_qi.QwenImageTransformer(config=_jax_config(cfg), dtype=jnp.float32)
    jargs = lambda ctx: [jnp.asarray(img), jnp.zeros((3, 3)), jnp.asarray(ctx), jnp.asarray(timesteps)]  # noqa: E731
    variables = numpy_variables(jmodule, *jargs(txt), seed=5)
    port = bridge(variables, QwenImageTransformer(cfg, dtype=torch.float32))
    apply = jax.jit(jmodule.apply)
    padded = txt.copy()
    padded[1, 4:] = 0.0  # what a pad position carries changes
    outs = []
    for ctx in (txt, padded):
        with torch.no_grad():
            ours = port(t(img), (3, 3), t(ctx), t(timesteps)).numpy()
        theirs = np.asarray(apply(jax.tree_util.tree_map(jnp.asarray, variables), *jargs(ctx)))
        assert rel(ours, theirs) < F32_REL
        outs.append(ours)
    assert np.array_equal(outs[0][0], outs[1][0]) and not np.allclose(outs[0][1], outs[1][1])


def test_vae_choice_and_mageflow_channels_as_in_jax():
    """Quirk kept (ROADMAP Queue 3): the trainer picks the VAE by
    ``LATENT_CHANNEL_COUNT`` (16 or more: ``VAEConfig.flux()``, 16 latent
    channels) for all three families, in both packages; MageFlow's
    published arch reads 128 packed features (32 channels) while the Flux
    VAE makes 16-channel latents (64 packed features), so its step fails at
    ``img_in`` in both packages (here its arch at the tiny width with the
    published ``in_channels``)."""
    from simpletuner_tpu.models.vae import VAEConfig as JaxVAEConfig

    from simpletuner_tpu_torch.models.vae import VAEConfig

    assert VAEConfig.flux().latent_channels == JaxVAEConfig.flux().latent_channels == 16
    for family in FAMILIES:
        jmodel, model = _pair(_tiny_values(family, model_arch_preset=None))
        assert model.LATENT_CHANNEL_COUNT >= 16 and jmodel.LATENT_CHANNEL_COUNT >= 16
        assert model.latent_channels == jmodel.latent_channels == (32 if family == "mageflow" else 16)
    arch = dataclasses.replace(QwenImageConfig.tiny(), in_channels=128, txt_rope=False)
    jmodel, model = _pair(_tiny_values("mageflow"))
    jmodel.arch, model.arch = _jax_config(arch), arch
    rng = np.random.default_rng(8)
    template = {"noisy_latents": np.zeros((1, 4, 4, 32), np.float32), "timesteps": np.asarray([0.5], np.float32),
                "text_embeds": rng.standard_normal((1, 5, 32)).astype(np.float32)}
    jmodule = jmodel.create_module()
    variables = numpy_variables(jmodule, **jmodel.get_model_inputs(jax.tree_util.tree_map(jnp.asarray, template)),
                                seed=9)
    module = bridge(variables, model.create_module())
    vae_batch = {**template, "noisy_latents": rng.standard_normal((1, 4, 4, 16)).astype(np.float32)}
    with pytest.raises(Exception, match="shape"):
        jmodel.model_predict(jax.tree_util.tree_map(jnp.asarray, variables),
                             jax.tree_util.tree_map(jnp.asarray, vae_batch))
    with pytest.raises(RuntimeError, match="shapes cannot be multiplied"), torch.no_grad():
        model.model_predict(module, {k: t(v) for k, v in vae_batch.items()})
    with torch.no_grad():  # the latents its arch reads go through
        assert model.model_predict(module, {k: t(v) for k, v in template.items()}).shape == (1, 4, 4, 32)


# ---- weight import and the key map ------------------------------------------------------------------


def _jax_params(arch, seed):
    jmodule = jax_qi.QwenImageTransformer(config=_jax_config(arch))
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, arch.in_channels)),
                                                 jnp.zeros((2, 2)), jnp.zeros((1, 5, arch.txt_in_features)),
                                                 jnp.zeros(1)))
    return fill_numpy(shapes, seed)["params"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_import_matches_jax_bitwise(tmp_path, family):
    """The JAX exporter's file of a seeded tiny transformer (two shards in
    ``transformer/``): its names and shapes are ``qwen_image_checkpoint_shapes``,
    the port's tree is bitwise the JAX ``load_qwen_image_params`` tree under
    each family name, and the imported module bitwise the bridged JAX tree."""
    jmodel, model = _pair(_tiny_values(family))
    weights = export_qwen_image_to_diffusers(_jax_params(model.arch, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == qwen_image_checkpoint_shapes(model.arch)
    root = tmp_path / "qi" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_qwen_image_params(jmodel, str(tmp_path / "qi"))
    _assert_trees_bitwise(load_qwen_image_params(model, str(tmp_path / "qi")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "qi"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_key_map_and_default_targets_match_jax(tmp_path):
    """``qwen_image_key_map`` equal to the JAX map under each family name;
    an adapter file written by the port round-trips through the port's
    loader bitwise and loads into the JAX template; quirk kept (ROADMAP
    Queue 3): no code reads ``DEFAULT_LORA_TARGET``, so without
    ``lora_target_modules`` every adapter-carrying linear is adapted
    (``img_in``, ``txt_in``, the text stream and the MLPs)."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    for family in FAMILIES:
        jmodel, model = _pair(_tiny_values(family))
        assert _key_map_for(model) == JAX_KEY_MAPS[family](jmodel) == qwen_image_key_map(model.arch)
    every = {name.rsplit("/", 1)[0] for name in tl.lora_parameters(model.create_module())}
    assert {"img_in", "txt_in", "block_0/txt_attn_q", "block_1/img_mlp_out"} <= every
    jmodel, model = _pair(_tiny_values("qwen_image"))
    source = _seeded_adapters(model, 4, scale=0.05)
    path = str(tmp_path / "adapter.safetensors")
    save_lora_safetensors(model, source, path)
    target = model.create_module()
    assert load_lora_safetensors(model, path, target) == []
    for (name, a), b in zip(tl.lora_parameters(target).items(), tl.lora_parameters(source).values()):
        assert torch.equal(a, b), name
    template = numpy_variables(jmodel.create_module(), jnp.zeros((1, 4, 16)), jnp.zeros((2, 2)),
                               jnp.zeros((1, 5, 32)), jnp.zeros(1), seed=1)["lora"]
    loaded = jax_load_lora(jmodel, path, template)
    loaded = loaded[0] if isinstance(loaded, tuple) else loaded
    for name, param in tl.lora_parameters(source).items():
        node = loaded
        for part in name.split("/"):
            node = node[part]
        assert np.array_equal(np.asarray(node), param.detach().numpy().T), name
