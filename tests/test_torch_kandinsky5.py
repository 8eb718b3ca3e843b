"""The torch port's Kandinsky 5.0 families (image and video) against the JAX package, on the CPU.

The rope tables, patchify / unpatchify, the text and visual blocks (per
sample and tokenwise modulation), the transformer with its LoRA gradients
(T = 1 and T > 1, per-sample and tokenwise timesteps, remat, and the I2V
input through the family's ``model_predict``), the family contract (the
timestep at x 1000, the image flavour's frame axis, the flavours and the
alias), ``encode_text`` / collate, the import of the JAX exporter's output,
the key map and the quirks kept from the JAX families: the same seeded
numpy weights and inputs go through both packages.  The trainers'
trajectories are in test_torch_kandinsky5_trainer.py.  Every tolerance is
stated where it is checked.  At the tiny size the head dim is 16; the
published D = 64 shapes are held to the plain version on the card
(test_torch_kernels_cuda.py).
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
from simpletuner_tpu.models.kandinsky5 import transformer as jax_k5
from simpletuner_tpu.models.kandinsky5.model import Kandinsky5Image as JaxKandinsky5Image
from simpletuner_tpu.models.kandinsky5.model import Kandinsky5Video as JaxKandinsky5Video
from simpletuner_tpu.models.registry import ModelRegistry as JaxModelRegistry
from simpletuner_tpu.models.weight_export import export_kandinsky5_to_checkpoint
from simpletuner_tpu.models.weight_import import load_kandinsky5_params as jax_load_kandinsky5_params
from simpletuner_tpu.training.lora import kandinsky5_key_map as jax_kandinsky5_key_map

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import kandinsky5_checkpoint_shapes
from simpletuner_tpu_torch.models.kandinsky5 import Kandinsky5Config, Kandinsky5Image, Kandinsky5Transformer
from simpletuner_tpu_torch.models.kandinsky5 import Kandinsky5Video
from simpletuner_tpu_torch.models.kandinsky5 import transformer as k5
from simpletuner_tpu_torch.models.registry import PORTED, ModelRegistry, get_model_family
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_kandinsky5_params, load_transformer_params
from simpletuner_tpu_torch.training.lora import kandinsky5_key_map

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# gradient-derived numbers (test_torch_sdxl.py: f32 gradients through a deep
# net are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _restore_jax_globals():
    """Building a JAX model family installs a process-wide LoRA target
    predicate and int8 matmul mode."""
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jl.set_lora_target(None)
    yield
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])


def _tiny_values(family="kandinsky5_video", **extra):
    return {"model_family": family, "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    jax_cls = JaxKandinsky5Image if values["model_family"] == "kandinsky5_image" else JaxKandinsky5Video
    port_cls = Kandinsky5Image if values["model_family"] == "kandinsky5_image" else Kandinsky5Video
    return jax_cls(JaxTrainingConfig(values)), port_cls(config_namespace(values))


def test_presets_match_jax():
    for name in ("tiny", None):
        ours = Kandinsky5Config.tiny() if name else Kandinsky5Config()
        theirs = jax_k5.Kandinsky5Config.tiny() if name else jax_k5.Kandinsky5Config()
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), name
        assert (ours.head_dim, ours.num_heads, ours.visual_embed_dim) == \
            (theirs.head_dim, theirs.num_heads, theirs.visual_embed_dim)
    cfg = Kandinsky5Config()  # the Lite DiT as the JAX preset builds it
    assert (cfg.model_dim, cfg.num_heads, cfg.head_dim, cfg.ff_dim, cfg.num_visual_blocks, cfg.num_text_blocks) == \
        (2048, 32, 64, 5120, 32, 2)
    assert dataclasses.replace(cfg, visual_cond=True).visual_embed_dim == 9
    shapes = kandinsky5_checkpoint_shapes(cfg)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 2_147_285_776  # the JAX preset: 2.15B


def test_rope_tables_and_patchify_match_jax_bitwise():
    """The 1-D and 3-D rope angles (float64 on the host, rounded to f32; the
    3-D tables with the per-axis ``rope_scale``) and the patchify /
    unpatchify orders, bitwise the JAX functions."""
    for axes, scale in (((16, 24, 24), (1.0, 2.0, 2.0)), ((4, 6, 6), (1.0, 1.0, 1.0))):
        theirs = np.asarray(jax_k5.k5_rope_3d((3, 4, 5), axes, scale))
        ours = k5.k5_rope_3d((3, 4, 5), axes, scale)
        assert ours.shape == theirs.shape == (60, sum(axes) // 2) and np.array_equal(ours, theirs)
    assert np.array_equal(k5.k5_rope_1d(np.arange(13), 64), np.asarray(jax_k5.k5_rope_1d(np.arange(13), 64)))
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 6, 5)).astype(np.float32)
    patched = k5.k5_patchify(t(x), (1, 2, 2)).numpy()
    assert np.array_equal(patched, np.asarray(jax_k5.k5_patchify(jnp.asarray(x), (1, 2, 2))))
    out = np.random.default_rng(1).standard_normal((2, 3, 2, 3, 20)).astype(np.float32)
    assert np.array_equal(k5.k5_unpatchify(t(out), (1, 2, 2), 5).numpy(),
                          np.asarray(jax_k5.k5_unpatchify(jnp.asarray(out), (1, 2, 2), 5)))
    angles = np.random.default_rng(2).uniform(0, 6, (7, 8)).astype(np.float32)
    q = np.random.default_rng(3).standard_normal((2, 7, 3, 16)).astype(np.float32)
    assert rel(k5.k5_apply_rope(t(q), t(angles)).numpy(),
               np.asarray(jax_k5.k5_apply_rope(jnp.asarray(q), jnp.asarray(angles)))) < F32_REL


@pytest.mark.parametrize("kind", ["text", "visual", "visual_tokenwise"])
def test_blocks_match_jax(kind):
    """One text block (six-way modulation, 1-D rope) or visual block
    (nine-way, 3-D rope, cross-attention over the text) in f32 with rank-4
    adapters, modulated per sample or per token: within ``F32_REL``."""
    cfg = Kandinsky5Config.tiny()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, cfg.model_dim), dtype=np.float32)
    text = rng.standard_normal((2, 5, cfg.model_dim), dtype=np.float32)
    time = rng.standard_normal((2, 12, cfg.time_dim) if kind == "visual_tokenwise" else (2, cfg.time_dim),
                               dtype=np.float32)
    if kind == "text":
        angles = k5.k5_rope_1d(np.arange(12), cfg.head_dim)
        jblock = jax_k5.K5EncoderBlock(jax_k5.Kandinsky5Config.tiny(), dtype=jnp.float32, lora_rank=4)
        args = (x, time, angles)
        port = k5.K5EncoderBlock(cfg, dtype=torch.float32, lora_rank=4)
    else:
        angles = k5.k5_rope_3d((1, 3, 4), cfg.axes_dims, cfg.rope_scale)
        jblock = jax_k5.K5DecoderBlock(jax_k5.Kandinsky5Config.tiny(), dtype=jnp.float32, lora_rank=4)
        args = (x, text, time, angles)
        port = k5.K5DecoderBlock(cfg, dtype=torch.float32, lora_rank=4)
    variables = numpy_variables(jblock, *map(jnp.asarray, args), seed=2)
    port = bridge(variables, port)
    ref = jblock.apply(jax.tree_util.tree_map(jnp.asarray, variables), *map(jnp.asarray, args))
    with torch.no_grad():
        out = port(*map(t, args))
    assert tuple(out.shape) == ref.shape and rel(out.numpy(), ref) < F32_REL


def _inputs(cfg, frames, tokenwise, seed=0, height=6, width=8, text_len=7):
    rng = np.random.default_rng(seed)
    latents = rng.standard_normal((2, frames, height, width, cfg.visual_embed_dim), dtype=np.float32)
    text = rng.standard_normal((2, text_len, cfg.in_text_dim), dtype=np.float32)
    pooled = rng.standard_normal((2, cfg.in_text_dim2), dtype=np.float32)
    tokens = frames * (height // 2) * (width // 2)
    timesteps = rng.uniform(0, 1000, (2, tokens) if tokenwise else (2,)).astype(np.float32)
    return latents, text, pooled, timesteps


@pytest.mark.parametrize("variant", ["video", "image_frame", "tokenwise", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny DiT (f32, rank-4 adapters) on the same seeded weights: the
    output within ``F32_REL`` over 3 frames, over T = 1, with tokenwise
    timesteps (B, S_vis) and under remat; the LoRA gradients of a seeded
    projection of it against ``jax.grad`` within ``GRAD_REL``, per adapter."""
    cfg = Kandinsky5Config.tiny()
    remat = variant == "remat"
    latents, text, pooled, timesteps = _inputs(cfg, 1 if variant == "image_frame" else 3, variant == "tokenwise")
    weight = np.random.default_rng(9).standard_normal(latents.shape[:-1] + (cfg.out_visual_dim,)).astype(np.float32)
    jmodule = jax_k5.Kandinsky5Transformer(config=jax_k5.Kandinsky5Config.tiny(), dtype=jnp.float32, lora_rank=4,
                                           remat=remat)
    jargs = [jnp.asarray(a) for a in (latents, text, pooled, timesteps)]
    variables = numpy_variables(jmodule, *jargs, seed=1)
    port = bridge(variables, Kandinsky5Transformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

    def jax_loss(lora):
        out = jmodule.apply({"params": params, "lora": lora}, *jargs)
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(port)
    out = port(*map(t, (latents, text, pooled, timesteps)))
    assert tuple(out.shape) == ref.shape == weight.shape and out.dtype == torch.float32
    assert rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and "visual_block_1/cross_attention/to_key/lora_A" in flat
    assert "text_block_0/feed_forward/out_layer/lora_B" in flat and "visual_in/lora_A" in flat
    assert not any("modulation" in path or path.startswith(("time_", "text_in", "pooled_")) for path in flat)
    for path, param in adapters.items():
        assert param.grad is not None and rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


# ---- the family contract -----------------------------------------------------------------------------


def test_contract_timestep_scale_and_the_image_frame_axis():
    """Both flavours' constants, specs, archs and example batches as the JAX
    families'; ``get_model_inputs`` passes sigma x 1000; the image flavour
    inserts T = 1 before the DiT and drops it after; ``model_predict`` and
    ``denoise_fn`` equal to the JAX ``model_predict`` within ``F32_REL``; the
    registry builds both (and the ``kandinsky5-image`` alias); a non-flow
    prediction type is refused; the intermediates tap is refused by name."""
    for family in ("kandinsky5_video", "kandinsky5_image"):
        jmodel, model = _pair(_tiny_values(family))
        for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "MODALITY", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR",
                     "HUGGINGFACE_PATHS", "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR",
                     "LATENT_CHANNEL_COUNT"):
            assert getattr(model, attr) == getattr(jmodel, attr), (family, attr)
        assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
            [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
        assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch) and model.is_flow
        assert model.latent_channels == jmodel.latent_channels == 4
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 128).items()} \
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 128).items()}
        assert family in PORTED and isinstance(get_model_family(config_namespace(_tiny_values(family))), type(model))
        with pytest.raises(ValueError, match="flow-matching"):
            type(model)(config_namespace(_tiny_values(family, prediction_type="epsilon"))).check_user_config()
        with pytest.raises(NotImplementedError, match="item 4h"):
            model.model_predict_with_intermediates(None, {})
    assert ModelRegistry.get("kandinsky5-image") is Kandinsky5Image
    assert JaxModelRegistry.metadata("kandinsky5-image") == ModelRegistry.metadata("kandinsky5-image")

    jmodel, model = _pair(_tiny_values("kandinsky5_image"))
    rng = np.random.default_rng(5)
    latents = rng.standard_normal((2, 6, 8, 4)).astype(np.float32)
    prepared = {"noisy_latents": latents, "timesteps": np.asarray([0.2, 0.7], np.float32),
                "text_embeds": rng.standard_normal((2, 7, 24)).astype(np.float32),
                "pooled_embeds": rng.standard_normal((2, 12)).astype(np.float32)}
    jmodule = jmodel.create_module()
    variables = numpy_variables(jmodule, *map(jnp.asarray, (latents[:, None], prepared["text_embeds"],
                                                            prepared["pooled_embeds"], prepared["timesteps"])), seed=6)
    module = bridge(variables, model.create_module())
    inputs = model.get_model_inputs({k: t(v) for k, v in prepared.items()})
    assert inputs.keys() == jmodel.get_model_inputs(prepared).keys()
    assert tuple(inputs["latents"].shape) == (2, 1, 6, 8, 4)
    np.testing.assert_array_equal(inputs["timesteps"].numpy(), prepared["timesteps"] * 1000.0)
    with torch.no_grad():
        ours = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
        denoised = model.denoise_fn(module, model.inference_conditioning(
            {"text_embeds": t(prepared["text_embeds"][:1]), "pooled_embeds": t(prepared["pooled_embeds"][:1])}))(
            t(latents[:1]), torch.tensor(0.2))
    theirs = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                      jax.tree_util.tree_map(jnp.asarray, prepared)))
    assert ours.shape == theirs.shape == latents.shape and rel(ours, theirs) < F32_REL
    assert rel(denoised.numpy(), theirs[:1]) < F32_REL


def test_i2v_packing_matches_jax():
    """The ``lite-i2v`` flavour at the tiny width (``visual_cond``, 9
    channels in): [noisy, condition, mask] packed as the JAX family packs it,
    with the condition given (mask of ones), both given, and neither (zeros
    and a zero mask), and ``model_predict`` within ``F32_REL``."""
    values = _tiny_values(model_flavour="lite-i2v")
    jmodel, model = _pair(values)
    full = {**values, "model_arch_preset": None}
    assert model.__class__(config_namespace(full)).arch.visual_cond and jmodel.__class__(
        JaxTrainingConfig(full)).arch.visual_cond
    arch = dataclasses.replace(Kandinsky5Config.tiny(), visual_cond=True)
    jmodel.arch, model.arch = jax_k5.Kandinsky5Config(**dataclasses.asdict(arch)), arch
    rng = np.random.default_rng(7)
    noisy = rng.standard_normal((2, 3, 4, 6, 4)).astype(np.float32)
    base = {"noisy_latents": noisy, "timesteps": np.asarray([0.3, 0.6], np.float32),
            "text_embeds": rng.standard_normal((2, 5, 24)).astype(np.float32),
            "pooled_embeds": rng.standard_normal((2, 12)).astype(np.float32)}
    cond = rng.standard_normal(noisy.shape).astype(np.float32)
    mask = (rng.uniform(size=noisy.shape[:-1] + (1,)) > 0.5).astype(np.float32)
    jmodule = jmodel.create_module()
    packed = np.concatenate([noisy, cond, mask], -1)
    variables = numpy_variables(jmodule, *map(jnp.asarray, (packed, base["text_embeds"], base["pooled_embeds"],
                                                            base["timesteps"])), seed=8)
    module = bridge(variables, model.create_module())
    for extra in ({}, {"i2v_cond_latents": cond}, {"i2v_cond_latents": cond, "i2v_cond_mask": mask}):
        prepared = {**base, **extra}
        ours_in = model.get_model_inputs({k: t(v) for k, v in prepared.items()})["latents"].numpy()
        theirs_in = np.asarray(jmodel.get_model_inputs(jax.tree_util.tree_map(jnp.asarray, prepared))["latents"])
        assert ours_in.shape == (2, 3, 4, 6, 9) and np.array_equal(ours_in, theirs_in)
        with torch.no_grad():
            ours = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
        theirs = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                          jax.tree_util.tree_map(jnp.asarray, prepared)))
        assert ours.shape == noisy.shape and rel(ours, theirs) < F32_REL


class _StandIn:
    """A text encoder's ``encode`` output, fixed: the packaging is what is compared."""

    def __init__(self, out):
        self.out = out

    def encode(self, prompts):
        return {k: v[:len(prompts)] for k, v in self.out.items()}


def test_encode_text_and_collate_drop_the_mask_as_jax():
    """Quirk kept (ROADMAP Queue 3): ``encode_text`` keeps Qwen2.5-VL's
    padded states, its mask and CLIP's pooled state per prompt, as the JAX
    family; ``collate_text_embeds`` drops the mask, so the text blocks and
    every cross-attention run unmasked over all 512 (here 9) tokens."""
    jmodel, model = _pair(_tiny_values())
    rng = np.random.default_rng(3)
    qwen = {"last_hidden_state": rng.standard_normal((3, 9, 24)).astype(np.float32),
            "attention_mask": (np.arange(9)[None] < np.asarray([[9], [2], [5]])).astype(np.int32)}
    clip = {"last_hidden_state": rng.standard_normal((3, 77, 12)).astype(np.float32),
            "pooled": rng.standard_normal((3, 12)).astype(np.float32)}
    for m in (jmodel, model):
        m.attach_text_encoders([_StandIn(qwen), _StandIn(clip)])
    prompts = ["a", "b", "c"]
    ours, theirs = model.encode_text(prompts), jmodel.encode_text(prompts)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "pooled_embeds", "text_embeds"]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    collated, jcollated = model.collate_text_embeds(ours), jmodel.collate_text_embeds(theirs)
    assert sorted(collated) == sorted(jcollated) == ["pooled_embeds", "text_embeds"]
    for key in collated:
        np.testing.assert_array_equal(collated[key], jcollated[key])


def test_text_pads_reach_the_visual_stream_as_in_jax():
    """Quirk kept (ROADMAP Queue 3): with no mask anywhere, changing the
    features at a prompt's pad positions moves the visual prediction, in both
    packages alike (within ``F32_REL``)."""
    cfg = Kandinsky5Config.tiny()
    latents, text, pooled, timesteps = _inputs(cfg, 2, False, seed=4)
    jmodule = jax_k5.Kandinsky5Transformer(config=jax_k5.Kandinsky5Config.tiny(), dtype=jnp.float32)
    variables = numpy_variables(jmodule, *map(jnp.asarray, (latents, text, pooled, timesteps)), seed=5)
    port = bridge(variables, Kandinsky5Transformer(cfg, dtype=torch.float32))
    apply = jax.jit(jmodule.apply)
    padded = text.copy()
    padded[1, 4:] = 0.0  # what a pad position carries changes
    outs = []
    for ctx in (text, padded):
        with torch.no_grad():
            ours = port(*map(t, (latents, ctx, pooled, timesteps))).numpy()
        theirs = np.asarray(apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                  *map(jnp.asarray, (latents, ctx, pooled, timesteps))))
        assert rel(ours, theirs) < F32_REL
        outs.append(ours)
    assert np.array_equal(outs[0][0], outs[1][0]) and not np.allclose(outs[0][1], outs[1][1])


def test_vae_choice_and_scaling_as_in_jax():
    """Quirk kept (ROADMAP Queue 3): 4 latent channels, so the trainer
    builds the 4-channel SD VAE (scaling 0.18215 in the cache) for the image
    flavour and a Wan-config video VAE with 4 latents for the video flavour,
    as the JAX trainer does, while the family's ``VAE_SCALING_FACTOR`` stays
    1.0 (the render divides by 1.0)."""
    from simpletuner_tpu.models.video_vae import VideoVAEConfig as JaxVideoVAEConfig

    from simpletuner_tpu_torch.models.vae import VAEConfig
    from simpletuner_tpu_torch.models.video_vae import VideoVAEConfig

    for family in ("kandinsky5_image", "kandinsky5_video"):
        jmodel, model = _pair({**_tiny_values(family), "model_arch_preset": None})
        assert model.LATENT_CHANNEL_COUNT == jmodel.LATENT_CHANNEL_COUNT == 4
        assert model.VAE_SCALING_FACTOR == jmodel.VAE_SCALING_FACTOR == 1.0
    _, video = _pair({**_tiny_values(), "model_arch_preset": None})
    assert video.video_vae_config() == dataclasses.replace(VideoVAEConfig.wan(), latent_channels=4)
    jvideo = JaxKandinsky5Video(JaxTrainingConfig({**_tiny_values(), "model_arch_preset": None}))
    assert dataclasses.asdict(jvideo.video_vae_config()) == dataclasses.asdict(
        dataclasses.replace(JaxVideoVAEConfig.wan(), latent_channels=4))
    assert VAEConfig().latent_channels == 4 and VAEConfig().scaling_factor == 0.18215


def test_both_encoders_read_tokenizer_as_in_jax():
    """Quirk kept (ROADMAP Queue 3): the Qwen2.5-VL and the CLIP-L spec name
    no tokenizer subfolder, so the LLM builder and the CLIP builder both read
    ``tokenizer/`` (a published Kandinsky 5.0 dir keeps CLIP's in
    ``tokenizer_2/``), in both packages."""
    jmodel, model = _pair(_tiny_values())
    assert [s.tokenizer_subfolder for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [s.tokenizer_subfolder for s in jmodel.TEXT_ENCODER_CONFIGURATION] == [None, None]
    assert [s.subfolder for s in model.TEXT_ENCODER_CONFIGURATION] == ["text_encoder", "text_encoder_2"]


# ---- weight import and the key map ------------------------------------------------------------------


def _jax_params(jmodel, seed):
    arch = jmodel.arch
    shapes = jax.eval_shape(lambda: jax_k5.Kandinsky5Transformer(config=arch).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 4, 4, arch.visual_embed_dim)), jnp.zeros((1, 5, arch.in_text_dim)),
        jnp.zeros((1, arch.in_text_dim2)), jnp.zeros(1)))
    return fill_numpy(shapes, seed)["params"]


@pytest.mark.parametrize("family", ["kandinsky5_video", "kandinsky5_image"])
def test_import_matches_jax_bitwise(tmp_path, family):
    """The JAX exporter's file of a seeded tiny transformer (two shards in
    ``transformer/``): its names and shapes are ``kandinsky5_checkpoint_shapes``,
    the port's tree is bitwise the JAX ``load_kandinsky5_params`` tree (the
    importer is registered under both family names), and the imported module
    bitwise the bridged JAX tree."""
    jmodel, model = _pair(_tiny_values(family))
    weights = export_kandinsky5_to_checkpoint(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == kandinsky5_checkpoint_shapes(model.arch)
    root = tmp_path / "k5" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_kandinsky5_params(jmodel, str(tmp_path / "k5"))
    _assert_trees_bitwise(load_kandinsky5_params(model, str(tmp_path / "k5")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "k5"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_key_map_and_default_targets_match_jax():
    """Quirk kept (ROADMAP Queue 3): ``kandinsky5_key_map`` equal to the JAX
    map; no code reads ``DEFAULT_LORA_TARGET``, so without
    ``lora_target_modules`` every adapter-carrying linear is adapted
    (``visual_in``, ``out_proj``, the feed-forwards), and the default's names
    as targets also adapt the feed-forward's ``out_layer`` (the modulation
    heads' ``out_layer`` carries no adapter); the attentions alone need
    qualified names."""
    for family in ("kandinsky5_video", "kandinsky5_image"):
        jmodel, model = _pair(_tiny_values(family))
        assert kandinsky5_key_map(model.arch) == jax_kandinsky5_key_map(jmodel.arch)
    every = {name.rsplit("/", 1)[0] for name in tl.lora_parameters(model.create_module())}
    assert {"visual_in", "out_proj", "visual_block_0/feed_forward/in_layer", "text_block_0/self_attention/to_key"} \
        <= every
    _, named = _pair(_tiny_values(lora_target_modules=list(Kandinsky5Video.DEFAULT_LORA_TARGET)))
    adapted = {name.rsplit("/", 1)[0].split("/", 1)[1] for name in tl.lora_parameters(named.create_module())
               if "/" in name.rsplit("/", 1)[0]}
    assert "feed_forward/out_layer" in adapted and "feed_forward/in_layer" not in adapted
    qualified = [f"{a}.{p}" for a in ("self_attention", "cross_attention")
                 for p in ("to_query", "to_key", "to_value", "out_layer")]
    _, attention = _pair(_tiny_values(lora_target_modules=qualified))
    adapted = {name.rsplit("/", 1)[0].split("/", 1)[1] for name in tl.lora_parameters(attention.create_module())}
    assert adapted == {f"{a}/{p}" for a in ("self_attention", "cross_attention")
                       for p in ("to_query", "to_key", "to_value", "out_layer")}


def test_tiny_preset_does_not_fit_its_tiny_encoders_as_in_jax():
    """Quirk kept (ROADMAP Queue 3): the tiny arch reads 24-wide Qwen states
    and a 12-wide pooled vector, while the tiny Qwen2 and CLIP-L the tiny
    preset builds (both packages' ``load_text_encoders(tiny=True)``) are 32
    wide, so a tiny render from encoded prompts fails in both packages; the
    trainer tests widen the tiny arch (test_torch_kandinsky5_trainer.py)."""
    from simpletuner_tpu.models.llm_encoder import LLMEncoderConfig as JaxLLMConfig

    from simpletuner_tpu_torch.models.clip import CLIPTextConfig
    from simpletuner_tpu_torch.models.llm_encoder import LLMEncoderConfig

    ours, theirs = Kandinsky5Config.tiny(), jax_k5.Kandinsky5Config.tiny()
    assert (ours.in_text_dim, ours.in_text_dim2) == (theirs.in_text_dim, theirs.in_text_dim2) == (24, 12)
    assert LLMEncoderConfig.tiny("qwen2").hidden_size == JaxLLMConfig.tiny("qwen2").hidden_size == 32
    assert CLIPTextConfig.tiny(hidden_size=32).hidden_size == 32  # the CLIP-L builder's tiny width
