"""The torch port's LongCat-Image family and the Flux transformer's tokenwise
timesteps against the JAX package, on the CPU.

The Flux DiT with tokenwise timesteps (the text stream on the per-sample
mean, the single blocks on ``[text mean, per token]``; with and without the
pooled and guidance embedders, under remat, in bf16) and its LoRA gradients
against ``jax.grad``; the family contract: the presets, the sliding position
ids, the edit flavour's reference tokens at modality 2 and t = 0, the
prediction with them sliced off; ``encode_text`` with the captioning
template's spans sliced off on a tiny Qwen trunk; the import of the JAX
exporter's file, the key map and adapter files; a true-CFG render against
the JAX sampler on the same ids.  The trainer's trajectory is in
test_torch_longcat_zlab_trainer.py.  Every tolerance is stated where it is
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
from simpletuner_tpu.models import text_encoders as jax_te
from simpletuner_tpu.models.flux import transformer as jax_flux
from simpletuner_tpu.models.llm_encoder import LLMEncoder as JaxLLMEncoder
from simpletuner_tpu.models.longcat_image.model import LongcatImage as JaxLongcatImage
from simpletuner_tpu.models.weight_export import export_longcat_image_to_checkpoint
from simpletuner_tpu.models.weight_import import load_longcat_image_params as jax_load_longcat_params
from simpletuner_tpu.schedulers.sampling import classifier_free_guidance as jax_cfg
from simpletuner_tpu.schedulers.sampling import sample_loop as jax_sample_loop
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS
from simpletuner_tpu.training.validation import build_scheduler as jax_build_scheduler

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import longcat_image_checkpoint_shapes
from simpletuner_tpu_torch.models.flux.transformer import FluxConfig, FluxTransformer
from simpletuner_tpu_torch.models.llm_encoder import LLMEncoder, LLMEncoderConfig
from simpletuner_tpu_torch.models.longcat_image import PROMPT_PREFIX, PROMPT_SUFFIX, LongcatImage
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.text_encoders import LLMTextEncoder
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_longcat_image_params, load_transformer_params
from simpletuner_tpu_torch.schedulers.sampling import classifier_free_guidance, sample_loop
from simpletuner_tpu_torch.training.lora import _key_map_for, flux_key_map
from simpletuner_tpu_torch.training.validation import build_scheduler

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# f32 LoRA gradients (test_torch_sdxl.py: f32 gradients through a deep net
# are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
# bf16 on both sides: each rounds its own intermediates
BF16_REL = 2e-2


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
    return {"model_family": "longcat_image", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxLongcatImage(JaxTrainingConfig(values)), LongcatImage(config_namespace(values))


def _jax_config(cfg):
    return jax_flux.FluxConfig(**dataclasses.asdict(cfg))


def _tokenwise_inputs(cfg, seed, height=8, width=6, txt_len=5, refs=True):
    """Packed image tokens (the scene, then a reference image's when ``refs``),
    text, sliding-style ids and per-token timesteps with the reference at 0."""
    rng = np.random.default_rng(seed)
    scene = (height // 2) * (width // 2)
    tokens = 2 * scene if refs else scene
    img = rng.standard_normal((2, tokens, cfg.in_channels), dtype=np.float32)
    txt = rng.standard_normal((2, txt_len, cfg.txt_in_features), dtype=np.float32)
    img_ids = rng.integers(0, 12, (2, tokens, 3)).astype(np.float32)
    txt_ids = rng.integers(0, 12, (2, txt_len, 3)).astype(np.float32)
    timesteps = np.concatenate([np.repeat(np.asarray([[0.3], [0.8]], np.float32), scene, axis=1),
                                np.zeros((2, tokens - scene), np.float32)], axis=1)
    vec = rng.standard_normal((2, cfg.vec_in_features), dtype=np.float32)
    guidance = np.asarray([3.5, 1.0], np.float32)
    return img, img_ids, txt, txt_ids, timesteps, vec, guidance


# ---- the Flux transformer with tokenwise timesteps ---------------------------------------------


@pytest.mark.parametrize("variant", ["longcat", "pooled_guidance", "remat", "scene_only"])
def test_tokenwise_transformer_and_lora_grads_match_jax(variant):
    """The tiny Flux DiT (f32, rank-4 adapters) with (B, S_img) timesteps, the
    reference tokens at t = 0: LongCat's (no pooled or guidance embedder),
    Flux's with both (their (B, dim) conditioning broadcast over the tokens),
    under remat, and with every token at the sample's t; the output within
    ``F32_REL`` and the LoRA gradients of a seeded projection of it against
    ``jax.grad`` within ``GRAD_REL``, per adapter."""
    embed = variant == "pooled_guidance"
    cfg = dataclasses.replace(FluxConfig.tiny(), vector_embed=embed, guidance_embed=embed)
    remat = variant == "remat"
    img, img_ids, txt, txt_ids, timesteps, vec, guidance = _tokenwise_inputs(cfg, 1, refs=variant != "scene_only")
    jmodule = jax_flux.FluxTransformer(config=_jax_config(cfg), dtype=jnp.float32, lora_rank=4, remat=remat)
    jargs = [jnp.asarray(img), jnp.asarray(img_ids), jnp.asarray(txt), jnp.asarray(txt_ids), jnp.asarray(timesteps),
             jnp.asarray(vec) if embed else None, jnp.asarray(guidance) if embed else None]
    variables = numpy_variables(jmodule, *jargs, seed=2)
    port = bridge(variables, FluxTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    weight = np.random.default_rng(9).standard_normal(img.shape).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

    def jax_loss(lora):
        out = jmodule.apply({"params": params, "lora": lora}, *jargs)
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(port)
    out = port(t(img), t(img_ids), t(txt), t(txt_ids), t(timesteps), t(vec) if embed else None,
               t(guidance) if embed else None)
    assert tuple(out.shape) == ref.shape == img.shape and rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and "single_1/linear1/lora_A" in flat
    for path, param in adapters.items():
        assert param.grad is not None and rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_tokenwise_conditioning_views():
    """Tokenwise timesteps equal to the sample's t on every token give the
    per-sample forward exactly (the mean of equal rows is that row), while a
    reference token at t = 0 moves the scene's prediction."""
    cfg = dataclasses.replace(FluxConfig.tiny(), vector_embed=False, guidance_embed=False)
    img, img_ids, txt, txt_ids, timesteps, _, _ = _tokenwise_inputs(cfg, 3, refs=False)
    port = tl.init_parameters(FluxTransformer(cfg, dtype=torch.float32), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in port.named_parameters():  # open the AdaLN-Zero gates
            if name.endswith("lin.weight"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
        per_sample = port(t(img), t(img_ids), t(txt), t(txt_ids), t(timesteps[:, 0]), None)
        tokenwise = port(t(img), t(img_ids), t(txt), t(txt_ids), t(timesteps), None)
        moved = timesteps.copy()
        moved[:, -1] = 0.0
        changed = port(t(img), t(img_ids), t(txt), t(txt_ids), t(moved), None)
    assert torch.allclose(per_sample, tokenwise, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(changed[:, :-1], tokenwise[:, :-1])


def test_tokenwise_transformer_bf16_matches_jax():
    """LongCat's tiny DiT in bf16 (f32 adapters and norm scales) with the
    reference tokens at t = 0, against the JAX module in bf16 on the same
    weights: within ``BF16_REL``."""
    cfg = dataclasses.replace(FluxConfig.tiny(), vector_embed=False, guidance_embed=False)
    img, img_ids, txt, txt_ids, timesteps, _, _ = _tokenwise_inputs(cfg, 4)
    jmodule = jax_flux.FluxTransformer(config=_jax_config(cfg), dtype=jnp.bfloat16, lora_rank=4)
    jargs = [jnp.asarray(img), jnp.asarray(img_ids), jnp.asarray(txt), jnp.asarray(txt_ids), jnp.asarray(timesteps),
             None]
    variables = numpy_variables(jmodule, *jargs, seed=5)
    port = bridge(variables, FluxTransformer(cfg, dtype=torch.bfloat16, lora_rank=4))
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables), *jargs))
    with torch.no_grad():
        out = port(t(img), t(img_ids), t(txt), t(txt_ids), t(timesteps), None).numpy()
    assert out.dtype == ref.dtype == np.float32 and rel(out, ref) < BF16_REL


# ---- the family contract -----------------------------------------------------------------------------


def test_presets_and_contract_match_jax():
    """The family's constants, spec and arch (tiny and published) as the JAX
    family's; the published arch is 3072 wide, 24 heads of 128, 19 + 38
    blocks over 3584-wide text with no pooled or guidance embedder (11.88B
    parameters in its checkpoint layout); the example batch has no pooled
    embeds; a non-flow prediction type is refused."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR", "LATENT_CHANNEL_COUNT"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch)
    for flavour in ("final", "dev", "edit"):
        values = {**_tiny_values(), "model_arch_preset": None, "model_flavour": flavour}
        jfull, full = _pair(values)
        assert dataclasses.asdict(full.arch) == dataclasses.asdict(jfull.arch)
        assert full.is_kontext == jfull.is_kontext == (flavour == "edit")
    cfg = full.arch
    assert (cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.depth_double, cfg.depth_single, cfg.txt_in_features,
            cfg.vector_embed, cfg.guidance_embed) == (3072, 24, 128, 19, 38, 3584, False, False)
    assert sum(int(np.prod(s)) for s in longcat_image_checkpoint_shapes(cfg).values()) == 11_877_803_072
    assert "longcat_image" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), LongcatImage)
    with pytest.raises(ValueError, match="flow-matching"):
        LongcatImage(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 128).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 128).items()}


@pytest.mark.parametrize("flavour", ["final", "edit"])
def test_sliding_ids_edit_tokens_and_prediction_match_jax(flavour):
    """``prepare_batch``'s ids as the JAX family's (text (0, i, i), image (1,
    L + y, L + x), f32) with the sigmas and noise given; in the edit flavour
    ``get_model_inputs`` appends the reference tokens at (2, L + y, L + x)
    with t = 0 on each of them, bitwise the JAX inputs; ``model_predict``
    (the reference predictions sliced off) within ``F32_REL`` of the JAX
    ``model_predict``; no guidance reaches the transformer."""
    values = _tiny_values(model_flavour=flavour)
    jmodel, model = _pair(values)
    rng = np.random.default_rng(6)
    latents = rng.standard_normal((2, 8, 6, 4)).astype(np.float32)
    batch = {"latents": latents, "t5_embeds": rng.standard_normal((2, 5, 32)).astype(np.float32),
             "override_noise": rng.standard_normal((2, 8, 6, 4)).astype(np.float32),
             "override_sigmas": np.asarray([0.3, 0.8], np.float32)}
    if flavour == "edit":
        batch["control_latents"] = rng.standard_normal((2, 8, 6, 4)).astype(np.float32)
    jprepared = jmodel.prepare_batch(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    prepared = model.prepare_batch(torch.Generator().manual_seed(0), {k: t(v) for k, v in batch.items()})
    assert "guidance" not in prepared and "guidance" not in jprepared
    for key in ("txt_ids", "img_ids", "noisy_latents", "timesteps"):
        assert prepared[key].dtype == torch.float32 and np.array_equal(prepared[key].numpy(), jprepared[key]), key
    assert prepared["img_ids"][0, 0].tolist() == [1.0, 5.0, 5.0] and prepared["txt_ids"][0, 2].tolist() == [0, 2, 2]
    inputs = model.get_model_inputs(prepared)
    jinputs = jmodel.get_model_inputs(jprepared)
    assert sorted(inputs) == sorted(k for k in jinputs) and inputs["vec"] is None
    for key in ("img", "img_ids", "timesteps", "txt_ids"):
        assert np.array_equal(inputs[key].numpy(), np.asarray(jinputs[key])), key
    scene = 4 * 3
    if flavour == "edit":
        assert inputs["img"].shape[1] == 2 * scene and inputs["timesteps"].shape == (2, 2 * scene)
        assert float(inputs["timesteps"][:, scene:].abs().max()) == 0.0
        assert inputs["img_ids"][0, scene].tolist() == [2.0, 5.0, 5.0]
    jmodule = jmodel.create_module()
    variables = numpy_variables(jmodule, **{k: v for k, v in jinputs.items()}, seed=7)
    module = bridge(variables, model.create_module())
    with torch.no_grad():
        ours = model.model_predict(module, prepared).numpy()
    theirs = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables), jprepared))
    assert ours.shape == theirs.shape == latents.shape and rel(ours, theirs) < F32_REL


def test_true_cfg_render_matches_the_jax_sampler():
    """A 3-step true-CFG flow render (guidance 4, the family has no guidance
    embedding) from ``inference_conditioning``'s sliding ids, against the JAX
    sample loop on ``denoise_fn`` with the ids the JAX ``prepare_batch``
    makes, on the same noise: within ``F32_REL``.  Kept difference: the JAX
    family inherits Flux's ``inference_conditioning``, which reads
    ``pooled_embeds`` and so raises ``KeyError`` on LongCat's payload."""
    jmodel, model = _pair(_tiny_values())
    rng = np.random.default_rng(8)
    embeds = rng.standard_normal((1, 5, 32)).astype(np.float32)
    negative = rng.standard_normal((1, 5, 32)).astype(np.float32)
    noise = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    with pytest.raises(KeyError, match="pooled_embeds"):
        jmodel.inference_conditioning({"latents": jnp.zeros((1, 8, 8, 4)), "t5_embeds": jnp.asarray(embeds)})
    jmodule = jmodel.create_module()
    jprepared = jmodel.prepare_batch(jax.random.PRNGKey(0), {"latents": jnp.zeros((1, 8, 8, 4)),
                                                            "t5_embeds": jnp.asarray(embeds)})
    variables = numpy_variables(jmodule, **jmodel.get_model_inputs(jprepared), seed=9)
    module = bridge(variables, model.create_module())
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)

    def jcond(e):
        return {"t5_embeds": jnp.asarray(e), "txt_ids": jprepared["txt_ids"], "img_ids": jprepared["img_ids"]}

    jc, ju = jmodel.denoise_fn(jvars, jcond(embeds)), jmodel.denoise_fn(jvars, jcond(negative))
    theirs = jax_sample_loop(jax_build_scheduler(jmodel, 3), lambda x, s: jax_cfg(jc(x, s), ju(x, s), 4.0),
                             jnp.asarray(noise))
    cond = model.inference_conditioning({"latents": torch.zeros(1, 8, 8, 4), "t5_embeds": t(embeds)})
    uncond = model.inference_conditioning({"latents": torch.zeros(1, 8, 8, 4), "t5_embeds": t(negative)})
    for key in ("txt_ids", "img_ids"):
        assert np.array_equal(cond[key].numpy(), np.asarray(jprepared[key])), key
    c, u = model.denoise_fn(module, cond), model.denoise_fn(module, uncond)
    with torch.no_grad():
        ours = sample_loop(build_scheduler(model, 3), lambda x, s: classifier_free_guidance(c(x, s), u(x, s), 4.0),
                           t(noise))
    assert rel(ours.numpy(), np.asarray(theirs)) < F32_REL


# ---- text encoding ----------------------------------------------------------------------------------


def test_encode_text_slices_the_template_as_jax():
    """On a tiny Qwen2.5-VL trunk (f32 on both sides, one tokenizer): each
    prompt inside the captioning template, the template's prefix and suffix
    token spans sliced off the states and the mask, as the JAX family does;
    the payloads within ``F32_REL`` (masks equal), the collate has no mask."""
    jmodel, model = _pair(_tiny_values())
    spec = dataclasses.replace(jmodel.TEXT_ENCODER_CONFIGURATION[0], max_length=64)
    (jenc,) = jax_te.load_text_encoders([spec], tiny=True)
    jenc.module = JaxLLMEncoder(jenc.config, dtype=jnp.float32)  # read when the encode is traced
    variables = numpy_variables(jenc.module, jnp.zeros((1, 8), jnp.int32), seed=7)
    jenc.params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    port = bridge(variables, LLMEncoder(LLMEncoderConfig.tiny("qwen2"), dtype=torch.float32))
    jmodel.attach_text_encoders([jenc])
    model.attach_text_encoders([LLMTextEncoder(dataclasses.replace(model.TEXT_ENCODER_CONFIGURATION[0],
                                                                   max_length=64), port, jenc.tokenizer)])
    prompts = ["a lighthouse on a basalt cliff at dusk", "", "portrait of a cat"]
    ours, theirs = model.encode_text(prompts), jmodel.encode_text(prompts)
    n_prefix = int(jenc.tokenizer([PROMPT_PREFIX])["attention_mask"].sum())
    n_suffix = int(jenc.tokenizer([PROMPT_SUFFIX])["attention_mask"].sum())
    for prompt, a, b in zip(prompts, ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "t5_embeds"]
        assert a["t5_embeds"].shape == b["t5_embeds"].shape == (64 - n_prefix - n_suffix, 32)
        np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
        assert rel(a["t5_embeds"], b["t5_embeds"]) < F32_REL
    full = jenc.encode([PROMPT_PREFIX + prompts[0] + PROMPT_SUFFIX])
    np.testing.assert_array_equal(ours[0]["attention_mask"], np.asarray(full["attention_mask"])[0, n_prefix:-n_suffix])
    collated = model.collate_text_embeds(ours)
    assert sorted(collated) == sorted(jmodel.collate_text_embeds(theirs)) == ["t5_embeds"]


# ---- weight import and the key map ------------------------------------------------------------------


def _jax_params(jmodel, seed):
    jprepared = jmodel.prepare_batch(jax.random.PRNGKey(0), jmodel.example_batch(1, 64))
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0),
                                                                **jmodel.get_model_inputs(jprepared)))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's file of a seeded tiny transformer (two shards in
    ``transformer/``): its names and shapes are the port's layout (the bare
    ``time_embed.`` prefix), the port's tree bitwise the JAX
    ``load_longcat_image_params`` tree, the imported module bitwise the
    bridged JAX tree."""
    jmodel, model = _pair(_tiny_values())
    weights = export_longcat_image_to_checkpoint(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == longcat_image_checkpoint_shapes(model.arch)
    assert any(k.startswith("time_embed.timestep_embedder.") for k in weights)
    root = tmp_path / "longcat" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_longcat_params(jmodel, str(tmp_path / "longcat"))
    _assert_trees_bitwise(load_longcat_image_params(model, str(tmp_path / "longcat")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "longcat"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_key_map_and_adapter_file_match_jax(tmp_path):
    """The family's key map is Flux's, equal to the JAX family's; an adapter
    file written by the port round-trips through the port's loader bitwise
    and loads into the JAX template bitwise."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    assert _key_map_for(model) == JAX_KEY_MAPS["longcat_image"](jmodel) == flux_key_map(model.arch)
    source = _seeded_adapters(model, 4, scale=0.05)
    path = str(tmp_path / "adapter.safetensors")
    save_lora_safetensors(model, source, path)
    target = model.create_module()
    assert load_lora_safetensors(model, path, target) == []
    for (name, a), b in zip(tl.lora_parameters(target).items(), tl.lora_parameters(source).values()):
        assert torch.equal(a, b), name
    jprepared = jmodel.prepare_batch(jax.random.PRNGKey(0), jmodel.example_batch(1, 64))
    template = numpy_variables(jmodel.create_module(), **jmodel.get_model_inputs(jprepared), seed=1)["lora"]
    loaded = jax_load_lora(jmodel, path, template)
    loaded = loaded[0] if isinstance(loaded, tuple) else loaded
    for name, param in tl.lora_parameters(source).items():
        node = loaded
        for part in name.split("/"):
            node = node[part]
        assert np.array_equal(np.asarray(node), param.detach().numpy().T), name
