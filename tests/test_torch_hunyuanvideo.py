"""The torch port's HunyuanVideo 1.5 family against the JAX package, on the CPU.

The rope tables, the token refiner with padded captions (the pads' rows of
the op exactly 0), one dual-stream block, the transformer with its LoRA
gradients (Qwen only; with ByT5; with zero and with real image embeds;
remat), the family contract (the 65-channel packing for T2V and I2V),
``encode_text`` / collate with both masks, the import of the JAX
exporter's output, the key map and the quirks kept from the JAX family:
the same seeded numpy weights and inputs go through both packages.  The
trainer's trajectory is in test_torch_hunyuanvideo_trainer.py.  Every
tolerance is stated where it is checked.  At the tiny size the head dim is
32; the published D = 128 shapes are held to the plain version on the card
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
from simpletuner_tpu.models.hunyuanvideo import transformer as jax_hy
from simpletuner_tpu.models.hunyuanvideo.model import HunyuanVideo as JaxHunyuanVideo
from simpletuner_tpu.models.weight_export import export_hunyuanvideo_to_diffusers
from simpletuner_tpu.models.weight_import import load_hunyuanvideo_params as jax_load_hunyuanvideo_params
from simpletuner_tpu.training.lora import hunyuanvideo_key_map as jax_hunyuanvideo_key_map

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import hunyuanvideo_checkpoint_shapes
from simpletuner_tpu_torch.models.hunyuanvideo import HunyuanVideo, HunyuanVideo15Config, HunyuanVideo15Transformer
from simpletuner_tpu_torch.models.hunyuanvideo import transformer as hy
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_hunyuanvideo_params, load_transformer_params
from simpletuner_tpu_torch.training.lora import hunyuanvideo_key_map

from test_torch_kandinsky5 import _StandIn
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


def _tiny_values(**extra):
    return {"model_family": "hunyuanvideo", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxHunyuanVideo(JaxTrainingConfig(values)), HunyuanVideo(config_namespace(values))


def _mask(lengths, length):
    return (np.arange(length)[None] < np.asarray(lengths)[:, None]).astype(np.int32)


def test_presets_and_rope_match_jax():
    """The configs as the JAX presets (8.33B at the published size), and the
    rope's cos / sin tables (theta 256, float64 on the host, rounded to f32)
    bitwise the JAX ``hunyuan_rope`` at the tiny and the published axes."""
    for name in ("tiny", None):
        ours = HunyuanVideo15Config.tiny() if name else HunyuanVideo15Config()
        theirs = jax_hy.HunyuanVideo15Config.tiny() if name else jax_hy.HunyuanVideo15Config()
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs) and ours.hidden_size == theirs.hidden_size
    cfg = HunyuanVideo15Config()
    assert (cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.depth, cfg.refiner_depth, cfg.in_channels) == \
        (2048, 16, 128, 54, 2, 65)
    shapes = hunyuanvideo_checkpoint_shapes(cfg)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 8_326_608_160  # the JAX preset: 8.33B
    for config, jconfig in ((cfg, jax_hy.HunyuanVideo15Config()),
                            (HunyuanVideo15Config.tiny(), jax_hy.HunyuanVideo15Config.tiny())):
        ours, theirs = hy.hunyuan_rope(config, 3, 4, 5), jax_hy.hunyuan_rope(jconfig, 3, 4, 5)
        for a, b in zip(ours, theirs):
            assert a.shape == b.shape == (60, config.head_dim) and np.array_equal(a, b)
    x = np.random.default_rng(0).standard_normal((2, 60, 2, 32)).astype(np.float32)
    cos, sin = hy.hunyuan_rope(HunyuanVideo15Config.tiny(), 3, 4, 5)
    assert rel(hy._apply_rope_interleaved(t(x), t(cos), t(sin)).numpy(),
               np.asarray(jax_hy._apply_rope_interleaved(jnp.asarray(x), cos, sin))) < F32_REL


def test_refiner_with_padded_captions_matches_jax(monkeypatch):
    """The token refiner (f32) on captions with 9 and 3 of 9 tokens valid:
    the masked mean pool and the pads at segment -1, within ``F32_REL`` of
    the JAX module; the op's rows of the pads come out exactly 0 (the port's
    masked-row rule) and changing a pad's features leaves the valid rows
    unchanged."""
    cfg = HunyuanVideo15Config.tiny()
    rng = np.random.default_rng(1)
    text = rng.standard_normal((2, 9, cfg.text_dim)).astype(np.float32)
    timesteps = np.asarray([130.0, 910.0], np.float32)
    mask = _mask([9, 3], 9)
    jmodule = jax_hy.TokenRefiner(jax_hy.HunyuanVideo15Config.tiny(), dtype=jnp.float32)
    variables = numpy_variables(jmodule, *map(jnp.asarray, (text, timesteps, mask)), seed=2)
    port = bridge(variables, hy.TokenRefiner(cfg, dtype=torch.float32))
    rows = []
    original = hy.dot_product_attention

    def recording(q, k, v, **kw):
        out = original(q, k, v, **kw)
        rows.append((out.clone(), kw.get("q_segment_ids")))
        return out

    monkeypatch.setattr(hy, "dot_product_attention", recording)
    apply = jax.jit(jmodule.apply)
    padded = text.copy()
    padded[1, 3:] = 50.0
    outs = []
    for ctx in (text, padded):
        with torch.no_grad():
            ours = port(t(ctx), t(timesteps), t(mask)).numpy()
        theirs = np.asarray(apply(jax.tree_util.tree_map(jnp.asarray, variables), *map(jnp.asarray, (ctx, timesteps,
                                                                                                      mask))))
        assert ours.shape == theirs.shape == (2, 9, cfg.hidden_size) and rel(ours, theirs) < F32_REL
        outs.append(ours)
    assert np.array_equal(outs[0][:, :3], outs[1][:, :3]) and np.array_equal(outs[0][0], outs[1][0])
    out, seg = rows[0]
    np.testing.assert_array_equal(seg.numpy(), np.where(mask > 0, 0, -1))
    assert torch.count_nonzero(out[1, 3:]) == 0 and torch.count_nonzero(out[1, :3]) > 0


def test_block_matches_jax():
    """One dual-stream block (f32, rank-4 adapters) over 12 video and 7
    conditioning tokens, 2 of them pads at -1: within ``F32_REL``."""
    cfg = HunyuanVideo15Config.tiny()
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, 12, cfg.hidden_size)).astype(np.float32)
    txt = rng.standard_normal((2, 7, cfg.hidden_size)).astype(np.float32)
    temb = rng.standard_normal((2, cfg.hidden_size)).astype(np.float32)
    cos, sin = hy.hunyuan_rope(cfg, 1, 3, 4)
    seg = np.concatenate([np.zeros((2, 12), np.int32), np.where(_mask([7, 5], 7) > 0, 0, -1)], 1).astype(np.int32)
    jblock = jax_hy.HunyuanBlock(jax_hy.HunyuanVideo15Config.tiny(), dtype=jnp.float32, lora_rank=4)
    variables = numpy_variables(jblock, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(temb), (cos, sin),
                                jnp.asarray(seg), seed=4)
    port = bridge(variables, hy.HunyuanBlock(cfg, dtype=torch.float32, lora_rank=4))
    ref_img, ref_txt = jblock.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(img), jnp.asarray(txt),
                                    jnp.asarray(temb), (cos, sin), jnp.asarray(seg))
    with torch.no_grad():
        out_img, out_txt = port(t(img), t(txt), t(temb), t(cos), t(sin), t(seg))
    assert rel(out_img.numpy(), ref_img) < F32_REL and rel(out_txt.numpy(), ref_txt) < F32_REL


def _inputs(cfg, seed=0, frames=2, height=4, width=6):
    rng = np.random.default_rng(seed)
    return {
        "latents": rng.standard_normal((2, frames, height, width, cfg.in_channels)).astype(np.float32),
        "timesteps": np.asarray([0.13, 0.91], np.float32),
        "context": rng.standard_normal((2, 9, cfg.text_dim)).astype(np.float32),
        "context_mask": _mask([9, 4], 9),
        "context_2": rng.standard_normal((2, 5, cfg.text2_dim)).astype(np.float32),
        "context_2_mask": _mask([2, 5], 5),
        "image_embeds": rng.standard_normal((2, 3, cfg.image_embed_dim)).astype(np.float32),
    }


VARIANTS = {
    "qwen_only": ("latents", "timesteps", "context", "context_mask"),
    "byt5": ("latents", "timesteps", "context", "context_mask", "context_2", "context_2_mask"),
    "t2v_image_zeros": ("latents", "timesteps", "context", "context_mask", "context_2", "context_2_mask",
                        "image_embeds"),
    "i2v_image_embeds": ("latents", "timesteps", "context", "context_mask", "context_2", "context_2_mask",
                         "image_embeds"),
    "remat": ("latents", "timesteps", "context", "context_mask", "context_2", "context_2_mask"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny DiT (f32, rank-4 adapters) on the same seeded weights, with
    the Qwen stream alone, with ByT5, with all-zero (t2v) and with real image
    embeds, and under remat: the output within ``F32_REL``; the LoRA
    gradients of a seeded projection of it against ``jax.grad`` within
    ``GRAD_REL``, per adapter (the refiner and the projections carry none)."""
    cfg = HunyuanVideo15Config.tiny()
    remat = variant == "remat"
    inputs = {k: v for k, v in _inputs(cfg).items() if k in VARIANTS[variant]}
    if variant == "t2v_image_zeros":
        inputs["image_embeds"] = np.zeros_like(inputs["image_embeds"])
    full = {k: jnp.asarray(v) for k, v in _inputs(cfg).items()}
    jmodule = jax_hy.HunyuanVideo15Transformer(config=jax_hy.HunyuanVideo15Config.tiny(), dtype=jnp.float32,
                                               lora_rank=4, remat=remat)
    variables = numpy_variables(jmodule, **full, seed=1)
    port = bridge(variables, HunyuanVideo15Transformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jinputs = {k: jnp.asarray(v) for k, v in inputs.items()}
    weight = np.random.default_rng(9).standard_normal(inputs["latents"].shape[:-1] + (cfg.out_channels,)) \
        .astype(np.float32)

    def jax_loss(lora):
        out = jmodule.apply({"params": params, "lora": lora}, **jinputs)
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(port)
    out = port(**{k: t(v) for k, v in inputs.items()})
    assert tuple(out.shape) == ref.shape == weight.shape and rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and "block_1/txt_mlp_out/lora_B" in flat and "patch_in/lora_A" in flat
    assert not any(p.startswith(("refiner", "byt5", "img_embed", "final", "time_in")) for p in flat)
    for path, param in adapters.items():
        if not flat[path].any():  # the last block's text-stream output is never read: zero on both sides
            assert path.startswith(f"block_{cfg.depth - 1}/txt_") and (param.grad is None or not param.grad.any()), path
            continue
        assert param.grad is not None and rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


# ---- the family contract -----------------------------------------------------------------------------


def test_contract_and_the_65_channel_packing():
    """Constants, specs, arch and example batch as the JAX family's; with
    ``in_channels`` = 2 C + 1 the input packs zeros and a zero mask for T2V
    (so the published 65 channels go in for t2v too) and the clean first
    frame and a frame-0 mask for I2V, bitwise as the JAX family;
    ``model_predict`` within ``F32_REL``; the SR upsampler and the
    intermediates tap are refused by name."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "MODALITY", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR",
                 "HUGGINGFACE_PATHS", "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR",
                 "LATENT_CHANNEL_COUNT"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch) and model.is_flow
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 64).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 64).items()}
    assert "hunyuanvideo" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), HunyuanVideo)
    with pytest.raises(ValueError, match="flow-matching"):
        HunyuanVideo(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    with pytest.raises(NotImplementedError, match="SR latent upsampler"):
        HunyuanVideo.load_sr_upsampler("720p", "/nope")
    with pytest.raises(NotImplementedError, match="item 4h"):
        model.model_predict_with_intermediates(None, {})

    arch = dataclasses.replace(HunyuanVideo15Config.tiny(), in_channels=17)
    rng = np.random.default_rng(6)
    prepared = {"noisy_latents": rng.standard_normal((2, 3, 4, 6, 8)).astype(np.float32),
                "latents": rng.standard_normal((2, 3, 4, 6, 8)).astype(np.float32),
                "timesteps": np.asarray([0.3, 0.8], np.float32),
                "text_embeds": rng.standard_normal((2, 9, 32)).astype(np.float32), "text_mask": _mask([9, 4], 9),
                "text_embeds_2": rng.standard_normal((2, 5, 24)).astype(np.float32), "text_mask_2": _mask([2, 5], 5)}
    for flavour in ("t2v-480p", "i2v-480p"):
        jmodel, model = _pair(_tiny_values(model_flavour=flavour))
        jmodel.arch, model.arch = jax_hy.HunyuanVideo15Config(**dataclasses.asdict(arch)), arch
        assert model.is_i2v == jmodel.is_i2v == (flavour == "i2v-480p")
        ours_in = model.get_model_inputs({k: t(v) for k, v in prepared.items()})
        theirs_in = jmodel.get_model_inputs(jax.tree_util.tree_map(jnp.asarray, prepared))
        assert sorted(ours_in) == sorted(theirs_in) == ["context", "context_2", "context_2_mask", "context_mask",
                                                        "latents", "timesteps"]
        packed = ours_in["latents"].numpy()
        assert packed.shape == (2, 3, 4, 6, 17) and np.array_equal(packed, np.asarray(theirs_in["latents"]))
        if flavour == "t2v-480p":
            assert not packed[..., 8:].any()
        else:
            assert np.array_equal(packed[:, 0, ..., 8:16], prepared["latents"][:, 0]) and \
                packed[:, 0, ..., 16].all() and not packed[:, 1:, ..., 8:].any()
        jmodule = jmodel.create_module()
        variables = numpy_variables(jmodule, **{k: jnp.asarray(v) for k, v in theirs_in.items()},
                                    image_embeds=jnp.zeros((2, 3, arch.image_embed_dim)), seed=7)
        module = bridge(variables, model.create_module())
        with torch.no_grad():
            ours = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
        theirs = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                          jax.tree_util.tree_map(jnp.asarray, prepared)))
        assert ours.shape == prepared["noisy_latents"].shape and rel(ours, theirs) < F32_REL


def test_encode_text_and_collate_keep_both_masks_as_jax():
    """``encode_text`` keeps Qwen2.5-VL's states and mask and ByT5's states
    and mask per prompt, as the JAX family; the collate stacks both masks
    (``text_mask``, ``text_mask_2``); the conditioning a render passes keeps
    them, so renders and training are masked alike; the image-embed stream
    is in ``example_batch`` but in no collated batch (quirk kept, ROADMAP
    Queue 3)."""
    jmodel, model = _pair(_tiny_values())
    rng = np.random.default_rng(3)
    qwen = {"last_hidden_state": rng.standard_normal((3, 9, 32)).astype(np.float32),
            "attention_mask": _mask([9, 2, 5], 9)}
    byt5 = {"last_hidden_state": rng.standard_normal((3, 6, 24)).astype(np.float32),
            "attention_mask": _mask([1, 6, 3], 6)}
    for m in (jmodel, model):
        m.attach_text_encoders([_StandIn(qwen), _StandIn(byt5)])
    ours, theirs = model.encode_text(["a", "b", "c"]), jmodel.encode_text(["a", "b", "c"])
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "text_embeds", "text_embeds_2", "text_mask",
                                          "text_mask_2"]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    collated, jcollated = model.collate_text_embeds(ours), jmodel.collate_text_embeds(theirs)
    assert sorted(collated) == sorted(jcollated) == ["text_embeds", "text_embeds_2", "text_mask", "text_mask_2"]
    for key in collated:
        np.testing.assert_array_equal(collated[key], jcollated[key])
    assert "image_embeds" in model.example_batch() and "image_embeds" not in collated
    cond = model.inference_conditioning({"latents": torch.zeros(1), **{k: t(v[:1]) for k, v in collated.items()}})
    assert sorted(model.get_model_inputs({"noisy_latents": torch.zeros(1, 1, 2, 2, 8), "timesteps": torch.zeros(1),
                                          **cond})) == \
        ["context", "context_2", "context_2_mask", "context_mask", "latents", "timesteps"]


def test_vae_scaling_tokens_and_byt5_as_in_jax(tmp_path):
    """Quirks kept (ROADMAP Queue 3): the video VAE applies no scale, so the
    video cache holds unscaled latents, while a render divides the sampled
    latents by ``VAE_SCALING_FACTOR`` (0.476986) before the decode; the JAX
    preset's video VAE is the 8x Wan config at 32 latents with the (1, 1, 1)
    patch, about 4x the tokens of the published 16x VAE (a 480 x 848 x 121
    clip: 31 x 60 x 106 = 197,160 tokens); ByT5 is read through the
    ``t5-xxl`` spec from ``text_encoder_2`` with no tokenizer subfolder (the
    T5 builder reads ``tokenizer_2`` with ``T5TokenizerFast``)."""
    from simpletuner_tpu_torch.models.video_vae import VideoVAEConfig
    from simpletuner_tpu_torch.training.validation import Validation

    jmodel, model = _pair({**_tiny_values(), "model_arch_preset": None})
    vae = model.video_vae_config()
    assert vae == dataclasses.replace(VideoVAEConfig.wan(), latent_channels=32) and model.arch.patch == (1, 1, 1)
    assert dataclasses.asdict(vae) == dataclasses.asdict(jmodel.video_vae_config())
    assert vae.spatial_factor == 8 and (121 - 1) // vae.temporal_factor + 1 == 31
    byt5 = model.TEXT_ENCODER_CONFIGURATION[1]
    assert (byt5.family, byt5.subfolder, byt5.tokenizer_subfolder, byt5.max_length) == \
        ("t5-xxl", "text_encoder_2", None, 77)

    values = _tiny_values(model_type="full", validation_resolution=16, validation_num_video_frames=5,
                          validation_num_inference_steps=2, validation_guidance=1.0, validation_seed=3)
    _, model = _pair(values)
    module = tl.init_parameters(model.create_module(), torch.Generator().manual_seed(0))
    validation = Validation(model, config_namespace(values), device="cpu")
    payload = {"text_embeds": np.ones((9, 32), np.float32), "text_mask": _mask([4], 9)[0],
               "text_embeds_2": np.ones((5, 24), np.float32), "text_mask_2": _mask([5], 5)[0]}
    latents = validation._render_single(module, payload, 0)
    seen = []
    validation.decode_fn = lambda z: seen.append(z.clone()) or torch.zeros(z.shape[:-1] + (3,))
    validation._render_single(module, payload, 0)
    assert rel(seen[0][0].numpy(), latents / 0.476986) < 1e-6


# ---- weight import and the key map ------------------------------------------------------------------


def _jax_params(jmodel, seed):
    arch = jmodel.arch
    full = {k: jnp.zeros_like(jnp.asarray(v[:1])) for k, v in _inputs(arch).items()}
    shapes = jax.eval_shape(lambda: jax_hy.HunyuanVideo15Transformer(config=arch).init(jax.random.PRNGKey(0), **full))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's diffusers file of a seeded tiny transformer (two
    shards in ``transformer/``): its names and shapes are
    ``hunyuanvideo_checkpoint_shapes``, the port's tree is bitwise the JAX
    ``load_hunyuanvideo_params`` tree, and the imported module bitwise the
    bridged JAX tree."""
    jmodel, model = _pair(_tiny_values())
    weights = export_hunyuanvideo_to_diffusers(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == hunyuanvideo_checkpoint_shapes(model.arch)
    root = tmp_path / "hy" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_hunyuanvideo_params(jmodel, str(tmp_path / "hy"))
    _assert_trees_bitwise(load_hunyuanvideo_params(model, str(tmp_path / "hy")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "hy"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_key_map_and_targets_match_jax():
    """``hunyuanvideo_key_map`` equal to the JAX map; without
    ``lora_target_modules`` every adapter-carrying linear is adapted (no
    code reads ``DEFAULT_LORA_TARGET``), and its names as targets adapt the
    four video attention projections of every block."""
    jmodel, model = _pair(_tiny_values())
    assert hunyuanvideo_key_map(model.arch) == jax_hunyuanvideo_key_map(jmodel.arch)
    every = {name.rsplit("/", 1)[0] for name in tl.lora_parameters(model.create_module())}
    assert {"patch_in", "block_0/txt_mlp_in", "block_1/img_attn_q"} <= every
    _, named = _pair(_tiny_values(lora_target_modules=list(HunyuanVideo.DEFAULT_LORA_TARGET)))
    adapted = {name.rsplit("/", 2)[-2] for name in tl.lora_parameters(named.create_module())}
    assert adapted == {"img_attn_q", "img_attn_k", "img_attn_v", "img_attn_proj"}


def test_tiny_preset_does_not_fit_its_tiny_vae_and_byt5_as_in_jax():
    """Quirk kept (ROADMAP Queue 3): the tiny arch takes 8 latent channels
    and 24-wide ByT5 states, while the tiny preset's video VAE gives 4
    latents and the T5 builder's tiny encoder (ByT5's stand-in) is 32 wide,
    in both packages; the trainer test gives both packages' tiny VAE 8
    latents and the tiny arch a ByT5 width of 32
    (test_torch_hunyuanvideo_trainer.py)."""
    from simpletuner_tpu.models.video_vae import VideoVAEConfig as JaxVideoVAEConfig

    from simpletuner_tpu_torch.models.t5 import T5Config
    from simpletuner_tpu_torch.models.video_vae import VideoVAEConfig

    jmodel, model = _pair(_tiny_values())
    assert model.arch.in_channels == jmodel.arch.in_channels == 8 and model.latent_channels == 8
    assert model.video_vae_config() == VideoVAEConfig.tiny() and model.video_vae_config().latent_channels == 4
    assert jmodel.video_vae_config() == JaxVideoVAEConfig.tiny() and jmodel.video_vae_config().latent_channels == 4
    assert model.arch.text2_dim == jmodel.arch.text2_dim == 24 and T5Config.tiny().d_model == 32
