"""The torch port's LongCat-Video family against the JAX package, on the CPU.

The presets (the published 13.6B's per-block parameters against the JAX
``eval_shape``), ``longcat_rope`` bitwise and its interleaved rotation, both
softmax attentions through ``dot_product_attention`` against the JAX
module's dense f32 softmax (the T5 keys masked with -inf, right- and
left-padded), the DiT with its LoRA gradients against ``jax.grad`` (masked,
unmasked, remat) and in bf16; the family contract (sigma x 1000, the mask as
the key mask, ``encode_text``, the collate, the Wan-config video VAE at the
arch's channels); the import of the JAX exporter's file bitwise, the key map
and adapter files; a test per kept quirk.  Each JAX reference is computed
once (the ``jax_dit`` fixture).  The trainer's trajectory is in
test_torch_longcat_sana_trainer.py.  Every tolerance is stated where it is
checked.
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
from simpletuner_tpu.models.longcat_video import transformer as jlt
from simpletuner_tpu.models.longcat_video.model import LongcatVideo as JaxLongcatVideo
from simpletuner_tpu.models.weight_export import export_longcat_video_to_checkpoint
from simpletuner_tpu.models.weight_import import load_longcat_video_params as jax_load_params
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import longcat_video_checkpoint_shapes
from simpletuner_tpu_torch.models.longcat_video import LongcatVideo, LongCatVideoConfig, LongCatVideoTransformer
from simpletuner_tpu_torch.models.longcat_video.transformer import apply_longcat_rope, longcat_rope
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.video_vae import VideoVAEConfig
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_longcat_video_params, load_transformer_params
from simpletuner_tpu_torch.ops import dot_product_attention, key_mask_segments
from simpletuner_tpu_torch.training.lora import _key_map_for, longcat_video_key_map

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# f32 LoRA gradients (test_torch_sdxl.py: f32 gradients through a deep net
# are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
# bf16 on both sides: each rounds its own intermediates
BF16_REL = 2e-2
# torch's and XLA's f32 products differ by a few ulps of the operands' scale
ROPE_ATOL = 2.0 ** -21
# a right-padded (4 of 6 valid) and a left-padded (3 of 6) T5 caption
MASK = np.asarray([[1, 1, 1, 1, 0, 0], [0, 0, 0, 1, 1, 1]], np.int32)


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
    return {"model_family": "longcat_video", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxLongcatVideo(JaxTrainingConfig(values)), LongcatVideo(config_namespace(values))


SIGMAS = np.asarray([0.13, 0.91], np.float32)


def _inputs(cfg, masked=True, seed=0):
    """Two clips of 2 x 4 x 6 latents (2 x 2 x 3 = 12 tokens), ``SIGMAS`` at
    scheduler scale (x 1000 in f32, as ``get_model_inputs`` scales them), 6 T5
    tokens, the padded ``MASK``."""
    rng = np.random.default_rng(seed)
    inputs = {"latents": rng.standard_normal((2, 2, 4, 6, cfg.in_channels), dtype=np.float32),
              "timesteps": SIGMAS * np.float32(1000.0),
              "context": rng.standard_normal((2, 6, cfg.caption_channels), dtype=np.float32)}
    if masked:
        inputs["context_mask"] = MASK
    return inputs


def _variables(jmodule, cfg, seed):
    return numpy_variables(jmodule, **{k: jnp.asarray(v) for k, v in _inputs(cfg).items()}, seed=seed)


@pytest.fixture(scope="module")
def jax_dit():
    """The tiny JAX DiT's output and LoRA gradients of a seeded projection
    (f32, rank-4 adapters), computed once per input variant."""
    cache = {}

    def reference(variant):
        if variant not in cache:
            cfg = LongCatVideoConfig.tiny()
            inputs = _inputs(cfg, masked=variant == "masked", seed=4)
            jmodule = jlt.LongCatVideoTransformer(config=jlt.LongCatVideoConfig.tiny(), dtype=jnp.float32,
                                                  lora_rank=4)
            variables = _variables(jmodule, cfg, seed=5)
            weight = np.random.default_rng(6).standard_normal((2, 2, 4, 6, cfg.out_channels)).astype(np.float32)
            params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
            jargs = {k: jnp.asarray(v) for k, v in inputs.items()}

            def jax_loss(lora):
                out = jmodule.apply({"params": params, "lora": lora}, **jargs)
                return jnp.sum(out * weight), out

            (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
                jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
            flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
                    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
            cache[variant] = inputs, variables, weight, np.asarray(ref), flat
        return cache[variant]

    return reference


def test_presets_and_contract_match_jax():
    """The presets (tiny and published: 4096 wide, 32 heads of 128, FFN
    11,008, 282M a block; 13.58B in the checkpoint layout, the JAX
    ``eval_shape`` at 2 blocks giving the same per-block count), the
    family's constants, its ``t5-xxl`` spec at 512 tokens, example batch
    and video VAE as the JAX family's; a non-flow prediction type is
    refused."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "MODALITY", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR",
                 "HUGGINGFACE_PATHS", "DEFAULT_LORA_TARGET", "LATENT_CHANNEL_COUNT", "VAE_SCALING_FACTOR",
                 "VAE_SHIFT_FACTOR"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    for ours, theirs in ((LongCatVideoConfig.tiny(), jlt.LongCatVideoConfig.tiny()),
                         (LongCatVideoConfig(), jlt.LongCatVideoConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert (ours.head_dim, ours.ffn_hidden) == (theirs.head_dim, theirs.ffn_hidden)
    full = LongcatVideo(config_namespace({**_tiny_values(), "model_arch_preset": None})).arch
    assert (full.head_dim, full.ffn_hidden) == (128, 11008)
    shapes = longcat_video_checkpoint_shapes(full)
    per_block = sum(math.prod(s) for k, s in shapes.items() if k.startswith("blocks.0."))
    assert per_block == 282_132_992 and sum(math.prod(s) for s in shapes.values()) == 13_581_071_424
    two = dataclasses.replace(jlt.LongCatVideoConfig(), depth=2)
    example = {"latents": jnp.zeros((1, 1, 2, 2, 16)), "timesteps": jnp.zeros((1,)),
               "context": jnp.zeros((1, 3, 4096))}
    tree = jax.eval_shape(lambda: jlt.LongCatVideoTransformer(config=two).init(jax.random.PRNGKey(0), **example))
    ours_two = longcat_video_checkpoint_shapes(dataclasses.replace(full, depth=2))
    assert sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree)) == \
        sum(math.prod(s) for s in ours_two.values())
    assert "longcat_video" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), LongcatVideo)
    with pytest.raises(ValueError, match="flow-matching"):
        LongcatVideo(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2).items()}
    assert model.latent_channels == jmodel.latent_channels == 4
    for values in (_tiny_values(), {**_tiny_values(), "model_arch_preset": None}):
        ours, theirs = LongcatVideo(config_namespace(values)), JaxLongcatVideo(JaxTrainingConfig(values))
        assert dataclasses.asdict(ours.video_vae_config()) == dataclasses.asdict(theirs.video_vae_config())
    assert model.video_vae_config() == dataclasses.replace(VideoVAEConfig.tiny(), latent_channels=4)


def test_rope_tables_and_rotation_match_jax():
    """``longcat_rope`` bitwise the JAX tables at the published head dim 128
    (axes 44 / 42 / 42) over a 3 x 4 x 5 grid and at the tiny 12; the
    interleaved-pair rotation within ``ROPE_ATOL`` times the input scale;
    the rotate-half convention gives another result."""
    for cfg, jcfg in ((LongCatVideoConfig.tiny(), jlt.LongCatVideoConfig.tiny()),
                      (LongCatVideoConfig(), jlt.LongCatVideoConfig())):
        cos, sin = longcat_rope(cfg, (3, 4, 5))
        jcos, jsin = jlt.longcat_rope(jcfg, (3, 4, 5))
        assert np.array_equal(cos, np.asarray(jcos)) and np.array_equal(sin, np.asarray(jsin))
    x = np.random.default_rng(1).standard_normal((2, 60, 3, 128)).astype(np.float32)
    ours = apply_longcat_rope(t(x), t(cos), t(sin)).numpy()
    ref = np.asarray(jlt._apply_rope(jnp.asarray(x), jcos, jsin))
    assert np.abs(ours - ref).max() <= ROPE_ATOL * np.abs(x).max() * 2
    half = np.concatenate([-x[..., 64:], x[..., :64]], -1)
    assert rel(x * np.asarray(cos)[None, :, None] + half * np.asarray(sin)[None, :, None], ref) > 1e-2


@pytest.mark.parametrize("masked", [True, False])
def test_attentions_through_the_op_match_the_dense_softmax(masked):
    """The self-attention (12 tokens, unmasked) and the cross-attention (12
    queries against 6 T5 keys, ``MASK``: right- and left-padded) through
    ``dot_product_attention`` against the JAX module's dense f32 softmax
    (-inf at masked keys): within ``F32_REL``."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 12, 2, 16)).astype(np.float32) for _ in range(3))
    ck, cv = (rng.standard_normal((2, 6, 2, 16)).astype(np.float32) for _ in range(2))

    def dense(qq, kk, vv, mask=None):
        logits = jnp.einsum("bshd,bthd->bhst", qq, kk) / math.sqrt(16)
        if mask is not None:
            logits = jnp.where(jnp.asarray(mask, bool)[:, None, None, :], logits, -jnp.inf)
        return np.asarray(jnp.einsum("bhst,bthd->bshd", jax.nn.softmax(logits, -1), vv))

    mask = MASK if masked else None
    key_ids = key_mask_segments(None if mask is None else t(mask))
    q_ids = None if key_ids is None else torch.ones((2, 12), dtype=torch.int32)
    assert rel(dot_product_attention(t(q), t(k), t(v)).numpy(), dense(q, k, v)) < F32_REL
    cross = dot_product_attention(t(q), t(ck), t(cv), q_segment_ids=q_ids, kv_segment_ids=key_ids).numpy()
    assert rel(cross, dense(q, ck, cv, mask)) < F32_REL


@pytest.mark.parametrize("variant,remat", [("masked", False), ("masked", True), ("unmasked", False)])
def test_transformer_forward_and_lora_grads_match_jax(jax_dit, variant, remat):
    """The tiny DiT (f32, rank-4 adapters) with the padded ``MASK`` (and
    under remat) or without a mask: the output within ``F32_REL`` of the JAX
    module's, the LoRA gradients of a seeded projection of it against
    ``jax.grad`` within ``GRAD_REL``, per adapter."""
    inputs, variables, weight, ref, flat = jax_dit(variant)
    port = bridge(variables, LongCatVideoTransformer(LongCatVideoConfig.tiny(), dtype=torch.float32, lora_rank=4,
                                                     remat=remat))
    adapters = tl.freeze_base(port)
    out = port(**{k: t(v) for k, v in inputs.items()})
    assert tuple(out.shape) == ref.shape and rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    assert sorted(flat) == sorted(adapters) and "block_1/ffn_w2/lora_B" in flat and "final_linear/lora_A" in flat
    assert not any(name.startswith(("t_in", "y_in", "final_adaLN")) or "/adaLN/" in name for name in flat)
    for path, param in adapters.items():
        assert rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_transformer_bf16_matches_jax():
    """The tiny DiT in bf16 (f32 adapters, norms, time MLP and AdaLN), with
    ``MASK``, against the JAX module in bf16: within ``BF16_REL``."""
    cfg = LongCatVideoConfig.tiny()
    inputs = _inputs(cfg, seed=7)
    jmodule = jlt.LongCatVideoTransformer(config=jlt.LongCatVideoConfig.tiny(), dtype=jnp.bfloat16, lora_rank=4)
    variables = _variables(jmodule, cfg, seed=8)
    port = bridge(variables, LongCatVideoTransformer(cfg, dtype=torch.bfloat16, lora_rank=4))
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                            **{k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}).numpy()
    assert out.dtype == ref.dtype == np.float32 and rel(out, ref) < BF16_REL


class _Encoder:
    """A T5 encoder's ``encode`` output, fixed."""

    def __init__(self, states, mask):
        self.states, self.mask = states, mask

    def encode(self, prompts):
        n = len(prompts)
        return {"last_hidden_state": self.states[:n], "attention_mask": self.mask[:n]}


def test_family_inputs_prediction_and_text_match_jax(jax_dit):
    """``get_model_inputs`` (sigma x 1000, the mask as ``context_mask``; none
    without one) equal to the JAX family's; ``model_predict`` within
    ``F32_REL`` of the JAX module on those inputs (the ``jax_dit`` output);
    ``encode_text`` (the
    whole T5 state and the mask), the collate (the mask as
    ``text_attention_mask``) and ``inference_conditioning`` equal to the JAX
    family's."""
    jmodel, model = _pair(_tiny_values())
    inputs, variables, _, ref, _ = jax_dit("masked")
    prepared = {"noisy_latents": inputs["latents"], "timesteps": SIGMAS, "text_embeds": inputs["context"],
                "text_attention_mask": MASK}
    for keep in (True, False):
        batch = prepared if keep else {k: v for k, v in prepared.items() if k != "text_attention_mask"}
        ours = model.get_model_inputs({k: t(v) for k, v in batch.items()})
        theirs = jmodel.get_model_inputs({k: jnp.asarray(v) for k, v in batch.items()})
        assert sorted(ours) == sorted(theirs) == sorted(["latents", "timesteps", "context"] +
                                                        (["context_mask"] if keep else []))
        for key in ours:
            np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    module = bridge(variables, model.create_module())
    with torch.no_grad():
        out = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
    assert out.shape == ref.shape and rel(out, ref) < F32_REL
    rng = np.random.default_rng(9)
    states = rng.standard_normal((3, 7, 32)).astype(np.float32)
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
    cond = model.inference_conditioning({k: t(v) for k, v in collated.items()})
    assert sorted(cond) == sorted(jmodel.inference_conditioning(jcollated)) == ["text_attention_mask", "text_embeds"]
    with pytest.raises(NotImplementedError, match="CREPA"):
        model.model_predict_with_intermediates(module, {k: t(v) for k, v in prepared.items()})


def test_caption_without_valid_tokens_is_nan_in_jax_and_zero_attention_here(jax_dit):
    """Quirk kept (ROADMAP Queue 3): a caption whose T5 mask is all 0 makes
    every cross-attention row a softmax over -inf in JAX (NaN in the whole
    sample's output), while the op gives those rows 0 (the cross residual
    adds the projection's bias only): the port's sample is finite; the other
    sample agrees within ``F32_REL``."""
    inputs, variables, _, _, _ = jax_dit("masked")
    inputs = {**inputs, "context_mask": np.asarray([[0] * 6, [1] * 6], np.int32)}
    jmodule = jlt.LongCatVideoTransformer(config=jlt.LongCatVideoConfig.tiny(), dtype=jnp.float32, lora_rank=4)
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                            **{k: jnp.asarray(v) for k, v in inputs.items()}))
    port = bridge(variables, LongCatVideoTransformer(LongCatVideoConfig.tiny(), dtype=torch.float32, lora_rank=4))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}).numpy()
    assert np.isnan(ref[0]).all() and np.isfinite(out[0]).all()
    assert rel(out[1], ref[1]) < F32_REL


def test_ffn_residual_base_is_the_modulated_tensor():
    """Quirk kept: the block's FFN adds its gated output to the MODULATED
    tensor (``x = modulate(x); x = x + gate * ffn(x)``), as the JAX block
    does: with the FFN's output projection zeroed, a block returns the
    modulated cross-attention output, not that output itself."""
    from simpletuner_tpu_torch.models.layers import layer_norm
    from simpletuner_tpu_torch.models.longcat_video.transformer import LongCatBlock

    cfg = LongCatVideoConfig.tiny()
    block = tl.init_parameters(LongCatBlock(cfg, torch.float32), torch.Generator().manual_seed(3))
    with torch.no_grad():
        block.ffn_w2.weight.zero_()
        block.adaLN.weight.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    x, ctx = t(rng.standard_normal((1, 12, 24)).astype(np.float32)), t(rng.standard_normal((1, 6, 24)).astype(
        np.float32))
    t_frames = t(rng.standard_normal((1, 2, 16)).astype(np.float32))
    cos, sin = (t(a) for a in longcat_rope(cfg, (2, 2, 3)))
    with torch.no_grad():
        out = block(x, ctx, t_frames, cos, sin, None, None)
        mod = block.adaLN(torch.nn.functional.silu(t_frames)).reshape(1, 2, 1, 6, 24)
        shift, scale = mod[..., 3, :], mod[..., 4, :]
        # out = modulate(x_cross) where x_cross is what the FFN saw; undo the modulation
        assert not torch.allclose(out, x)
        recovered = (out.reshape(1, 2, 6, 24) - shift) / (scale + 1.0)
        assert torch.allclose(layer_norm(recovered, torch.float32), recovered, atol=1e-4)


def _jax_params(jmodel, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(jmodel.arch).items()}
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0), **example))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's file of a seeded tiny transformer (two shards): its
    names and shapes are the port's layout, the port's tree bitwise the JAX
    ``load_longcat_video_params`` tree (the 5-D ``x_embedder`` kernel too),
    the imported module bitwise the bridged JAX tree."""
    jmodel, model = _pair(_tiny_values())
    weights = export_longcat_video_to_checkpoint(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == longcat_video_checkpoint_shapes(model.arch)
    root = tmp_path / "longcat_video" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_params(jmodel, str(tmp_path / "longcat_video"))
    _assert_trees_bitwise(load_longcat_video_params(model, str(tmp_path / "longcat_video")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "longcat_video"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name
    assert torch.equal(ours.x_embedder.weight, torch.from_numpy(weights["x_embedder.proj.weight"]))


def test_key_map_default_targets_and_adapter_file_match_jax(tmp_path):
    """``longcat_video_key_map`` equals the JAX map (the FFN included);
    quirk kept (ROADMAP Queue 3): ``DEFAULT_LORA_TARGET`` leaves the FFN out
    but no code reads it, so without ``lora_target_modules`` the FFN is
    adapted in both packages; an adapter file written by the port
    round-trips bitwise and loads into the JAX template bitwise."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    assert _key_map_for(model) == JAX_KEY_MAPS["longcat_video"](jmodel) == longcat_video_key_map(model.arch)
    assert "block_0/ffn_w1" in _key_map_for(model) and not any("ffn" in n for n in model.DEFAULT_LORA_TARGET)
    assert model._build_lora_target_predicate() is None
    assert "block_0/ffn_w1/lora_A" in tl.lora_parameters(model.create_module())
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
