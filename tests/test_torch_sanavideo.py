"""The torch port's Sana-Video family against the JAX package, on the CPU.

The presets (the published 2B's parameters against the JAX ``eval_shape``),
``sanavideo_rope`` bitwise at the published head dim 112 and at 16 (where
the built and split sizes differ, as at every published head dim; the tiny
preset's 12 makes them coincide) with its ``cos[0::2]`` / ``sin[1::2]``
rotation, the block (the ReLU linear attention with RoPE after the ReLU and
the unrotated normaliser) in f32 and bf16, GLUMBTempConv, the cross-attention
through ``dot_product_attention`` with key ids against the JAX dense softmax
with its -10000 key bias (right- and left-padded captions), the DiT at head
dim 16 with its LoRA gradients against ``jax.grad`` (masked, unmasked, remat)
and in bf16; the family contract; the import of the JAX exporter's file
bitwise and the unpatchify's (pt, ph, pw, C) split, the key map and adapter
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

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.sanavideo import transformer as jsv
from simpletuner_tpu.models.sanavideo.model import SanaVideo as JaxSanaVideo
from simpletuner_tpu.models.weight_export import export_sanavideo_to_checkpoint
from simpletuner_tpu.models.weight_import import load_sanavideo_params as jax_load_params
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import sanavideo_checkpoint_shapes
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.sanavideo import SanaVideo, SanaVideoConfig, SanaVideoTransformer
from simpletuner_tpu_torch.models.sanavideo.transformer import (
    GLUMBTempConv, SanaVideoBlock, apply_sv_rope, sanavideo_rope,
)
from simpletuner_tpu_torch.models.video_vae import VideoVAEConfig
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_sanavideo_params, load_transformer_params
from simpletuner_tpu_torch.ops import dot_product_attention, key_mask_segments
from simpletuner_tpu_torch.training.lora import _key_map_for, sanavideo_key_map

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
# the JAX softmax over logits shifted by -10000 against the unshifted one:
# f32 holds the shifted logits to 2^-10
SHIFTED_REL = 1e-3
SIGMAS = np.asarray([0.13, 0.91], np.float32)
# a right-padded (4 of 6 valid) and a left-padded (3 of 6) Gemma caption
MASK = np.asarray([[1, 1, 1, 1, 0, 0], [0, 0, 0, 1, 1, 1]], np.int32)


def _arch(jax_side=False):
    """The tiny preset at head dim 16 (2 heads: 32 wide), where the RoPE's
    built (8, 4, 4) and split (6, 5, 5) sizes differ."""
    base = jsv.SanaVideoConfig.tiny() if jax_side else SanaVideoConfig.tiny()
    return dataclasses.replace(base, head_dim=16, cross_head_dim=16)


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
    return {"model_family": "sanavideo", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values, arch=False):
    if arch:
        return (JaxSanaVideo(JaxTrainingConfig(values), arch=_arch(True)),
                SanaVideo(config_namespace(values), arch=_arch()))
    return JaxSanaVideo(JaxTrainingConfig(values)), SanaVideo(config_namespace(values))


def _inputs(cfg, masked=True, seed=0):
    """Two clips of 3 x 4 x 6 latents (3 x 2 x 3 = 18 tokens), ``SIGMAS`` at
    scheduler scale (x 1000 in f32), 6 Gemma tokens, the padded ``MASK``."""
    rng = np.random.default_rng(seed)
    inputs = {"latents": rng.standard_normal((2, 3, 4, 6, cfg.in_channels), dtype=np.float32),
              "timesteps": SIGMAS * np.float32(1000.0),
              "context": rng.standard_normal((2, 6, cfg.caption_channels), dtype=np.float32)}
    if masked:
        inputs["context_mask"] = MASK
    return inputs


def _variables(jmodule, cfg, seed):
    return numpy_variables(jmodule, **{k: jnp.asarray(v) for k, v in _inputs(cfg).items()}, seed=seed)


@pytest.fixture(scope="module")
def jax_dit():
    """The JAX DiT at head dim 16: its output and LoRA gradients of a seeded
    projection (f32, rank-4 adapters), computed once per input variant."""
    cache = {}

    def reference(variant):
        if variant not in cache:
            cfg = _arch()
            inputs = _inputs(cfg, masked=variant == "masked", seed=4)
            jmodule = jsv.SanaVideoTransformer(config=_arch(True), dtype=jnp.float32, lora_rank=4)
            variables = _variables(jmodule, cfg, seed=5)
            weight = np.random.default_rng(6).standard_normal((2, 3, 4, 6, cfg.out_channels)).astype(np.float32)
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
    """The presets (tiny and published: 20 heads of 112, 2240 wide, Mix-FFN
    5600 with the 2240^2 x 3 temporal conv, 93.0M a block and 1.91B in the
    checkpoint layout, the JAX ``eval_shape`` at 2 blocks giving the same
    count), the family's constants, its ``gemma-2`` spec at 300 tokens,
    example batch and video VAE as the JAX family's."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "MODALITY", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR",
                 "HUGGINGFACE_PATHS", "DEFAULT_LORA_TARGET", "LATENT_CHANNEL_COUNT", "VAE_SCALING_FACTOR",
                 "VAE_SHIFT_FACTOR"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    for ours, theirs in ((SanaVideoConfig.tiny(), jsv.SanaVideoConfig.tiny()), (SanaVideoConfig(),
                                                                                jsv.SanaVideoConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs) and ours.hidden_size == theirs.hidden_size
    full = SanaVideoConfig()
    shapes = sanavideo_checkpoint_shapes(full)
    per_block = sum(math.prod(s) for k, s in shapes.items() if k.startswith("transformer_blocks.0."))
    assert per_block == 92_982_400 and sum(math.prod(s) for s in shapes.values()) == 1_905_841_344
    two = dataclasses.replace(jsv.SanaVideoConfig(), num_layers=2)
    example = {"latents": jnp.zeros((1, 1, 2, 2, 16)), "timesteps": jnp.zeros((1,)),
               "context": jnp.zeros((1, 3, 2304))}
    tree = jax.eval_shape(lambda: jsv.SanaVideoTransformer(config=two).init(jax.random.PRNGKey(0), **example))
    assert sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree)) == \
        sum(math.prod(s) for s in sanavideo_checkpoint_shapes(dataclasses.replace(full, num_layers=2)).values())
    assert "sanavideo" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), SanaVideo)
    with pytest.raises(ValueError, match="flow-matching"):
        SanaVideo(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2).items()}
    for values in (_tiny_values(), {**_tiny_values(), "model_arch_preset": None}):
        ours, theirs = SanaVideo(config_namespace(values)), JaxSanaVideo(JaxTrainingConfig(values))
        assert dataclasses.asdict(ours.video_vae_config()) == dataclasses.asdict(theirs.video_vae_config())
    assert model.video_vae_config() == dataclasses.replace(VideoVAEConfig.tiny(), latent_channels=4)


@pytest.mark.parametrize("head_dim", [112, 16])
def test_rope_split_and_rotation_match_jax(head_dim):
    """Quirk kept (ROADMAP Queue 3): at head dim 112 the tables are built
    with dims (40, 36, 36) and split (38, 37, 37), at 16 built (8, 4, 4) and
    split (6, 5, 5), so odd boundaries cut pairs apart; ``sanavideo_rope``
    bitwise the JAX tables over a 3 x 4 x 5 grid, the ``cos[0::2]`` /
    ``sin[1::2]`` rotation within ``ROPE_ATOL`` times the input scale of the
    JAX one."""
    cfg = dataclasses.replace(SanaVideoConfig(), head_dim=head_dim)
    jcfg = dataclasses.replace(jsv.SanaVideoConfig(), head_dim=head_dim)
    built = (head_dim - 4 * (head_dim // 6), 2 * (head_dim // 6))
    split = (head_dim - 2 * (head_dim // 3), head_dim // 3)
    assert (built, split) == {112: ((40, 36), (38, 37)), 16: ((8, 4), (6, 5))}[head_dim]
    cos, sin = sanavideo_rope(cfg, (3, 4, 5))
    jcos, jsin = jsv.sanavideo_rope(jcfg, (3, 4, 5))
    assert np.array_equal(cos, np.asarray(jcos)) and np.array_equal(sin, np.asarray(jsin))
    x = np.random.default_rng(1).standard_normal((2, 60, 3, head_dim)).astype(np.float32)
    ours = apply_sv_rope(t(x), t(cos), t(sin)).numpy()
    ref = np.asarray(jsv._apply_sv_rope(jnp.asarray(x), jcos, jsin))
    assert np.abs(ours - ref).max() <= ROPE_ATOL * np.abs(x).max() * 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_linear_attention_and_ffn_match_jax(dtype):
    """A block at head dim 16 (the ReLU linear attention: RoPE after the
    ReLU, the normaliser from the unrotated q and k, f32 products from
    bf16 or f32 projections; the cross-attention with ``MASK``; the
    GLUMBTempConv FFN): within ``F32_REL`` of the JAX block in f32 and
    ``BF16_REL`` in bf16."""
    cfg, grid = _arch(), (3, 2, 3)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 18, cfg.hidden_size)).astype(np.float32)
    ctx = rng.standard_normal((2, 6, cfg.hidden_size)).astype(np.float32)
    t6 = 0.3 * rng.standard_normal((2, 6, cfg.hidden_size)).astype(np.float32)
    cos, sin = sanavideo_rope(cfg, grid)
    bias = (1.0 - MASK.astype(np.float32)) * -10000.0
    jblock = jsv.SanaVideoBlock(_arch(True), dtype=jdtype, lora_rank=4)
    args = (jnp.asarray(x).astype(jdtype), jnp.asarray(ctx).astype(jdtype), jnp.asarray(t6),
            (jnp.asarray(cos), jnp.asarray(sin)), grid, jnp.asarray(bias))
    variables = numpy_variables(jblock, *args, seed=3)
    ref = np.asarray(jax.jit(jblock.apply, static_argnums=(5,))(jax.tree_util.tree_map(jnp.asarray, variables),
                                                                 *args).astype(jnp.float32))
    port = bridge(variables, SanaVideoBlock(cfg, tdtype, lora_rank=4))
    key_ids = key_mask_segments(t(MASK))
    with torch.no_grad():
        out = port(t(x).to(tdtype), t(ctx).to(tdtype), t(t6), t(cos), t(sin), grid,
                   torch.ones((2, 18), dtype=torch.int32), key_ids).float().numpy()
    assert rel(out, ref) < (F32_REL if dtype == "float32" else BF16_REL)


def test_glumbtempconv_matches_jax():
    """GLUMBTempConv (per-frame GLUMBConv with padding 1, then the bias-free
    (3, 1) temporal conv over (T, H * W) as a residual) over 4 frames of 3 x
    5, f32: within ``F32_REL`` of the JAX module."""
    x = np.random.default_rng(3).standard_normal((2, 4, 3, 5, 16)).astype(np.float32)
    jmodule = jsv.GLUMBTempConv(16, 2.5, jnp.float32)
    variables = numpy_variables(jmodule, jnp.asarray(x), seed=4)
    ref = np.asarray(jmodule.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x)))
    port = bridge(variables, GLUMBTempConv(16, 16, 2.5, torch.float32))
    with torch.no_grad():
        assert rel(port(t(x)).numpy(), ref) < F32_REL


def test_cross_attention_key_ids_match_the_additive_bias():
    """The cross-attention through ``dot_product_attention`` (query ids 1,
    key ids 1 / -1 from ``MASK``) against the JAX module's dense f32 softmax
    with the (1 - mask) x -10000 key bias, at head dim 112: within
    ``F32_REL`` (exp(-10000) is 0 in f32).  Quirk kept (ROADMAP Queue 3):
    with no valid key the JAX bias shifts every logit alike, so its softmax
    is the unmasked one (within ``SHIFTED_REL``: the f32 logits near -10000
    are rounded to 2^-10), while the kernels' convention gives 0."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 18, 2, 112)).astype(np.float32)
    k, v = (rng.standard_normal((2, 6, 2, 112)).astype(np.float32) for _ in range(2))

    def dense(mask):
        logits = jnp.einsum("bshd,bthd->bhst", q, k) / math.sqrt(112)
        logits = logits + ((1.0 - jnp.asarray(mask, jnp.float32)) * -10000.0)[:, None, None, :]
        return np.asarray(jnp.einsum("bhst,bthd->bshd", jax.nn.softmax(logits, -1), v))

    q_ids = torch.ones((2, 18), dtype=torch.int32)
    out = dot_product_attention(t(q), t(k), t(v), q_segment_ids=q_ids, kv_segment_ids=key_mask_segments(t(MASK)))
    assert rel(out.numpy(), dense(MASK)) < F32_REL
    empty = np.asarray([[0] * 6, [1] * 6], np.int32)
    out = dot_product_attention(t(q), t(k), t(v), q_segment_ids=q_ids, kv_segment_ids=key_mask_segments(t(empty)))
    unmasked = dot_product_attention(t(q), t(k), t(v)).numpy()
    assert not out[0].numpy().any() and rel(dense(empty)[0], unmasked[0]) < SHIFTED_REL
    assert rel(out[1].numpy(), dense(empty)[1]) < F32_REL


@pytest.mark.parametrize("family", ["sanavideo", "longcat_video"])
def test_caption_encoders_keep_a_valid_token(family):
    """Why the fully masked caption does not reach either video DiT from a
    prompt: the ``gemma-2`` (Sana-Video) and ``t5-xxl`` (LongCat-Video)
    encoders' masks keep one token of an empty prompt (an all-0 mask reaches
    only from a text cache written with one)."""
    from simpletuner_tpu_torch.models.longcat_video import LongcatVideo
    from simpletuner_tpu_torch.models.text_encoders import load_text_encoders

    spec = (SanaVideo if family == "sanavideo" else LongcatVideo).TEXT_ENCODER_CONFIGURATION[0]
    (encoder,) = load_text_encoders([dataclasses.replace(spec, max_length=8)], pretrained_path=None, tiny=True,
                                    device="cpu")
    mask = np.asarray(encoder.encode(["", "a cat"])["attention_mask"])
    assert mask.shape == (2, 8) and mask.sum(axis=1).min() >= 1 and mask[:, 0].all()


@pytest.mark.parametrize("variant,remat", [("masked", False), ("masked", True), ("unmasked", False)])
def test_transformer_forward_and_lora_grads_match_jax(jax_dit, variant, remat):
    """The DiT at head dim 16 (f32, rank-4 adapters) with the padded
    ``MASK`` (and under remat) or without a mask: the output within
    ``F32_REL`` of the JAX module's, the LoRA gradients of a seeded
    projection against ``jax.grad`` within ``GRAD_REL``, per adapter."""
    inputs, variables, weight, ref, flat = jax_dit(variant)
    port = bridge(variables, SanaVideoTransformer(_arch(), dtype=torch.float32, lora_rank=4, remat=remat))
    adapters = tl.freeze_base(port)
    out = port(**{k: t(v) for k, v in inputs.items()})
    assert tuple(out.shape) == ref.shape and rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    assert sorted(flat) == sorted(adapters) and "block_1/attn1_q/lora_A" in flat and "proj_out/lora_B" in flat
    assert not any(name.startswith(("time_", "caption_")) for name in flat)
    for path, param in adapters.items():
        assert rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_transformer_bf16_matches_jax():
    """The DiT at head dim 16 in bf16 (f32 adapters, norms, tables and time
    MLP), with ``MASK``, against the JAX module in bf16: within ``BF16_REL``."""
    cfg = _arch()
    inputs = _inputs(cfg, seed=7)
    jmodule = jsv.SanaVideoTransformer(config=_arch(True), dtype=jnp.bfloat16, lora_rank=4)
    variables = _variables(jmodule, cfg, seed=8)
    port = bridge(variables, SanaVideoTransformer(cfg, dtype=torch.bfloat16, lora_rank=4))
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                            **{k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}).numpy()
    assert out.dtype == ref.dtype == np.float32 and rel(out, ref) < BF16_REL


class _Encoder:
    """A Gemma-2 encoder's ``encode`` output, fixed."""

    def __init__(self, states, mask):
        self.states, self.mask = states, mask

    def encode(self, prompts):
        n = len(prompts)
        return {"last_hidden_state": self.states[:n], "attention_mask": self.mask[:n]}


def test_family_inputs_prediction_and_text_match_jax(jax_dit):
    """``get_model_inputs`` (sigma x 1000, the mask as ``context_mask``; none
    without one) equal to the JAX family's; ``model_predict`` within
    ``F32_REL`` of the JAX module (the ``jax_dit`` output); ``encode_text``,
    the collate (the mask as ``text_attention_mask``) and
    ``inference_conditioning`` equal to the JAX family's."""
    jmodel, model = _pair(_tiny_values(), arch=True)
    inputs, variables, _, ref, _ = jax_dit("masked")
    prepared = {"noisy_latents": inputs["latents"], "timesteps": SIGMAS, "text_embeds": inputs["context"],
                "text_attention_mask": MASK}
    for keep in (True, False):
        batch = prepared if keep else {k: v for k, v in prepared.items() if k != "text_attention_mask"}
        ours = model.get_model_inputs({k: t(v) for k, v in batch.items()})
        theirs = jmodel.get_model_inputs({k: jnp.asarray(v) for k, v in batch.items()})
        assert sorted(ours) == sorted(theirs)
        for key in ours:
            np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    module = bridge(variables, model.create_module())
    with torch.no_grad():
        out = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
    assert out.shape == ref.shape and rel(out, ref) < F32_REL
    rng = np.random.default_rng(9)
    states = rng.standard_normal((2, 7, 32)).astype(np.float32)
    mask = (np.arange(7)[None] < np.asarray([7, 3])[:, None]).astype(np.int32)
    for m in (jmodel, model):
        m.attach_text_encoders([_Encoder(states, mask)])
    mine, jax_payloads = model.encode_text(["a", "b"]), jmodel.encode_text(["a", "b"])
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


def _jax_params(jmodel, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(jmodel.arch).items()}
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0), **example))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise_and_unpatchify_splits_pt_ph_pw_c(tmp_path):
    """The JAX exporter's file of a seeded tiny transformer (two shards): its
    names and shapes are the port's layout, the port's tree bitwise the JAX
    ``load_sanavideo_params`` tree, the imported module bitwise the bridged
    JAX tree.  Quirk kept (ROADMAP Queue 3): the JAX docstring says the
    output features are [c, pt, ph, pw], its code (and the port, and the
    reference's permute) splits them as (pt, ph, pw, c), and the importer
    reads ``proj_out`` 1:1: with a zero ``proj_out`` weight and bias
    0, 1, ..., 15, the output at patch offset (ph, pw) and channel c is
    (ph * 2 + pw) * 4 + c in both packages."""
    jmodel, model = _pair(_tiny_values())
    params = _jax_params(jmodel, 4)
    weights = export_sanavideo_to_checkpoint(params, jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == sanavideo_checkpoint_shapes(model.arch)
    root = tmp_path / "sanavideo" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_params(jmodel, str(tmp_path / "sanavideo"))
    _assert_trees_bitwise(load_sanavideo_params(model, str(tmp_path / "sanavideo")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "sanavideo"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name
    inputs = _inputs(model.arch, masked=False, seed=6)
    params = jax.tree_util.tree_map(np.asarray, theirs)
    params["proj_out"] = {"kernel": np.zeros_like(params["proj_out"]["kernel"]),
                          "bias": np.arange(16, dtype=np.float32)}
    jmodule = jsv.SanaVideoTransformer(config=jmodel.arch, dtype=jnp.float32)
    jout = np.asarray(jax.jit(jmodule.apply)({"params": params}, **{k: jnp.asarray(v) for k, v in inputs.items()}))
    module = load_flax_params(SanaVideoTransformer(model.arch, dtype=torch.float32), params)
    with torch.no_grad():
        out = module(**{k: t(v) for k, v in inputs.items()}).numpy()
    expected = ((np.arange(4)[:, None] % 2) * 2 + np.arange(6)[None] % 2)[..., None] * 4 + np.arange(4)
    assert np.array_equal(out, np.broadcast_to(expected, out.shape))
    assert np.allclose(jout, out, atol=1e-6)


def test_key_map_and_adapter_file_match_jax(tmp_path):
    """``sanavideo_key_map`` equals the JAX map; an adapter file written by
    the port round-trips bitwise and loads into the JAX template bitwise."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    assert _key_map_for(model) == JAX_KEY_MAPS["sanavideo"](jmodel) == sanavideo_key_map(model.arch)
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
