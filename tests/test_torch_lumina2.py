"""The torch port's Lumina-Image 2.0 family against the JAX package, on the CPU.

The Next-DiT's blocks (modulated and the context refiner's unmodulated
form), the transformer masked and unmasked with its LoRA gradients (remat
too), the family contract with its reversed timestep and negated
prediction, the caption pads' segment id 0 (a quirk kept from the JAX
module), the diffusers import of the JAX exporter's output, the key map,
``encode_text`` / collate on the tiny Gemma-2 and the RoPE tables: the same
seeded numpy weights and inputs go through both packages.  The trainer's
trajectory is in test_torch_lumina2_trainer.py.  Every tolerance is stated
where it is checked.  At the tiny size the head dim is 24 (zero-padded by
the kernels' wrappers on the card); the published D = 96 shapes are held to
the plain version in test_torch_kernels_cuda.py, on the card.
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
from simpletuner_tpu.models.llm_encoder import LLMEncoder as JaxLLMEncoder
from simpletuner_tpu.models.lumina2 import transformer as jax_lumina_transformer
from simpletuner_tpu.models.lumina2.model import Lumina2 as JaxLumina2
from simpletuner_tpu.models.lumina2.transformer import Lumina2Block as JaxLumina2Block
from simpletuner_tpu.models.lumina2.transformer import Lumina2Config as JaxLumina2Config
from simpletuner_tpu.models.lumina2.transformer import Lumina2Transformer as JaxLumina2Transformer
from simpletuner_tpu.models.weight_export import export_lumina2_to_diffusers
from simpletuner_tpu.models.weight_import import load_lumina2_params as jax_load_lumina2_params
from simpletuner_tpu.training.lora import lumina2_key_map as jax_lumina2_key_map

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import lumina2_checkpoint_shapes
from simpletuner_tpu_torch.models.llm_encoder import LLMEncoder, LLMEncoderConfig
from simpletuner_tpu_torch.models.lumina2 import Lumina2, Lumina2Config, Lumina2Transformer
from simpletuner_tpu_torch.models.lumina2 import transformer as lumina_transformer
from simpletuner_tpu_torch.models.lumina2.transformer import Lumina2Block, rope_angles, rope_frequencies
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.text_encoders import LLMTextEncoder
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_lumina2_params, load_transformer_params
from simpletuner_tpu_torch.training.lora import lumina2_key_map

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# gradient-derived numbers (test_torch_sdxl.py: f32 gradients through a deep
# net are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
PROMPTS = ["a lighthouse on a basalt cliff at dusk", "", "portrait of a cat"]


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
    return {"model_family": "lumina2", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxLumina2(JaxTrainingConfig(values)), Lumina2(config_namespace(values))


def _mask(lengths, length):
    return (np.arange(length)[None] < np.asarray(lengths)[:, None]).astype(np.int32)


def test_presets_match_jax():
    for name in ("tiny", None):
        ours = getattr(Lumina2Config, name)() if name else Lumina2Config()
        theirs = getattr(JaxLumina2Config, name)() if name else JaxLumina2Config()
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), name
        assert (ours.head_dim, ours.time_dim, ours.ffn_inner) == (theirs.head_dim, theirs.time_dim, theirs.ffn_inner)
    cfg = Lumina2Config()  # Alpha-VLLM/Lumina-Image-2.0's transformer
    assert (cfg.hidden_size, cfg.depth, cfg.refiner_depth, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.ffn_inner, cfg.time_dim) == (2304, 26, 2, 24, 8, 96, 6144, 1024)
    shapes = lumina2_checkpoint_shapes(cfg)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 1_972_759_232  # the JAX preset: 1.97B


def test_rope_tables_match_jax_bitwise():
    """The per-axis frequencies (float64 on the host, rounded to f32) and the
    angles at (caption index, row, col) ids, bitwise the JAX ``rope_angles``."""
    rng = np.random.default_rng(0)
    positions = rng.integers(0, 300, (2, 7, 3)).astype(np.int32)
    for axes in ((32, 32, 32), (8, 8, 8)):
        freqs = tuple(torch.from_numpy(f) for f in rope_frequencies(axes, 10000.0))
        ours = rope_angles(t(positions), freqs).numpy()
        theirs = np.asarray(jax_lumina_transformer.rope_angles(jnp.asarray(positions), axes, 10000.0))
        assert ours.shape == theirs.shape == (2, 7, sum(axes) // 2) and np.array_equal(ours, theirs)


@pytest.mark.parametrize("modulation", [True, False])
def test_block_matches_jax(modulation):
    """One block (f32, rank-4 adapters): modulated from a time embedding, or
    the context refiner's form, masked by a caption-mask plane with pads at
    segment id 0: within ``F32_REL``."""
    cfg = Lumina2Config.tiny()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.hidden_size), dtype=np.float32)
    angles = rng.uniform(0, 6, (2, 9, cfg.head_dim // 2)).astype(np.float32)
    temb = rng.standard_normal((2, cfg.time_dim), dtype=np.float32) if modulation else None
    seg = _mask([9, 5], 9)
    jblock = JaxLumina2Block(JaxLumina2Config.tiny(), modulation=modulation, dtype=jnp.float32, lora_rank=4)
    args = [jnp.asarray(x), jnp.asarray(angles), None if temb is None else jnp.asarray(temb), jnp.asarray(seg)]
    variables = numpy_variables(jblock, *args, seed=2)
    port = bridge(variables, Lumina2Block(cfg, modulation=modulation, dtype=torch.float32, lora_rank=4))
    ref = jblock.apply(jax.tree_util.tree_map(jnp.asarray, variables), *args)
    with torch.no_grad():
        out = port(t(x), t(angles), None if temb is None else t(temb), t(seg))
    assert tuple(out.shape) == ref.shape and rel(out.numpy(), ref) < F32_REL


def _inputs(cfg, lengths, seed=0, height=8, width=6, cap_len=7):
    rng = np.random.default_rng(seed)
    latents = rng.standard_normal((2, height, width, cfg.in_channels), dtype=np.float32)
    timesteps = np.asarray([0.13, 0.91], np.float32)
    context = rng.standard_normal((2, cap_len, cfg.cap_feat_dim), dtype=np.float32)
    mask = None if lengths is None else _mask(lengths, cap_len)
    return latents, timesteps, context, mask


@pytest.mark.parametrize("variant", ["masked", "unmasked", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny DiT (f32, rank-4 adapters) on the same seeded weights: the
    output within ``F32_REL`` with a caption mask (7 and 4 of 7 valid), with
    none, and under remat; the LoRA gradients of a seeded projection of it
    against ``jax.grad`` within ``GRAD_REL``, per adapter."""
    cfg = Lumina2Config.tiny()
    remat = variant == "remat"
    latents, timesteps, context, mask = _inputs(cfg, None if variant == "unmasked" else [7, 4])
    weight = np.random.default_rng(9).standard_normal(latents.shape).astype(np.float32)
    jmodule = JaxLumina2Transformer(config=JaxLumina2Config.tiny(), dtype=jnp.float32, lora_rank=4, remat=remat)
    jargs = [jnp.asarray(latents), jnp.asarray(timesteps), jnp.asarray(context),
             None if mask is None else jnp.asarray(mask)]
    variables = numpy_variables(jmodule, *jargs, seed=1)
    port = bridge(variables, Lumina2Transformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

    def jax_loss(lora):
        out = jmodule.apply({"params": params, "lora": lora}, *jargs)
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(port)
    out = port(t(latents), t(timesteps), t(context), None if mask is None else t(mask))
    assert tuple(out.shape) == ref.shape == latents.shape and out.dtype == torch.float32
    assert rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and "context_refiner_0/attn_q/lora_A" in flat
    assert "layer_1/feed_forward/linear_3/lora_B" in flat and "cap_in/lora_A" in flat
    for path, param in adapters.items():
        assert param.grad is not None and rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_caption_pads_carry_segment_id_zero(monkeypatch):
    """Quirk kept from the JAX module (ROADMAP Queue 3): a padded caption
    token gets segment id 0, not ``SEGMENT_PAD_ID`` (-1), in the context
    refiners and in every joint layer, which are always masked: pads attend
    to each other only.  So image tokens never see a pad: changing the pads'
    features leaves the image prediction unchanged, in both packages, while a
    valid token's change moves it."""
    cfg = Lumina2Config.tiny()
    latents, timesteps, context, mask = _inputs(cfg, [7, 4], seed=3)
    seen = []
    original = lumina_transformer.dot_product_attention

    def recording(q, k, v, q_segment_ids=None, kv_segment_ids=None, **kw):
        seen.append(None if q_segment_ids is None else q_segment_ids.clone())
        return original(q, k, v, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids, **kw)

    monkeypatch.setattr(lumina_transformer, "dot_product_attention", recording)
    jmodule = JaxLumina2Transformer(config=JaxLumina2Config.tiny(), dtype=jnp.float32)
    variables = numpy_variables(jmodule, *map(jnp.asarray, (latents, timesteps, context, mask)), seed=4)
    port = bridge(variables, Lumina2Transformer(cfg, dtype=torch.float32))
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    apply = jax.jit(jmodule.apply)
    padded = context.copy()
    padded[1, 4:] = 100.0  # the second caption's pads
    moved = context.copy()
    moved[1, 0] += 1.0  # one of its valid tokens
    outs = {}
    for name, ctx in (("base", context), ("pads", padded), ("valid", moved)):
        with torch.no_grad():
            ours = port(t(latents), t(timesteps), t(ctx), t(mask)).numpy()
        theirs = np.asarray(apply(params, *map(jnp.asarray, (latents, timesteps, ctx, mask))))
        assert rel(ours, theirs) < F32_REL, name
        outs[name] = ours
    assert np.array_equal(outs["pads"][1], outs["base"][1]) and not np.allclose(outs["valid"][1], outs["base"][1])
    calls = seen[:2 * cfg.refiner_depth + cfg.depth]
    assert [c is None for c in calls] == [False] * cfg.refiner_depth + [True] * cfg.refiner_depth + [False] * cfg.depth
    np.testing.assert_array_equal(calls[0].numpy(), mask)  # the context refiner: the caption mask itself
    img_len = (latents.shape[1] // 2) * (latents.shape[2] // 2)
    for joint in calls[2 * cfg.refiner_depth:]:
        np.testing.assert_array_equal(joint.numpy(), np.concatenate([mask, np.ones((2, img_len), np.int32)], 1))
        assert joint.min() == 0  # the pads: 0, never -1


# ---- the family contract -----------------------------------------------------------------------------


def test_contract_reversed_timestep_and_negated_prediction():
    """The family's constants, spec, arch and example batch as the JAX
    family's; ``get_model_inputs`` passes ``1 - sigma``; ``model_predict``
    is the negated transformer output, equal to the JAX ``model_predict``
    within ``F32_REL``; ``denoise_fn`` takes the sampler's sigma the same
    way; a non-flow prediction type is refused."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR", "LATENT_CHANNEL_COUNT"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch) and model.is_flow
    full = {**_tiny_values(), "model_arch_preset": None}
    assert dataclasses.asdict(Lumina2(config_namespace(full)).arch) == \
        dataclasses.asdict(JaxLumina2(JaxTrainingConfig(full)).arch)
    assert "lumina2" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), Lumina2)
    with pytest.raises(ValueError, match="flow-matching"):
        Lumina2(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 128).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 128).items()}

    cfg = model.arch
    latents, timesteps, context, mask = _inputs(cfg, [7, 3], seed=5)
    jmodule = jmodel.create_module()
    variables = numpy_variables(jmodule, *map(jnp.asarray, (latents, timesteps, context, mask)), seed=6)
    module = bridge(variables, model.create_module())
    prepared = {"noisy_latents": latents, "timesteps": timesteps, "text_embeds": context, "text_attention_mask": mask}
    inputs = model.get_model_inputs({k: t(v) for k, v in prepared.items()})
    assert inputs.keys() == jmodel.get_model_inputs(prepared).keys()
    np.testing.assert_array_equal(inputs["timesteps"].numpy(), 1.0 - timesteps)
    with torch.no_grad():
        ours = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
        raw = module(**inputs).numpy()
        denoised = model.denoise_fn(module, model.inference_conditioning(
            {"text_embeds": t(context[:1]), "text_attention_mask": t(mask[:1])}))(t(latents[:1]), torch.tensor(0.25))
    theirs = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                      jax.tree_util.tree_map(jnp.asarray, prepared)))
    assert np.array_equal(ours, -raw) and rel(ours, theirs) < F32_REL
    with torch.no_grad():
        direct = -module(t(latents[:1]), torch.tensor([0.75]), t(context[:1]), t(mask[:1]))
    assert torch.equal(denoised, direct)


# ---- text encoding ----------------------------------------------------------------------------------


def test_encode_text_and_collate_match_jax():
    """Gemma-2's final-norm states per prompt with the mask kept (the tiny
    layout, f32 on both sides, one tokenizer), and the collate's
    ``text_attention_mask``: within ``F32_REL``."""
    jmodel, model = _pair(_tiny_values())
    spec = jmodel.TEXT_ENCODER_CONFIGURATION[0]
    (jenc,) = jax_te.load_text_encoders([dataclasses.replace(spec, max_length=20)], tiny=True)
    jenc.module = JaxLLMEncoder(jenc.config, dtype=jnp.float32)  # read when the encode is traced
    variables = numpy_variables(jenc.module, jnp.zeros((1, 8), jnp.int32), seed=7)
    jenc.params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    port = bridge(variables, LLMEncoder(LLMEncoderConfig.tiny("gemma2"), dtype=torch.float32))
    jmodel.attach_text_encoders([jenc])
    model.attach_text_encoders([LLMTextEncoder(dataclasses.replace(model.TEXT_ENCODER_CONFIGURATION[0],
                                                                   max_length=20), port, jenc.tokenizer)])
    ours, theirs = model.encode_text(PROMPTS), jmodel.encode_text(PROMPTS)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "text_embeds"]
        assert a["text_embeds"].shape == b["text_embeds"].shape == (20, 32) and a["text_embeds"].dtype == np.float32
        np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
        assert rel(a["text_embeds"], b["text_embeds"]) < F32_REL
    collated, jcollated = model.collate_text_embeds(ours), jmodel.collate_text_embeds(theirs)
    assert sorted(collated) == sorted(jcollated) == ["text_attention_mask", "text_embeds"]
    np.testing.assert_array_equal(collated["text_attention_mask"], jcollated["text_attention_mask"])
    assert collated["text_embeds"].shape == (3, 20, 32)


# ---- weight import and the key map ------------------------------------------------------------------


def _jax_params(jmodel, seed):
    shapes = jax.eval_shape(lambda: JaxLumina2Transformer(config=jmodel.arch).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, jmodel.arch.in_channels)), jnp.zeros(1),
        jnp.zeros((1, 4, jmodel.arch.cap_feat_dim))))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's diffusers file of a seeded tiny transformer (two
    shards in ``transformer/``): its names and shapes are the port's layout,
    the port's tree is bitwise the JAX ``load_lumina2_params`` tree, and the
    imported module bitwise the bridged JAX tree."""
    jmodel, model = _pair(_tiny_values())
    weights = export_lumina2_to_diffusers(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == lumina2_checkpoint_shapes(model.arch)
    root = tmp_path / "lumina2" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_lumina2_params(jmodel, str(tmp_path / "lumina2"))
    _assert_trees_bitwise(load_lumina2_params(model, str(tmp_path / "lumina2")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "lumina2"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_key_map_and_default_targets_match_jax():
    """``lumina2_key_map`` equal to the JAX map; no code reads
    ``DEFAULT_LORA_TARGET`` (as in the JAX package), so without
    ``lora_target_modules`` every adapter-carrying linear is adapted, and the
    attention projections by their diffusers names select the attention."""
    jmodel, model = _pair(_tiny_values())
    assert lumina2_key_map(model.arch) == jax_lumina2_key_map(jmodel.arch)
    every = {name.rsplit("/", 1)[0] for name in tl.lora_parameters(model.create_module())}
    assert {"cap_in", "patch_in", "final_proj", "layer_0/feed_forward/linear_1", "context_refiner_0/attn_q"} <= every
    _, attention = _pair(_tiny_values(lora_target_modules=["to_q", "to_k", "to_v", "to_out.0"]))
    adapted = {name.rsplit("/", 2)[-2] for name in tl.lora_parameters(attention.create_module())}
    assert adapted == {"attn_q", "attn_k", "attn_v", "attn_proj"}


def test_validation_render_is_unmasked_as_in_jax():
    """Quirk kept (ROADMAP Queue 3): a validation render's batch carries the
    text cache payload under its own keys, ``attention_mask``, while the
    family's conditioning reads ``text_attention_mask``, so in both packages
    the render runs every caption token as valid (the trainer's collate
    names the mask, so training is masked)."""
    from simpletuner_tpu_torch.training.validation import Validation

    jmodel, model = _pair(_tiny_values(validation_resolution=64))
    payload = {"text_embeds": np.zeros((7, 32), np.float32), "attention_mask": _mask([3], 7)[0]}
    batch = Validation(model, config_namespace(_tiny_values()), device="cpu")._batch(payload, (1, 8, 8, 4))
    assert sorted(model.inference_conditioning(batch)) == ["text_embeds"]
    jbatch = {k: jnp.asarray(v)[None] for k, v in payload.items()}
    assert sorted(jmodel.inference_conditioning(jbatch)) == ["text_embeds"]
    assert sorted(model.inference_conditioning(
        {"text_embeds": batch["text_embeds"], "text_attention_mask": batch["attention_mask"]})) == \
        ["text_attention_mask", "text_embeds"]
