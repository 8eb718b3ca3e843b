"""The torch port's OmniGen family against the JAX package, on the CPU.

The presets (the published one's parameter count against the JAX
``eval_shape``), the sincos table and the prefix attention, the split of
the attention (the image rows through the op, the prefix rows plain)
against the JAX block's dense mask with right- and left-padded captions,
the DiT with its LoRA gradients against ``jax.grad`` (unmasked, both
paddings, remat) and in bf16; the family contract (1 - sigma, the negated
output, the plain flow schedule, the tiny tokenizer, the cache payload's
int32 ids and float mask through both packages' caches); the import of the
JAX exporter's file, the absent key map and adapter files under the
flattened module paths; a test per kept quirk.  The trainer's trajectory is
in test_torch_omnigen_ernie_ideogram_trainer.py.  Every tolerance is stated
where it is checked.
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
from simpletuner_tpu.models import weight_import as _jax_weight_import  # noqa: F401 (before the omnigen importer)
from simpletuner_tpu.models.omnigen import transformer as jot
from simpletuner_tpu.models.omnigen.model import OmniGen as JaxOmniGen
from simpletuner_tpu.models.omnigen.weight_import import load_omnigen_params as jax_load_params
from simpletuner_tpu.models.weight_export import export_omnigen_to_diffusers
from simpletuner_tpu.training.lora import _key_map_for as jax_key_map_for

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import omnigen_checkpoint_shapes
from simpletuner_tpu_torch.models.omnigen import OmniGen, OmniGenConfig, OmniGenTransformer
from simpletuner_tpu_torch.models.omnigen.transformer import OmniGenBlock, prefix_attention, sincos_2d
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_omnigen_params, load_transformer_params
from simpletuner_tpu_torch.ops import key_mask_segments
from simpletuner_tpu_torch.training.lora import _key_map_for

from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# f32 LoRA gradients (test_torch_sdxl.py: f32 gradients through a deep net
# are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
# bf16 on both sides: each rounds its own intermediates (JAX rounds the
# probabilities to bf16 before their product with V, the port's op keeps them f32)
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
    return {"model_family": "omnigen", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxOmniGen(JaxTrainingConfig(values)), OmniGen(config_namespace(values))


def _text_mask(kind, length=8):
    """(2, length) masks: right-padded (5 and 8 valid), left-padded (pads first), or None."""
    if kind == "unmasked":
        return None
    valid = np.asarray([[1] * 5 + [0] * (length - 5), [1] * length], np.float32)
    return valid[:, ::-1].copy() if kind == "left" else valid


def _inputs(cfg, mask_kind="right", seed=0, height=8, width=12, txt_len=8):
    rng = np.random.default_rng(seed)
    out = {
        "latents": rng.standard_normal((2, height, width, cfg.in_channels), dtype=np.float32),
        "timesteps": np.asarray([0.13, 0.91], np.float32),
        "input_ids": rng.integers(0, cfg.vocab_size, (2, txt_len)).astype(np.int32),
    }
    mask = _text_mask(mask_kind, txt_len)
    if mask is not None:
        out["text_mask"] = mask
    return out


def _variables(jmodule, cfg, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(cfg).items()}
    return numpy_variables(jmodule, **example, seed=seed)


def test_presets_and_contract_match_jax():
    """The presets (tiny and published: 3072 wide, 32 layers of 113.2M, a
    98.5M token table; 3.76B parameters in the checkpoint layout, as the JAX
    ``eval_shape``), the family's constants, its empty encoder spec, its
    example batch and its plain flow schedule as the JAX family's; a
    non-flow prediction type is refused."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "LATENT_CHANNEL_COUNT", "VAE_SCALING_FACTOR", "TEXT_ENCODER_CONFIGURATION"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert model.TEXT_ENCODER_CONFIGURATION == ()
    for ours, theirs in ((OmniGenConfig.tiny(), jot.OmniGenConfig.tiny()), (OmniGenConfig(), jot.OmniGenConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    full = OmniGen(config_namespace({**_tiny_values(), "model_arch_preset": None})).arch
    shapes = omnigen_checkpoint_shapes(full)
    per_layer = sum(math.prod(s) for k, s in shapes.items() if k.startswith("layers.0."))
    assert per_layer == 113_252_352 and shapes["embed_tokens.weight"] == (32064, 3072)
    example = {k: (v.shape, v.dtype) for k, v in _inputs(full).items()}
    tree = jax.eval_shape(lambda: jot.OmniGenTransformer(config=jot.OmniGenConfig()).init(
        jax.random.PRNGKey(0), **{k: jnp.zeros(*spec) for k, spec in example.items()}))
    total = sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree))
    assert sum(math.prod(s) for s in shapes.values()) == total == 3_762_020_368
    assert "omnigen" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), OmniGen)
    with pytest.raises(ValueError, match="flow-matching"):
        OmniGen(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 64).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 64).items()}
    assert dataclasses.asdict(model.flow_schedule_config()) == dataclasses.asdict(jmodel.flow_schedule_config())
    assert model.latent_channels == jmodel.latent_channels == 4


def test_sincos_table_and_position_crop_match_jax():
    """The float64 sincos table bitwise the JAX ``_sincos_2d``, and the
    module's centre crop at a square and a non-square grid bitwise the JAX
    module's slice."""
    assert np.array_equal(sincos_2d(64, 32), jot._sincos_2d(64, 32))
    module = OmniGenTransformer(OmniGenConfig.tiny(), dtype=torch.float32)
    table = jot._sincos_2d(64, 32).reshape(32, 32, -1)
    for gh, gw in ((4, 6), (16, 16), (32, 8)):
        top, left = (32 - gh) // 2, (32 - gw) // 2
        expected = table[top:top + gh, left:left + gw].reshape(gh * gw, -1)
        assert np.array_equal(module.position_table(gh, gw, torch.device("cpu")).numpy(), expected)


@pytest.mark.parametrize("padding", ["unmasked", "right", "left"])
def test_split_attention_block_matches_the_dense_mask(padding):
    """One block (2 query heads over 1 kv head, rank-4 adapters, f32): the
    image rows through the op and the prefix rows through the plain causal
    block against the JAX block's dense causal-plus-island mask, within
    ``F32_REL`` on every row that sees a key.  A left-padded caption's pads
    (the 3 before the first valid token) see no key: the JAX softmax averages
    every key there, the port gives 0 (ROADMAP Queue 3); those rows are the
    only ones apart."""
    cfg = OmniGenConfig.tiny()
    jcfg = jot.OmniGenConfig.tiny()
    rng = np.random.default_rng(1)
    txt, n_img = 8, 12
    seq = txt + 1 + n_img
    x = rng.standard_normal((2, seq, cfg.hidden_size)).astype(np.float32)
    hd = cfg.hidden_size // cfg.num_heads
    inv = 1.0 / (cfg.rope_base ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    emb = np.concatenate([np.outer(np.arange(seq, dtype=np.float32), inv)] * 2, -1)
    cos, sin = np.cos(emb)[None, :, None], np.sin(emb)[None, :, None]
    mask = _text_mask(padding, txt)
    causal = np.tril(np.ones((seq, seq), bool))
    img = np.arange(seq) >= seq - n_img
    dense = (causal | (img[:, None] & img[None, :]))[None]
    key_ok = None
    if mask is not None:
        key_ok = np.concatenate([mask.astype(bool), np.ones((2, 1 + n_img), bool)], 1)
        dense = dense & key_ok[:, None, :]
    dense = np.broadcast_to(dense, (2, seq, seq))[:, None]
    jblock = jot.OmniGenBlock(jcfg, dtype=jnp.float32, lora_rank=4)
    args = (jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(dense))
    variables = numpy_variables(jblock, *args, seed=2)
    ref = np.asarray(jblock.apply(jax.tree_util.tree_map(jnp.asarray, variables), *args))
    port = bridge(variables, OmniGenBlock(cfg, torch.float32, lora_rank=4))
    ok = None if key_ok is None else t(key_ok)
    with torch.no_grad():
        out = port(t(x), t(cos), t(sin), n_img, ok, key_mask_segments(ok)).numpy()
    sees = dense[:, 0].any(-1)  # (B, S): rows with at least one key
    assert rel(out[sees], ref[sees]) < F32_REL
    assert (~sees).sum() == (3 if padding == "left" else 0)
    if padding == "left":
        assert rel(out[~sees], ref[~sees]) > 1e-2


def test_prefix_attention_is_the_causal_masked_softmax():
    """``prefix_attention`` against a float64 causal softmax over the valid
    keys within 1e-6, and 0 on a row that sees no key."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 7, 3, 16)).astype(np.float32) for _ in range(3))
    key_ok = np.ones((2, 7), bool)
    key_ok[0, :2] = False
    out = prefix_attention(t(q), t(k), t(v), t(key_ok)).numpy()
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) / 4.0
    allowed = np.tril(np.ones((7, 7), bool))[None, None] & key_ok[:, None, None, :]
    p = np.where(allowed, np.exp(s - np.where(allowed, s, -np.inf).max(-1, keepdims=True, initial=-1e30)), 0.0)
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-300)
    ref = np.einsum("bhqk,bkhd->bqhd", p, v.astype(np.float64))
    assert np.abs(out - ref).max() < 1e-6 and not out[0, :2].any()


@pytest.mark.parametrize("variant", ["unmasked", "right", "left", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny DiT (f32, rank-4 adapters, GQA 2 over 1): unmasked, right-
    and left-padded captions, and right-padded under remat: the output within
    ``F32_REL``, the LoRA gradients of a seeded projection of it against
    ``jax.grad`` within ``GRAD_REL``, per adapter (the left-padded row the
    two sides compute apart reaches neither)."""
    cfg = OmniGenConfig.tiny()
    remat = variant == "remat"
    inputs = _inputs(cfg, "right" if remat else variant, seed=4)
    jmodule = jot.OmniGenTransformer(config=jot.OmniGenConfig.tiny(), dtype=jnp.float32, lora_rank=4, remat=remat)
    variables = _variables(jmodule, cfg, seed=5)
    port = bridge(variables, OmniGenTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    weight = np.random.default_rng(6).standard_normal(inputs["latents"].shape).astype(np.float32)
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
    assert sorted(flat) == sorted(adapters) and "layers_1/gate_up_proj/lora_B" in flat
    for path, param in adapters.items():
        assert rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_transformer_bf16_matches_jax():
    """The tiny DiT in bf16 (f32 adapters and norms), a right-padded
    caption, against the JAX module in bf16 on the same weights: within
    ``BF16_REL``."""
    cfg = OmniGenConfig.tiny()
    inputs = _inputs(cfg, "right", seed=7)
    jmodule = jot.OmniGenTransformer(config=jot.OmniGenConfig.tiny(), dtype=jnp.bfloat16, lora_rank=4)
    variables = _variables(jmodule, cfg, seed=8)
    port = bridge(variables, OmniGenTransformer(cfg, dtype=torch.bfloat16, lora_rank=4))
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                            **{k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}).numpy()
    assert out.dtype == ref.dtype == np.float32 and rel(out, ref) < BF16_REL


def test_family_prediction_text_and_cache_match_jax(tmp_path):
    """``get_model_inputs`` (1 - sigma, the ids, the mask) equal to the JAX
    family's; ``model_predict`` (negated) within ``F32_REL``; the tiny
    tokenizer's ids and masks at 120 tokens equal (one process, one salted
    hash); the collate equal; the payload's int32 ids and f32 mask through
    the port's cache and back bitwise, and read by the JAX cache bitwise;
    ``inference_conditioning`` keeps everything but the latents, as the JAX
    default does."""
    from simpletuner_tpu.caching.text_embeds import TextEmbeddingCache as JaxTextEmbeddingCache
    from simpletuner_tpu.data.backends.local import LocalDataBackend as JaxLocalDataBackend

    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend

    jmodel, model = _pair(_tiny_values())
    cfg = model.arch
    rng = np.random.default_rng(9)
    prepared = {"noisy_latents": rng.standard_normal((2, 8, 12, 4)).astype(np.float32),
                "timesteps": np.asarray([0.2, 0.7], np.float32),
                "input_ids": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32),
                "text_attention_mask": _text_mask("right")}
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

    prompts = ["a seeded photo of waves", "one", " ".join(f"w{i}" for i in range(130))]
    mine, jax_payloads = model.encode_text(prompts), jmodel.encode_text(prompts)
    for a, b in zip(mine, jax_payloads):
        assert sorted(a) == sorted(b) == ["input_ids", "text_attention_mask"]
        assert a["input_ids"].shape == (120,) and a["input_ids"].dtype == np.int32
        assert a["text_attention_mask"].dtype == np.float32
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    collated, jcollated = model.collate_text_embeds(mine), jmodel.collate_text_embeds(jax_payloads)
    for key in jcollated:
        np.testing.assert_array_equal(collated[key], jcollated[key])
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(tmp_path / "text"), "omnigen")
    cache.save(prompts[0], mine[0])
    jcache = JaxTextEmbeddingCache("embeds", JaxLocalDataBackend("embeds"), str(tmp_path / "text"), "omnigen")
    for loaded in (cache.load(prompts[0]), jcache.load(prompts[0])):
        for key in ("input_ids", "text_attention_mask"):
            value = np.asarray(loaded[key])
            assert value.dtype == mine[0][key].dtype and np.array_equal(value, mine[0][key]), key
    batch = {"latents": torch.zeros(1), "input_ids": torch.zeros(1), "text_attention_mask": torch.zeros(1)}
    assert sorted(model.inference_conditioning(batch)) == \
        sorted(jmodel.inference_conditioning(batch)) == ["input_ids", "text_attention_mask"]


def _jax_params(jmodel, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(jmodel.arch).items()}
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0), **example))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's file of a seeded tiny transformer (two shards):
    its names and shapes are the port's layout, the port's tree bitwise the
    ``params`` of the JAX ``load_omnigen_params`` variables (the patch conv
    read as the Dense; no sincos table in the file), the imported module
    bitwise the bridged JAX tree."""
    from test_torch_weight_import import _assert_trees_bitwise

    jmodel, model = _pair(_tiny_values())
    weights = export_omnigen_to_diffusers(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == omnigen_checkpoint_shapes(model.arch)
    root = tmp_path / "omnigen" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_params(jmodel, str(tmp_path / "omnigen"))["params"]
    _assert_trees_bitwise(load_omnigen_params(model, str(tmp_path / "omnigen")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "omnigen"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_no_key_map_so_adapter_files_carry_module_paths(tmp_path):
    """Quirk kept: OmniGen has no LoRA key map in either package, so an
    adapter file names each adapter by its flattened module path
    (``transformer.layers_0.to_q.lora_A.weight``); the port's file
    round-trips bitwise and loads into the JAX template bitwise.  The
    adapters sit on the blocks' six projections only."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.models.weight_import import load_safetensors_file
    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    assert _key_map_for(model) == jax_key_map_for(jmodel) == {}
    source = _seeded_adapters(model, 4, scale=0.05)
    assert sorted({p.split("/")[1] for p in tl.lora_parameters(source)}) == \
        ["down_proj", "gate_up_proj", "to_k", "to_out", "to_q", "to_v"]
    path = str(tmp_path / "adapter.safetensors")
    save_lora_safetensors(model, source, path)
    assert "transformer.layers_0.to_q.lora_A.weight" in load_safetensors_file(path)
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


def test_tokenizer_and_vae_quirks_match_jax(monkeypatch):
    """Quirks kept: without a pretrained path the published preset's
    ``encode_text`` asks ``AutoTokenizer`` for the hub id's ``tokenizer``
    subfolder (a download, which an offline run refuses), as the JAX family
    does; the trainer builds the SD VAE (scaling 0.18215 in the cache) while
    validation divides by 0.13025 (ROADMAP Queue 3)."""
    import transformers

    from simpletuner_tpu_torch.models.vae import VAEConfig

    calls = []
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda path, **kw: calls.append((path, kw)) or (_ for _ in ()).throw(OSError)))
    model = OmniGen(config_namespace({**_tiny_values(), "model_arch_preset": None}))
    with pytest.raises(OSError):
        model.encode_text(["a cat"])
    assert calls == [("Shitao/OmniGen-v1-diffusers", {"subfolder": "tokenizer"})]
    assert VAEConfig().scaling_factor == 0.18215 and OmniGen.VAE_SCALING_FACTOR == 0.13025


def test_cfg_render_without_a_text_encoder_matches_jax(monkeypatch):
    """A true-CFG render through each package's ``Validation`` with no text
    encoder attached (the family's spec is empty): the prompt and the
    negative prompt tokenised by the family itself (one process, one salted
    hash), the same weights and noise, 6 guided flow Euler steps; the
    latents within the render tolerance of test_torch_inference.py (f32, sum
    order only)."""
    from simpletuner_tpu.training.validation import Validation as JaxValidation

    from simpletuner_tpu_torch.training.validation import Validation, noise_generator

    config = {**_tiny_values(), "model_type": "full", "validation_prompt": "a lighthouse at dusk",
              "validation_negative_prompt": "blurry", "validation_guidance": 3.0,
              "validation_num_inference_steps": 6, "validation_resolution": 64, "validation_seed": 7}
    jmodel, model = JaxOmniGen(JaxTrainingConfig(config)), OmniGen(config_namespace(config))
    assert model.text_encoders == [] and not getattr(jmodel, "text_encoders", [])
    variables = _variables(jmodel.module, model.arch, seed=11)
    module = bridge(variables, model.create_module())
    validation = Validation(model, config_namespace(config), device="cpu")
    validation.precompute_embeds()
    assert validation._wants_cfg() and validation._negative_embeds is not None
    out = validation._render_single(module, validation._embeds[0], 0)  # no decode_fn: the latents
    noise = torch.randn((1, 8, 8, 4), generator=noise_generator(7, 0)).numpy()
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    jvalidation = JaxValidation(jmodel, JaxTrainingConfig(config))
    jvalidation.precompute_embeds()
    for ours, theirs in ((validation._embeds[0], jvalidation._embeds[0]),
                         (validation._negative_embeds, jvalidation._negative_embeds)):
        for key in ("input_ids", "text_attention_mask"):
            np.testing.assert_array_equal(ours[key], theirs[key])
    ref = np.asarray(jvalidation._render_single(variables, jvalidation._embeds[0], 0))
    assert out.shape == ref.shape == (8, 8, 4) and rel(out, ref) < 1e-4
