"""The torch port's Anima family against the JAX package, on the CPU.

The presets, the adapter's rope tables, the LLM adapter (the T5-id table
read as ``jnp.take`` reads it), the adapter and Cosmos core together with
LoRA gradients against ``jax.grad`` (per-token T5 weights, remat) and in
bf16; the family contract (the one-frame clip, ``encode_text`` with the
hash ids and with a tokenizer in ``tokenizer/``, the collate); the import of
the JAX exporter's file, the key map and adapter files.  The trainer's
trajectory is in test_torch_cosmos_anima_krea2_trainer.py.  Every tolerance
is stated where it is checked.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.anima import transformer as jat
from simpletuner_tpu.models.anima.model import Anima as JaxAnima
from simpletuner_tpu.models.weight_export import export_anima_to_checkpoint
from simpletuner_tpu.models.weight_import import load_anima_params as jax_load_params
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.anima import Anima, AnimaConfig, AnimaTransformer
from simpletuner_tpu_torch.models.anima.transformer import AnimaLLMAdapter, adapter_rope
from simpletuner_tpu_torch.models.checkpoint_layouts import anima_checkpoint_shapes
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_anima_params, load_transformer_params
from simpletuner_tpu_torch.training.lora import _key_map_for, anima_key_map

from test_torch_qwen_image import _StandIn
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
    return {"model_family": "anima", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxAnima(JaxTrainingConfig(values)), Anima(config_namespace(values))


def _inputs(cfg, seed=0, t5_len=9, weights=False):
    rng = np.random.default_rng(seed)
    out = {
        "latents": rng.standard_normal((2, 1, 8, 12, cfg.core.in_channels), dtype=np.float32),
        "timesteps": np.asarray([0.13, 0.91], np.float32),
        "text_embeds": rng.standard_normal((2, 7, cfg.adapter_dim), dtype=np.float32),
        "t5_ids": rng.integers(0, cfg.adapter_vocab_size, (2, t5_len)).astype(np.int32),
    }
    if weights:
        out["t5_weights"] = rng.uniform(0.5, 1.5, (2, t5_len)).astype(np.float32)
    return out


def _variables(jmodule, cfg, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(cfg).items()}
    return numpy_variables(jmodule, **example, seed=seed)


def test_presets_and_contract_match_jax():
    """The presets (tiny, and the published one: a 1024-wide, 6-layer adapter
    over 32,128 T5 ids, padded to 512, on the 2B Cosmos core; 2.09B
    parameters in the checkpoint layout and the JAX tree), the family's
    constants, spec and example batch as the JAX family's; a non-flow
    prediction type is refused."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "LATENT_CHANNEL_COUNT"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    for ours, theirs in ((AnimaConfig.tiny(), jat.AnimaConfig.tiny()), (AnimaConfig(), jat.AnimaConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    full = Anima(config_namespace({**_tiny_values(), "model_arch_preset": None})).arch
    assert sum(math.prod(s) for s in anima_checkpoint_shapes(full).values()) == 2_091_068_928
    example = {k: (v.shape, v.dtype) for k, v in _inputs(full).items()}
    tree = jax.eval_shape(lambda: jat.AnimaTransformer(config=jat.AnimaConfig()).init(
        jax.random.PRNGKey(0), **{k: jnp.zeros(*spec) for k, spec in example.items()}))
    assert sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree)) == 2_091_068_928
    assert "anima" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), Anima)
    with pytest.raises(ValueError, match="flow-matching"):
        Anima(config_namespace(_tiny_values(prediction_type="sample"))).check_user_config()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 64).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 64).items()}


def test_adapter_rope_matches_jax_bitwise():
    """The adapter's half-repeated rope tables (float64, then f32) bitwise
    the JAX ``_adapter_rope`` at the published head dim 64 over 64 and 256
    tokens."""
    for length in (64, 256):
        for a, b in zip(adapter_rope(length, 64), jat._adapter_rope(length, 64)):
            assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))


def test_llm_adapter_and_its_id_table_match_jax():
    """The adapter (f32) within ``F32_REL`` of the JAX module; the T5-id
    table reads as ``jnp.take`` does: an id past the table gives NaN rows
    (which the attentions spread to the whole caption) and a negative one
    wraps, in both packages."""
    cfg = AnimaConfig.tiny()
    rng = np.random.default_rng(1)
    source = rng.standard_normal((2, 7, cfg.adapter_dim)).astype(np.float32)
    ids = rng.integers(0, cfg.adapter_vocab_size, (2, 9)).astype(np.int32)
    jadapter = jat.AnimaLLMAdapter(jat.AnimaConfig.tiny(), dtype=jnp.float32)
    variables = numpy_variables(jadapter, jnp.asarray(source), jnp.asarray(ids), seed=2)
    port = bridge(variables, AnimaLLMAdapter(cfg, torch.float32))
    apply = jax.jit(jadapter.apply)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    with torch.no_grad():
        assert rel(port(t(source), t(ids)).numpy(), np.asarray(apply(jvars, jnp.asarray(source),
                                                                       jnp.asarray(ids)))) < F32_REL
        wild = ids.copy()
        wild[0, 3], wild[1, 0] = cfg.adapter_vocab_size + 5, -2
        ours = port(t(source), t(wild)).numpy()
        theirs = np.asarray(apply(jvars, jnp.asarray(source), jnp.asarray(wild)))
        assert np.isnan(ours[0]).all() and np.isnan(theirs[0]).all()
        assert np.isfinite(ours[1]).all() and rel(ours[1], theirs[1]) < F32_REL
        table = port.embed.numpy()
        rows = port.embed_ids(t(np.asarray([[cfg.adapter_vocab_size - 1, -1, cfg.adapter_vocab_size]]))).numpy()
        assert np.array_equal(rows[0, 0], table[-1]) and np.array_equal(rows[0, 1], table[-1])
        assert np.isnan(rows[0, 2]).all()


@pytest.mark.parametrize("variant", ["plain", "t5_weights", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """Adapter and core (f32, rank-4 adapters on the core only): the output
    within ``F32_REL``, the LoRA gradients of a seeded projection of it
    against ``jax.grad`` within ``GRAD_REL``, per adapter; the adapter's
    output padded with zeros to ``adapter_pad_length`` (16) tokens; with
    per-token T5 weights and under remat."""
    cfg = AnimaConfig.tiny()
    remat = variant == "remat"
    inputs = _inputs(cfg, seed=3, weights=variant == "t5_weights")
    jmodule = jat.AnimaTransformer(config=jat.AnimaConfig.tiny(), dtype=jnp.float32, lora_rank=4, remat=remat)
    variables = _variables(jmodule, cfg, seed=4)
    port = bridge(variables, AnimaTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    weight = np.random.default_rng(5).standard_normal(inputs["latents"].shape).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jargs = {k: jnp.asarray(v) for k, v in inputs.items()}

    def jax_loss(lora):
        out = jmodule.apply({"params": params, "lora": lora}, **jargs)
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(port)
    seen = {}
    hook = port.core.register_forward_pre_hook(lambda m, args: seen.update(context=args[2]))
    out = port(**{k: t(v) for k, v in inputs.items()})
    hook.remove()
    assert tuple(seen["context"].shape) == (2, 16, 32) and not seen["context"][:, 9:].any()
    assert tuple(out.shape) == ref.shape and rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and all(k.startswith("core/") for k in flat)
    for path, param in adapters.items():
        assert rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_transformer_bf16_matches_jax():
    """Adapter and core in bf16 against the JAX module in bf16 on the same
    weights: within ``BF16_REL``."""
    cfg = AnimaConfig.tiny()
    inputs = _inputs(cfg, seed=6)
    jmodule = jat.AnimaTransformer(config=jat.AnimaConfig.tiny(), dtype=jnp.bfloat16, lora_rank=4)
    variables = _variables(jmodule, cfg, seed=7)
    port = bridge(variables, AnimaTransformer(cfg, dtype=torch.bfloat16, lora_rank=4))
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                            **{k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}).numpy()
    assert out.dtype == ref.dtype == np.float32 and rel(out, ref) < BF16_REL


def test_family_prediction_matches_jax():
    """``get_model_inputs`` (the one-frame clip, int32 ids) and
    ``model_predict`` within ``F32_REL`` of the JAX family; the render
    conditioning carries the states and the ids."""
    jmodel, model = _pair(_tiny_values())
    cfg = model.arch
    rng = np.random.default_rng(8)
    prepared = {"noisy_latents": rng.standard_normal((2, 8, 12, 4)).astype(np.float32),
                "timesteps": np.asarray([0.3, 0.8], np.float32),
                "text_embeds": rng.standard_normal((2, 7, 32)).astype(np.float32),
                "t5_ids": rng.integers(0, cfg.adapter_vocab_size, (2, 16)).astype(np.int32)}
    ours = model.get_model_inputs({k: t(v) for k, v in prepared.items()})
    theirs = jmodel.get_model_inputs({k: jnp.asarray(v) for k, v in prepared.items()})
    assert sorted(ours) == sorted(theirs) and tuple(ours["latents"].shape) == (2, 1, 8, 12, 4)
    for key in ours:
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    jmodule = jmodel.create_module()
    variables = _variables(jmodule, cfg, seed=9)
    module = bridge(variables, model.create_module())
    with torch.no_grad():
        out = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
    ref = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                   jax.tree_util.tree_map(jnp.asarray, prepared)))
    assert out.shape == ref.shape == (2, 8, 12, 4) and rel(out, ref) < F32_REL
    assert sorted(model.inference_conditioning(prepared)) == sorted(jmodel.inference_conditioning(prepared)) == \
        ["t5_ids", "text_embeds"]


def _write_word_tokenizer(root, vocab_size):
    """A word-level tokenizer in ``root/tokenizer`` whose ids run to ``vocab_size``."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ["<pad>", "<unk>"] + [f"w{i}" for i in range(vocab_size - 2)]
    tokenizer = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tokenizer.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    folder = root / "tokenizer"
    folder.mkdir(parents=True)
    tokenizer.save(str(folder / "tokenizer.json"))
    (folder / "tokenizer_config.json").write_text(json.dumps({"model_max_length": 512, "unk_token": "<unk>", "pad_token": "<pad>",
                                                               "tokenizer_class": "PreTrainedTokenizerFast"}))


def test_encode_text_ids_and_the_shared_tokenizer_folder_match_jax(tmp_path):
    """``encode_text`` keeps Qwen's final state and mask and gives the T5
    ids as the JAX family: without a model dir the salted ``hash`` of each
    word (equal within one process), capped at min(16, 64) tokens and
    zero-padded; with a tokenizer in the dir's ``tokenizer/`` (the folder the
    Qwen encoder reads too) its ids, which may pass the adapter's table.
    The collate drops the mask.  Quirk kept (ROADMAP Queue 3): ids past the
    table give a NaN prediction in both packages."""
    states = {"last_hidden_state": np.random.default_rng(10).standard_normal((2, 7, 32)).astype(np.float32),
              "attention_mask": (np.arange(7)[None] < np.asarray([[7], [3]])).astype(np.int32)}
    prompts = ["w3 w70 w5 " + " ".join(f"w{i}" for i in range(20)), "w1 w2"]
    for directory in (None, tmp_path / "anima"):
        values = _tiny_values()
        if directory is not None:
            _write_word_tokenizer(directory, 100)
            values["pretrained_model_name_or_path"] = str(directory)
        jmodel, model = _pair(values)
        for m in (jmodel, model):
            m.attach_text_encoders([_StandIn(states)])
        ours, theirs = model.encode_text(prompts), jmodel.encode_text(prompts)
        for a, b in zip(ours, theirs):
            assert sorted(a) == sorted(b) == ["attention_mask", "t5_ids", "text_embeds"]
            assert a["t5_ids"].shape == (16,) and a["t5_ids"].dtype == np.int32
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert sorted(model.collate_text_embeds(ours)) == sorted(jmodel.collate_text_embeds(theirs)) == \
            ["t5_ids", "text_embeds"]
    assert ours[0]["t5_ids"][1] == 72 and ours[0]["t5_ids"].max() >= model.arch.adapter_vocab_size
    collated = model.collate_text_embeds(ours)
    variables = _variables(jmodel.create_module(), model.arch, seed=11)
    module = bridge(variables, model.create_module())
    prepared = {"noisy_latents": np.zeros((2, 8, 8, 4), np.float32), "timesteps": np.asarray([0.5, 0.5], np.float32),
                **collated}
    with torch.no_grad():
        out = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
    ref = np.asarray(jmodel.model_predict(jax.tree_util.tree_map(jnp.asarray, variables),
                                          jax.tree_util.tree_map(jnp.asarray, prepared)))
    assert np.isnan(out[0]).all() and np.isnan(ref[0]).all() and rel(out[1], ref[1]) < F32_REL


def _jax_params(jmodel, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(jmodel.arch).items()}
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0), **example))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's file of a seeded tiny Anima (two shards): its
    names and shapes are the port's layout (the adapter, the ``core.``
    prefix), the port's tree bitwise the JAX ``load_anima_params`` tree, the
    imported module bitwise the bridged JAX tree."""
    jmodel, model = _pair(_tiny_values())
    weights = export_anima_to_checkpoint(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == anima_checkpoint_shapes(model.arch)
    root = tmp_path / "anima" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_params(jmodel, str(tmp_path / "anima"))
    _assert_trees_bitwise(load_anima_params(model, str(tmp_path / "anima")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "anima"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_key_map_and_adapter_file_match_jax(tmp_path):
    """``anima_key_map`` equals the JAX map (the core under ``core.``, the
    adapter unmapped: it has no LoRA); an adapter file written by the port
    round-trips bitwise and loads into the JAX template bitwise."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    assert _key_map_for(model) == JAX_KEY_MAPS["anima"](jmodel) == anima_key_map(model.arch)
    assert all(k.startswith("core/") for k in anima_key_map(model.arch))
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
