"""The torch port's decoder-LLM text encoder against the JAX package, on the CPU.

``models/llm_encoder.py`` (all five layouts at their tiny configs: Gemma-2's
sandwich norms, unit-offset scales, embedding scale and softcap; Qwen2's
qkv biases; ChatGLM's fused qkv, fused gate/up and partial interleaved
RoPE; Llama and Mistral), the ``gemma2_2b`` preset's shapes,
``llm_params_from_hf`` on seeded HF-layout tensors, and the text-encoder
wrapper (``LLMTextEncoder.encode`` with its pooled last-valid-token state,
``encode_with_hidden_states``, the builder for every family name, and the
build from an HF dir with its ``config.json`` and tokenizer).  The same
seeded numpy weights and token ids go through both packages; every
tolerance is stated where it is checked.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.models import text_encoders as jax_te
from simpletuner_tpu.models.common import TextEncoderSpec as JaxSpec
from simpletuner_tpu.models.llm_encoder import LLMEncoder as JaxLLMEncoder
from simpletuner_tpu.models.llm_encoder import LLMEncoderConfig as JaxLLMConfig
from simpletuner_tpu.models.llm_encoder import llm_params_from_hf as jax_llm_params_from_hf

from simpletuner_tpu_torch.models import text_encoders as te
from simpletuner_tpu_torch.models.checkpoint_layouts import llm_checkpoint_shapes
from simpletuner_tpu_torch.models.common import TextEncoderSpec
from simpletuner_tpu_torch.models.llm_encoder import LLMEncoder, LLMEncoderConfig, llm_params_from_hf

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, numpy_variables, rel, t

ARCHES = ("gemma2", "qwen2", "llama", "mistral", "chatglm")
PRESETS = ("gemma2_2b", "qwen25_7b", "llama3_8b", "mistral3_24b", "chatglm3_6b")
# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# the default bf16 compute on both sides: each product and the residual
# stream round to bf16 (2^-8) per layer, in another order on each side
BF16_REL = 2e-2
PROMPTS = ["a lighthouse on a basalt cliff at dusk", "", "portrait of a cat in the rain"]


def _ids(cfg, batch=2, seq=10, pad_last=3):
    rng = np.random.default_rng(0)
    ids = rng.integers(1, cfg.vocab_size, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.int32)
    mask[1, -pad_last:] = 0
    return ids, mask


def test_presets_match_jax():
    for arch in ARCHES:
        assert dataclasses.asdict(LLMEncoderConfig.tiny(arch)) == dataclasses.asdict(JaxLLMConfig.tiny(arch)), arch
    for name in PRESETS:
        assert dataclasses.asdict(getattr(LLMEncoderConfig, name)()) == \
            dataclasses.asdict(getattr(JaxLLMConfig, name)()), name


def test_gemma2_2b_shapes_match_jax():
    """The published Gemma-2 2B (2304 wide, 8 heads of 256, 4 kv heads,
    256,000 tokens, 26 layers): every port tensor has the shape of its JAX
    leaf (``jax.eval_shape``, no init runs), the HF layout holds 2.61B
    parameters, 590M of them the embedding, and maps onto the JAX tree."""
    cfg = LLMEncoderConfig.gemma2_2b()
    shapes = jax.eval_shape(lambda: JaxLLMEncoder(JaxLLMConfig.gemma2_2b()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    with torch.device("meta"):
        port = LLMEncoder(cfg)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    ours = {name.replace(".", "/").replace("/weight", "/kernel"): tuple(p.shape) for name, p in port.named_parameters()}
    assert sorted(ours) == sorted(flat)
    for name, shape in ours.items():
        assert shape == (tuple(reversed(flat[name])) if name.endswith("kernel") else flat[name]), name
    hf = llm_checkpoint_shapes(cfg)
    total = sum(int(np.prod(s)) for s in hf.values())
    assert total == sum(p.numel() for p in port.parameters()) == 2_614_341_888
    assert hf["model.embed_tokens.weight"] == (256000, 2304) and len(hf) == 2 + 26 * 11


@pytest.mark.parametrize("arch", ARCHES)
def test_encoder_matches_jax(arch):
    """A tiny trunk (f32) on the same seeded weights and ids, one row padded:
    the final-norm states within ``F32_REL``, and every tap (the scaled
    embeddings and each block's output) likewise."""
    cfg = LLMEncoderConfig.tiny(arch)
    ids, mask = _ids(cfg)
    jmodule = JaxLLMEncoder(JaxLLMConfig.tiny(arch), dtype=jnp.float32)
    variables = numpy_variables(jmodule, jnp.asarray(ids), jnp.asarray(mask), seed=2)
    port = bridge(variables, LLMEncoder(cfg, dtype=torch.float32))
    ref, ref_taps = jmodule.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(ids),
                                  jnp.asarray(mask), output_hidden_states=True)
    with torch.no_grad():
        out, taps = port(t(ids), t(mask), output_hidden_states=True)
    assert tuple(out.shape) == ref.shape == (2, 10, cfg.hidden_size) and len(taps) == len(ref_taps) == 3
    assert rel(out.numpy(), ref) < F32_REL
    for a, b in zip(taps, ref_taps):
        assert rel(a.numpy(), b) < F32_REL


def test_bf16_compute_matches_jax():
    """The default compute dtype (bf16 products, f32 norms and attention) on
    both sides, Gemma-2's tiny layout: within ``BF16_REL``."""
    cfg = LLMEncoderConfig.tiny("gemma2")
    ids, mask = _ids(cfg)
    jmodule = JaxLLMEncoder(JaxLLMConfig.tiny("gemma2"))
    variables = numpy_variables(jmodule, jnp.asarray(ids), jnp.asarray(mask), seed=3)
    port = bridge(variables, LLMEncoder(cfg))
    assert port.embed_tokens.dtype == port.layers_0.q_proj.weight.dtype == torch.bfloat16
    assert port.layers_0.input_norm.scale.dtype == torch.float32
    ref = np.asarray(jmodule.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(ids),
                                   jnp.asarray(mask)), np.float32)
    with torch.no_grad():
        out = port(t(ids), t(mask))
    assert out.dtype == torch.bfloat16 and rel(out.float().numpy(), ref) < BF16_REL


@pytest.mark.parametrize("arch", ARCHES)
def test_params_from_hf_match_jax_bitwise(arch):
    """``llm_params_from_hf`` on one seeded HF-layout state (qkv biases
    where the layout has them): the port's tree (transposed views of the
    file's tensors) bitwise the JAX tree, and the names and shapes are
    ``llm_checkpoint_shapes``."""
    cfg = LLMEncoderConfig.tiny(arch)
    shapes = llm_checkpoint_shapes(cfg)
    rng = np.random.default_rng(4)
    weights = {name: rng.standard_normal(shape).astype(np.float32) for name, shape in shapes.items()}
    theirs = jax_llm_params_from_hf(weights, JaxLLMConfig.tiny(arch))
    ours = llm_params_from_hf({k: torch.from_numpy(v) for k, v in weights.items()}, cfg)
    _assert_trees_bitwise(ours, theirs)
    with torch.no_grad():
        port = bridge({"params": ours}, LLMEncoder(cfg, dtype=torch.float32))
    assert torch.equal(port.embed_tokens, t(weights[next(k for k in shapes if "embed" in k)]))


# ---- the text-encoder wrapper ---------------------------------------------------------------------


def _gemma_tokenizer(root, words):
    """A word-level tokenizer in Gemma's convention (``<pad>`` 0, ``<eos>`` 1,
    ``<bos>`` 2 prepended), as ``AutoTokenizer`` reads a ``tokenizer.json``."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors

    vocab = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "<unk>": 3}
    for word in sorted({w.lower() for w in words}):
        vocab.setdefault(word, len(vocab))
    tokenizer = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tokenizer.normalizer = normalizers.Lowercase()
    tokenizer.pre_tokenizer = pre_tokenizers.Whitespace()
    tokenizer.post_processor = processors.TemplateProcessing(single="<bos> $A", special_tokens=[("<bos>", 2)])
    os.makedirs(root, exist_ok=True)
    tokenizer.save(os.path.join(root, "tokenizer.json"))
    with open(os.path.join(root, "tokenizer_config.json"), "w") as handle:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "model_max_length": 256, "pad_token": "<pad>",
                   "eos_token": "<eos>", "bos_token": "<bos>", "unk_token": "<unk>", "padding_side": "right"},
                  handle)


@pytest.mark.parametrize("family", sorted(jax_te._LLM_ARCHES))
def test_every_llm_family_builds_an_llm_text_encoder(family):
    """Every decoder-LLM family name the JAX builder table registers builds
    the port's ``LLMTextEncoder`` of the same layout (tiny, seeded)."""
    assert te._LLM_ARCHES == jax_te._LLM_ARCHES and te._LLM_PRESETS == jax_te._LLM_PRESETS
    (encoder,) = te.load_text_encoders([TextEncoderSpec(name=family, family=family, max_length=12)], tiny=True,
                                       device="cpu")
    assert isinstance(encoder, te.LLMTextEncoder)
    assert dataclasses.asdict(encoder.config) == dataclasses.asdict(JaxLLMConfig.tiny(jax_te._LLM_ARCHES[family]))
    out = encoder.encode(PROMPTS[:2])
    assert out["last_hidden_state"].shape == (2, 12, 32) and np.isfinite(out["last_hidden_state"]).all()


def test_encode_and_hidden_states_match_jax():
    """``encode`` (the final-norm states, the mask, the pooled state of each
    prompt's last valid token; the empty prompt's is its eos token's) and
    ``encode_with_hidden_states`` (3 taps at 2 layers) of the tiny Gemma-2
    encoder, both packages in f32 on the same weights: within ``F32_REL``,
    the masks equal."""
    spec, jspec = (cls(name="gemma-2", family="gemma-2", subfolder="text_encoder", max_length=16)
                   for cls in (TextEncoderSpec, JaxSpec))
    (jenc,) = jax_te.load_text_encoders([jspec], tiny=True)
    jenc.module = JaxLLMEncoder(jenc.config, dtype=jnp.float32)  # read when the encode is traced
    variables = numpy_variables(jenc.module, jnp.zeros((1, 8), jnp.int32), seed=5)
    jenc.params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    port = bridge(variables, LLMEncoder(LLMEncoderConfig.tiny("gemma2"), dtype=torch.float32))
    enc = te.LLMTextEncoder(spec, port, jenc.tokenizer)  # one tokenizer: the tiny one's ids are per process
    ours, theirs = enc.encode(PROMPTS), jenc.encode(PROMPTS)
    assert sorted(ours) == sorted(theirs) == ["attention_mask", "last_hidden_state", "pooled"]
    np.testing.assert_array_equal(ours["attention_mask"], theirs["attention_mask"])
    assert ours["last_hidden_state"].shape == (3, 16, 32) and ours["pooled"].shape == (3, 32)
    for key in ("last_hidden_state", "pooled"):
        assert rel(ours[key], theirs[key]) < F32_REL, key
    last = ours["attention_mask"].sum(1) - 1
    np.testing.assert_array_equal(ours["pooled"], ours["last_hidden_state"][np.arange(3), last])
    ours, theirs = enc.encode_with_hidden_states(PROMPTS), jenc.encode_with_hidden_states(PROMPTS)
    assert len(ours["hidden_states"]) == len(theirs["hidden_states"]) == 3
    assert rel(ours["last_hidden_state"], theirs["last_hidden_state"]) < F32_REL
    for a, b in zip(ours["hidden_states"], theirs["hidden_states"]):
        assert rel(a, b) < F32_REL


def test_build_from_an_hf_dir_matches_jax(tmp_path):
    """A seeded Gemma-2 (the tiny layout's sizes) in the HF layout in
    ``text_encoder/`` with its ``config.json``, and a tokenizer in
    ``tokenizer/``: both packages' builders read the config onto the preset
    and the same tokens, and encode (bf16 compute, the default) within
    ``BF16_REL``."""
    cfg = LLMEncoderConfig.tiny("gemma2")
    rng = np.random.default_rng(6)
    weights = {}
    for name, shape in llm_checkpoint_shapes(cfg).items():
        draw = rng.standard_normal(shape).astype(np.float32)
        weights[name] = (0.1 * draw if len(shape) == 1 else draw / np.sqrt(shape[-1])).astype(np.float32)
    os.makedirs(tmp_path / "text_encoder")
    np_save_file(weights, str(tmp_path / "text_encoder" / "model.safetensors"))
    with open(tmp_path / "text_encoder" / "config.json", "w") as handle:
        json.dump({"model_type": "gemma2", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
                   "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
                   "query_pre_attn_scalar": cfg.head_dim}, handle)
    _gemma_tokenizer(str(tmp_path / "tokenizer"), " ".join(PROMPTS).split())
    spec, jspec = (cls(name="gemma-2", family="gemma-2", subfolder="text_encoder", max_length=12)
                   for cls in (TextEncoderSpec, JaxSpec))
    (enc,) = te.load_text_encoders([spec], pretrained_path=str(tmp_path), device="cpu")
    (jenc,) = jax_te.load_text_encoders([jspec], pretrained_path=str(tmp_path))
    expected = dataclasses.replace(LLMEncoderConfig.gemma2_2b(), vocab_size=1000, hidden_size=32,
                                   intermediate_size=64, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=16)
    assert dataclasses.asdict(enc.config) == dataclasses.asdict(jenc.config) == dataclasses.asdict(expected)
    ours, theirs = enc.encode(PROMPTS), jenc.encode(PROMPTS)
    np.testing.assert_array_equal(ours["attention_mask"], theirs["attention_mask"])
    assert ours["attention_mask"][1].sum() == 1 and ours["attention_mask"][0].sum() == 9  # <bos> + 8 words
    for key in ("last_hidden_state", "pooled"):
        assert rel(ours[key], theirs[key]) < BF16_REL, key


def test_build_from_a_qwen25_vl_dir_matches_jax(tmp_path):
    """A seeded Qwen2 trunk (the tiny layout's sizes) in the Qwen2.5-VL HF
    layout: ``text_encoder/config.json`` with the text sizes as top-level
    keys beside ``vision_config`` and the mrope ``rope_scaling`` (as
    Qwen/Qwen2.5-VL-7B-Instruct's), ``model.*`` tensors with qkv biases plus
    ``visual.*`` and ``lm_head`` tensors that neither importer reads, and a
    tokenizer in ``tokenizer/``; built through the ``qwen2.5-vl`` spec that
    kandinsky5 and hunyuanvideo name: both packages read the config onto the
    ``qwen25_7b`` preset, take the same tokens and encode (bf16 compute)
    within ``BF16_REL``.  With text-only positions the mrope sections are
    the 1-D rope, which both modules run."""
    cfg = LLMEncoderConfig.tiny("qwen2")
    rng = np.random.default_rng(8)
    weights = {}
    for name, shape in llm_checkpoint_shapes(cfg).items():
        draw = rng.standard_normal(shape).astype(np.float32)
        weights[name] = (0.1 * draw if len(shape) == 1 else draw / np.sqrt(shape[-1])).astype(np.float32)
    assert "model.layers.0.self_attn.q_proj.bias" in weights
    weights["visual.patch_embed.proj.weight"] = rng.standard_normal((16, 3, 2, 14, 14)).astype(np.float32)
    weights["lm_head.weight"] = rng.standard_normal((cfg.vocab_size, cfg.hidden_size)).astype(np.float32)
    os.makedirs(tmp_path / "text_encoder")
    np_save_file(weights, str(tmp_path / "text_encoder" / "model.safetensors"))
    with open(tmp_path / "text_encoder" / "config.json", "w") as handle:
        json.dump({"architectures": ["Qwen2_5_VLForConditionalGeneration"], "model_type": "qwen2_5_vl",
                   "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
                   "rope_theta": 1000000.0, "rms_norm_eps": cfg.rms_eps,
                   "rope_scaling": {"type": "mrope", "mrope_section": [2, 3, 3]},
                   "vision_config": {"hidden_size": 16, "depth": 1, "out_hidden_size": cfg.hidden_size}}, handle)
    _gemma_tokenizer(str(tmp_path / "tokenizer"), " ".join(PROMPTS).split())
    spec, jspec = (cls(name="qwen2.5-vl", family="qwen2.5-vl", subfolder="text_encoder", max_length=12)
                   for cls in (TextEncoderSpec, JaxSpec))
    (enc,) = te.load_text_encoders([spec], pretrained_path=str(tmp_path), device="cpu")
    (jenc,) = jax_te.load_text_encoders([jspec], pretrained_path=str(tmp_path))
    expected = dataclasses.replace(LLMEncoderConfig.qwen25_7b(), vocab_size=1000, hidden_size=32,
                                   intermediate_size=64, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=16,
                                   rope_theta=1000000.0)
    assert dataclasses.asdict(enc.config) == dataclasses.asdict(jenc.config) == dataclasses.asdict(expected)
    assert enc.config.qkv_bias and enc.config.arch == "qwen2"
    ours, theirs = enc.encode(PROMPTS), jenc.encode(PROMPTS)
    np.testing.assert_array_equal(ours["attention_mask"], theirs["attention_mask"])
    for key in ("last_hidden_state", "pooled"):
        assert rel(ours[key], theirs[key]) < BF16_REL, key


def test_build_from_a_llama3_dir_matches_jax(tmp_path):
    """A seeded Llama trunk (the tiny layout's sizes) in the Llama-3.1 HF
    layout: ``text_encoder_4/config.json`` (``LlamaForCausalLM`` with the
    llama3 ``rope_scaling``, as meta-llama/Llama-3.1-8B-Instruct's) beside
    ``model.*`` tensors without biases and an ``lm_head`` that neither
    importer reads, and a tokenizer in ``tokenizer/`` (the spec names no
    tokenizer subfolder); built through the ``llama-3`` spec that hidream
    names: both packages read the config onto the ``llama3_8b`` preset, take
    the same tokens and encode (bf16 compute) within ``BF16_REL``."""
    cfg = LLMEncoderConfig.tiny("llama")
    rng = np.random.default_rng(9)
    weights = {}
    for name, shape in llm_checkpoint_shapes(cfg).items():
        draw = rng.standard_normal(shape).astype(np.float32)
        weights[name] = (0.1 * draw if len(shape) == 1 else draw / np.sqrt(shape[-1])).astype(np.float32)
    assert "model.layers.0.self_attn.q_proj.bias" not in weights
    weights["lm_head.weight"] = rng.standard_normal((cfg.vocab_size, cfg.hidden_size)).astype(np.float32)
    os.makedirs(tmp_path / "text_encoder_4")
    np_save_file(weights, str(tmp_path / "text_encoder_4" / "model.safetensors"))
    with open(tmp_path / "text_encoder_4" / "config.json", "w") as handle:
        json.dump({"architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim, "rope_theta": 500000.0,
                   "rms_norm_eps": 1e-5, "rope_scaling": {"rope_type": "llama3", "factor": 8.0}}, handle)
    _gemma_tokenizer(str(tmp_path / "tokenizer"), " ".join(PROMPTS).split())
    spec, jspec = (cls(name="llama", family="llama-3", subfolder="text_encoder_4", max_length=12,
                       output="hidden_states") for cls in (TextEncoderSpec, JaxSpec))
    (enc,) = te.load_text_encoders([spec], pretrained_path=str(tmp_path), device="cpu")
    (jenc,) = jax_te.load_text_encoders([jspec], pretrained_path=str(tmp_path))
    expected = dataclasses.replace(LLMEncoderConfig.llama3_8b(), vocab_size=1000, hidden_size=32,
                                   intermediate_size=64, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=16,
                                   rope_theta=500000.0, rms_eps=1e-5)
    assert dataclasses.asdict(enc.config) == dataclasses.asdict(jenc.config) == dataclasses.asdict(expected)
    assert not enc.config.qkv_bias and enc.config.arch == "llama"
    ours, theirs = enc.encode(PROMPTS), jenc.encode(PROMPTS)
    np.testing.assert_array_equal(ours["attention_mask"], theirs["attention_mask"])
    assert "hidden_states" not in ours and "hidden_states" not in theirs  # HiDream stacks the final state alone
    for key in ("last_hidden_state", "pooled"):
        assert rel(ours[key], theirs[key]) < BF16_REL, key


def _hf_weights(cfg, seed):
    rng = np.random.default_rng(seed)
    weights = {}
    for name, shape in llm_checkpoint_shapes(cfg).items():
        draw = rng.standard_normal(shape).astype(np.float32)
        weights[name] = (0.1 * draw if len(shape) == 1 else draw / np.sqrt(shape[-1])).astype(np.float32)
    return weights


def test_build_from_a_mistral_dir_matches_jax(tmp_path):
    """A seeded Mistral trunk (the tiny layout's sizes) in the HF layout:
    ``text_encoder/config.json`` (``MistralForCausalLM``, rope theta 1e8 as
    the ``mistral3_24b`` preset's) beside ``model.*`` tensors (Llama's names,
    no biases) and an ``lm_head`` that neither importer reads, and a
    tokenizer in ``tokenizer/``; built through the ``mistral-3`` spec that
    flux2 names at 512 tokens: both packages read the config onto the
    preset, take the same tokens and encode (bf16 compute) within
    ``BF16_REL``, the three states of ``encode_with_hidden_states`` (the
    taps FLUX.2 concatenates) too."""
    cfg = dataclasses.replace(LLMEncoderConfig.tiny("mistral"), rope_theta=1e8)
    weights = _hf_weights(cfg, 10)
    assert "model.layers.0.self_attn.q_proj.bias" not in weights
    weights["lm_head.weight"] = np.zeros((cfg.vocab_size, cfg.hidden_size), np.float32)
    os.makedirs(tmp_path / "text_encoder")
    np_save_file(weights, str(tmp_path / "text_encoder" / "model.safetensors"))
    with open(tmp_path / "text_encoder" / "config.json", "w") as handle:
        json.dump({"architectures": ["MistralForCausalLM"], "model_type": "mistral", "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim, "rope_theta": 1e8,
                   "rms_norm_eps": 1e-5, "max_position_embeddings": 131072, "sliding_window": None}, handle)
    _gemma_tokenizer(str(tmp_path / "tokenizer"), " ".join(PROMPTS).split())
    spec, jspec = (cls(name="mistral-3", family="mistral-3", subfolder="text_encoder", max_length=12)
                   for cls in (TextEncoderSpec, JaxSpec))
    (enc,) = te.load_text_encoders([spec], pretrained_path=str(tmp_path), device="cpu")
    (jenc,) = jax_te.load_text_encoders([jspec], pretrained_path=str(tmp_path))
    expected = dataclasses.replace(LLMEncoderConfig.mistral3_24b(), vocab_size=1000, hidden_size=32,
                                   intermediate_size=64, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=16)
    assert dataclasses.asdict(enc.config) == dataclasses.asdict(jenc.config) == dataclasses.asdict(expected)
    ours, theirs = enc.encode_with_hidden_states(PROMPTS), jenc.encode_with_hidden_states(PROMPTS)
    np.testing.assert_array_equal(ours["attention_mask"], theirs["attention_mask"])
    assert len(ours["hidden_states"]) == len(theirs["hidden_states"]) == 3
    for a, b in zip(ours["hidden_states"] + (ours["last_hidden_state"],),
                    theirs["hidden_states"] + (theirs["last_hidden_state"],)):
        assert a.shape == (3, 12, 32) and rel(a, b) < BF16_REL


def test_build_from_a_chatglm3_dir_matches_jax(tmp_path):
    """A seeded ChatGLM trunk (the tiny layout's width, the published
    65,024-token vocabulary) in the HF layout: ``text_encoder/config.json``
    with ChatGLM's own keys (``num_layers``, ``ffn_hidden_size``,
    ``multi_query_group_num``, ``layernorm_epsilon``, ``padded_vocab_size``,
    as THUDM/chatglm3-6b's and Kolors's), ``transformer.*`` tensors with the
    fused ``query_key_value`` and its bias and an ``output_layer`` that
    neither importer reads, and a tokenizer in ``tokenizer/``; built through
    the ``chatglm`` spec that kolors names: both packages read the config
    onto the ``chatglm3_6b`` preset (``padded_vocab_size`` is not read: the
    preset's 65,024 stands), take the same tokens and encode (bf16 compute),
    the pooled last-valid-token state too, within ``BF16_REL``."""
    cfg = dataclasses.replace(LLMEncoderConfig.tiny("chatglm"), vocab_size=65024, rms_eps=1e-5)
    weights = _hf_weights(cfg, 11)
    assert "transformer.encoder.layers.0.self_attention.query_key_value.bias" in weights
    weights["transformer.output_layer.weight"] = np.zeros((8, cfg.hidden_size), np.float32)
    os.makedirs(tmp_path / "text_encoder")
    np_save_file(weights, str(tmp_path / "text_encoder" / "model.safetensors"))
    with open(tmp_path / "text_encoder" / "config.json", "w") as handle:
        json.dump({"architectures": ["ChatGLMModel"], "model_type": "chatglm", "hidden_size": cfg.hidden_size,
                   "ffn_hidden_size": cfg.intermediate_size, "num_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads, "multi_query_attention": True,
                   "multi_query_group_num": cfg.num_kv_heads, "kv_channels": cfg.head_dim,
                   "layernorm_epsilon": 1e-5, "padded_vocab_size": 65024, "add_qkv_bias": True,
                   "add_bias_linear": False, "rmsnorm": True, "seq_length": 8192}, handle)
    _gemma_tokenizer(str(tmp_path / "tokenizer"), " ".join(PROMPTS).split())
    spec, jspec = (cls(name="chatglm", family="chatglm", subfolder="text_encoder", max_length=12)
                   for cls in (TextEncoderSpec, JaxSpec))
    (enc,) = te.load_text_encoders([spec], pretrained_path=str(tmp_path), device="cpu")
    (jenc,) = jax_te.load_text_encoders([jspec], pretrained_path=str(tmp_path))
    expected = dataclasses.replace(LLMEncoderConfig.chatglm3_6b(), hidden_size=32, intermediate_size=64,
                                   num_layers=2, num_heads=2, num_kv_heads=1, head_dim=16)
    assert dataclasses.asdict(enc.config) == dataclasses.asdict(jenc.config) == dataclasses.asdict(expected)
    assert enc.model.embed_tokens.shape == (65024, 32)
    ours, theirs = enc.encode(PROMPTS), jenc.encode(PROMPTS)
    np.testing.assert_array_equal(ours["attention_mask"], theirs["attention_mask"])
    for key in ("last_hidden_state", "pooled"):
        assert rel(ours[key], theirs[key]) < BF16_REL, key


def test_final_norm_state_is_the_output_not_the_penultimate_layer():
    """The JAX module, and so the port's, returns the final-norm hidden
    state, which lumina2 encodes with (ROADMAP Queue 3); diffusers' Lumina2
    pipeline conditions on the penultimate layer's state
    (``hidden_states[-2]``) instead.  Both packages: ``last_hidden_state`` is
    the final norm of the last tap, not the penultimate tap."""
    from simpletuner_tpu_torch.models.llm_encoder import _rms

    cfg = LLMEncoderConfig.tiny("gemma2")
    ids, mask = _ids(cfg)
    jmodule = JaxLLMEncoder(JaxLLMConfig.tiny("gemma2"), dtype=jnp.float32)
    variables = numpy_variables(jmodule, jnp.asarray(ids), jnp.asarray(mask), seed=7)
    port = bridge(variables, LLMEncoder(cfg, dtype=torch.float32))
    ref, ref_taps = jmodule.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(ids),
                                  jnp.asarray(mask), output_hidden_states=True)
    with torch.no_grad():
        out, taps = port(t(ids), t(mask), output_hidden_states=True)
        final = _rms(taps[-1], port.final_norm.scale, cfg.rms_eps, cfg.rms_unit_offset)
    assert torch.equal(out, final) and rel(out.numpy(), ref) < F32_REL
    assert rel(out.numpy(), taps[-2].numpy()) > 0.5 and rel(np.asarray(ref), np.asarray(ref_taps[-2])) > 0.5
