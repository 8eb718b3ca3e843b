"""The torch port's Ideogram family against the JAX package, on the CPU.

The presets (the published one's 9.28B parameters against the JAX
``eval_shape``), the interleaved mRoPE at the image offset, a block with
segment ids 0 / 1, the DiT with its LoRA gradients against ``jax.grad``
(per-sample and tokenwise t, text pads, remat) and in bf16; the family
contract (the packed sequence, segment ids, indicator and 1 - sigma, the
negated unpacked output, ``_select_taps``, ``encode_text`` through the
auto-json caption path and without it, the collate); the greedy prompt
enhancer token for token against the JAX loop on a tiny qwen2 trunk, the
head's reader and its refusal of a hub id; the 32-channel wall in both
packages; the import of the JAX exporter's file with ``input_proj`` and
``final_linear`` unpermuted, the key map and adapter files; a test per kept
quirk.  ``prompting.py``'s copy is held in test_torch_host_modules.py, the
trainer's trajectory in test_torch_omnigen_ernie_ideogram_trainer.py.
Every tolerance is stated where it is checked.
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
from simpletuner_tpu.models import text_encoders as jax_te
from simpletuner_tpu.models.common import TextEncoderSpec as JaxSpec
from simpletuner_tpu.models.ideogram import prompt_enhancer as jax_enhancer
from simpletuner_tpu.models.ideogram import transformer as jit_
from simpletuner_tpu.models.ideogram.model import Ideogram as JaxIdeogram
from simpletuner_tpu.models.llm_encoder import LLMEncoder as JaxLLMEncoder
from simpletuner_tpu.models.vae import VAEConfig as JaxVAEConfig
from simpletuner_tpu.models.weight_export import export_ideogram_to_checkpoint
from simpletuner_tpu.models.weight_import import load_ideogram_params as jax_load_params
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models import text_encoders as te
from simpletuner_tpu_torch.models.checkpoint_layouts import ideogram_checkpoint_shapes
from simpletuner_tpu_torch.models.common import TextEncoderSpec
from simpletuner_tpu_torch.models.ideogram import Ideogram, IdeogramConfig, IdeogramTransformer
from simpletuner_tpu_torch.models.ideogram import prompt_enhancer
from simpletuner_tpu_torch.models.ideogram.transformer import IdeogramBlock, ideogram_mrope, mrope_constants
from simpletuner_tpu_torch.models.llm_encoder import LLMEncoder, LLMEncoderConfig
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.vae import VAEConfig
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import (
    _flux_pack_permutation, load_ideogram_params, load_transformer_params,
)
from simpletuner_tpu_torch.training.lora import _key_map_for, ideogram_key_map

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# f32 LoRA gradients (test_torch_sdxl.py: f32 gradients through a deep net
# are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
# bf16 on both sides: each rounds its own intermediates (the port also
# rounds q and k to bf16 after the rope, for the kernels)
BF16_REL = 2e-2
# torch's and XLA's f32 cos and sin of the same f32 angle (up to 65,600
# radians at the image offset) differ by at most a few ulps of 1.0
ROPE_ATOL = 2.0 ** -20


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
    return {"model_family": "ideogram", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxIdeogram(JaxTrainingConfig(values)), Ideogram(config_namespace(values))


def _prepared(cfg, seed=0, lengths=(6, 4), txt_len=6, height=8, width=12):
    rng = np.random.default_rng(seed)
    out = {"noisy_latents": rng.standard_normal((2, height, width, cfg.in_channels // 4)).astype(np.float32),
           "timesteps": np.asarray([0.2, 0.7], np.float32),
           "text_embeds": rng.standard_normal((2, txt_len, cfg.llm_features_dim)).astype(np.float32)}
    if lengths is not None:
        out["text_attention_mask"] = (np.arange(txt_len)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    return out


def _inputs(jmodel, seed=0, lengths=(6, 4), tokenwise=False):
    """The packed module inputs of the JAX family for seeded latents and text."""
    inputs = {k: np.asarray(v) for k, v in jmodel.get_model_inputs(
        {k: jnp.asarray(v) for k, v in _prepared(jmodel.arch, seed, lengths).items()}).items()}
    if tokenwise:
        inputs["t"] = np.random.default_rng(seed + 1).uniform(0, 1, inputs["segment_ids"].shape).astype(np.float32)
    return inputs


def _variables(jmodule, jmodel, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(jmodel).items()}
    return numpy_variables(jmodule, **example, seed=seed)


def test_presets_and_contract_match_jax():
    """The presets (tiny and published: 4608 wide, 18 heads of 256, 34
    layers of 264.3M, the 53,248 -> 4608 ``llm_cond_proj``; 9.28B parameters
    in the checkpoint layout, as the JAX ``eval_shape``), the family's
    constants, its ``qwen2.5-vl`` spec (Qwen3-VL read in the qwen2 layout in
    both packages: ROADMAP Queue 3) and example batch as the JAX family's; a
    non-flow prediction type is refused."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "LATENT_CHANNEL_COUNT", "DEFAULT_PROMPT_ENHANCER_HEAD"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert te._LLM_ARCHES["qwen2.5-vl"] == jax_te._LLM_ARCHES["qwen2.5-vl"] == "qwen2"
    for ours, theirs in ((IdeogramConfig.tiny(), jit_.IdeogramConfig.tiny()), (IdeogramConfig(), jit_.IdeogramConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs) and ours.head_dim == theirs.head_dim
    full = Ideogram(config_namespace({**_tiny_values(), "model_arch_preset": None})).arch
    shapes = ideogram_checkpoint_shapes(full)
    per_layer = sum(math.prod(s) for k, s in shapes.items() if k.startswith("layers.0."))
    assert per_layer == 264_278_528 and shapes["llm_cond_proj.weight"] == (4608, 53248) and full.head_dim == 256
    spec = {"llm_features": ((1, 8, full.llm_features_dim), jnp.float32), "x": ((1, 8, 128), jnp.float32),
            "t": ((1,), jnp.float32), "position_ids": ((1, 8, 3), jnp.int32), "segment_ids": ((1, 8), jnp.int32),
            "indicator": ((1, 8), jnp.int32)}
    tree = jax.eval_shape(lambda: jit_.IdeogramTransformer(config=jit_.IdeogramConfig()).init(
        jax.random.PRNGKey(0), **{k: jnp.zeros(*v) for k, v in spec.items()}))
    total = sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree))
    assert sum(math.prod(s) for s in shapes.values()) == total == 9_279_288_448
    assert "ideogram" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), Ideogram)
    with pytest.raises(ValueError, match="flow-matching"):
        Ideogram(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 64).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 64).items()}


def test_mrope_matches_jax():
    """The interleaved mRoPE at the published head dim 256 (sections (24, 20,
    20), theta 5e6) over text positions (i, i, i) and image positions
    65,536 + (0, h, w): the angles' H / W selections as the JAX ones (the
    float64 ``inv_freq`` rounded to f32 bitwise), cos and sin within
    ``ROPE_ATOL``."""
    jmodel, _ = _pair(_tiny_values())
    cfg, jcfg = IdeogramConfig(), jit_.IdeogramConfig()
    ids = np.asarray(jmodel.get_model_inputs({k: jnp.asarray(v) for k, v in _prepared(
        jmodel.arch, lengths=None, txt_len=9, height=16, width=20).items()})["position_ids"])
    assert ids.max() == 65536 + 9 and ids[0, 9].tolist() == [65536, 65536, 65536]
    inv, h_sel, w_sel = mrope_constants(cfg)
    expected = (1.0 / (cfg.rope_theta ** (np.arange(0, 256, 2, dtype=np.float64) / 256))).astype(np.float32)
    assert np.array_equal(inv, expected) and h_sel.sum() == 20 and w_sel.sum() == 20
    cos, sin = ideogram_mrope(t(ids), *(torch.from_numpy(a) for a in (inv, h_sel, w_sel)))
    jcos, jsin = jit_.ideogram_mrope(jcfg, jnp.asarray(ids))
    for ours, theirs in ((cos, jcos), (sin, jsin)):
        assert np.abs(ours.numpy() - np.asarray(theirs)).max() <= ROPE_ATOL


def test_block_matches_jax():
    """A block (segment ids with two text pads at 0 that see only each
    other, per-sample modulation, rank-4 adapters, f32): within ``F32_REL``
    of the JAX block; no row is fully masked, since every row sees itself."""
    cfg = IdeogramConfig.tiny()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, cfg.emb_dim)).astype(np.float32)
    ids = rng.integers(0, 9, (2, 10, 3)).astype(np.int32)
    jcos, jsin = jit_.ideogram_mrope(jit_.IdeogramConfig.tiny(), jnp.asarray(ids))
    seg = np.ones((2, 10), np.int32)
    seg[1, 4:6] = 0
    adaln = rng.standard_normal((2, 1, cfg.adanln_dim)).astype(np.float32)
    jblock = jit_.IdeogramBlock(jit_.IdeogramConfig.tiny(), dtype=jnp.float32, lora_rank=4)
    args = (jnp.asarray(x), jnp.asarray(seg), jcos, jsin, jnp.asarray(adaln))
    variables = numpy_variables(jblock, *args, seed=3)
    ref = np.asarray(jblock.apply(jax.tree_util.tree_map(jnp.asarray, variables), *args))
    port = bridge(variables, IdeogramBlock(cfg, torch.float32, lora_rank=4))
    with torch.no_grad():
        out = port(t(x), t(seg), t(np.asarray(jcos)), t(np.asarray(jsin)), t(adaln)).numpy()
    assert rel(out, ref) < F32_REL


@pytest.mark.parametrize("variant", ["masked", "unmasked", "tokenwise", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny DiT (f32, rank-4 adapters) on the family's packed inputs:
    text pads (6 and 4 of 6 valid), no mask, tokenwise (B, L) t, and masked
    under remat: the output within ``F32_REL``, the LoRA gradients of a
    seeded projection of it against ``jax.grad`` within ``GRAD_REL``, per
    adapter."""
    jmodel, model = _pair(_tiny_values())
    cfg = model.arch
    remat = variant == "remat"
    inputs = _inputs(jmodel, seed=4, lengths=None if variant == "unmasked" else (6, 4),
                     tokenwise=variant == "tokenwise")
    jmodule = jit_.IdeogramTransformer(config=jit_.IdeogramConfig.tiny(), dtype=jnp.float32, lora_rank=4,
                                       remat=remat)
    variables = _variables(jmodule, jmodel, seed=5)
    port = bridge(variables, IdeogramTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    weight = np.random.default_rng(6).standard_normal(inputs["x"].shape).astype(np.float32)
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
    assert sorted(flat) == sorted(adapters) and "layer_1/qkv/lora_B" in flat and "llm_cond_proj/lora_A" in flat
    for path, param in adapters.items():
        assert rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_transformer_bf16_matches_jax():
    """The tiny DiT in bf16 (f32 adapters, norms, time MLP and AdaLN), text
    pads, against the JAX module in bf16: within ``BF16_REL``."""
    jmodel, model = _pair(_tiny_values())
    inputs = _inputs(jmodel, seed=7)
    jmodule = jit_.IdeogramTransformer(config=jit_.IdeogramConfig.tiny(), dtype=jnp.bfloat16, lora_rank=4)
    variables = _variables(jmodule, jmodel, seed=8)
    port = bridge(variables, IdeogramTransformer(model.arch, dtype=torch.bfloat16, lora_rank=4))
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                            **{k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}).numpy()
    assert out.dtype == ref.dtype == np.float32 and rel(out, ref) < BF16_REL


class _Taps:
    """A decoder LLM's ``encode_with_hidden_states`` output, fixed; records the prompts it was given."""

    def __init__(self, taps, mask):
        self.taps, self.mask, self.prompts = taps, mask, []

    def encode_with_hidden_states(self, prompts):
        self.prompts.append(list(prompts))
        n = len(prompts)
        return {"hidden_states": tuple(tap[:n] for tap in self.taps), "attention_mask": self.mask[:n],
                "last_hidden_state": self.taps[-1][:n]}


@pytest.mark.parametrize("auto_json", [None, False])
def test_family_inputs_prediction_and_text_match_jax(auto_json):
    """``get_model_inputs`` (the packed sequence, positions, segment ids, the
    indicator, 1 - sigma) equal to the JAX family's, masked and unmasked;
    the negated, unpacked prediction within ``F32_REL``; ``_select_taps`` (13
    fixed taps of 37 states, or 3 spread over a shorter trunk);
    ``encode_text`` hands the encoder the same strings (the auto-json
    captions by default, the prompts as given with ``ideogram_auto_json``
    off) and gives the same payloads; the collate keeps the mask as
    ``text_attention_mask``."""
    jmodel, model = _pair(_tiny_values(ideogram_auto_json=auto_json))
    cfg = model.arch
    for lengths in ((6, 4), None):
        prepared = _prepared(cfg, seed=9, lengths=lengths)
        ours = model.get_model_inputs({k: t(v) for k, v in prepared.items()})
        theirs = jmodel.get_model_inputs({k: jnp.asarray(v) for k, v in prepared.items()})
        assert sorted(ours) == sorted(theirs)
        for key in ours:
            np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    jmodule = jmodel.create_module()
    variables = _variables(jmodule, jmodel, seed=10)
    module = bridge(variables, model.create_module())
    with torch.no_grad():
        out = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
    ref = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                   jax.tree_util.tree_map(jnp.asarray, prepared)))
    assert out.shape == ref.shape == (2, 8, 12, 4) and rel(out, ref) < F32_REL
    rng = np.random.default_rng(11)
    prompts = ["a red fox, 35mm photo #aa00ff", '{"high_level_description": "a sign", "x": 1}', "{not json"]
    for available in (37, 5):
        assert model._select_taps(available) == jmodel._select_taps(available)
        taps = [rng.standard_normal((3, 7, cfg.llm_hidden)).astype(np.float32) for _ in range(available)]
        mask = (np.arange(7)[None] < np.asarray([7, 2, 4])[:, None]).astype(np.int32)
        encoders = [_Taps(taps, mask), _Taps(taps, mask)]
        for m, encoder in zip((jmodel, model), encoders):
            m.attach_text_encoders([encoder])
        mine, jax_payloads = model.encode_text(prompts), jmodel.encode_text(prompts)
        assert encoders[0].prompts == encoders[1].prompts
        assert (encoders[1].prompts[0] == prompts) == (auto_json is False)
        for a, b in zip(mine, jax_payloads):
            assert sorted(a) == sorted(b) == ["attention_mask", "text_embeds"]
            assert a["text_embeds"].shape == (7, (13 if available == 37 else cfg.llm_taps) * cfg.llm_hidden)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
        collated, jcollated = model.collate_text_embeds(mine), jmodel.collate_text_embeds(jax_payloads)
        assert sorted(collated) == sorted(jcollated) == ["text_attention_mask", "text_embeds"]
    if auto_json is None:
        assert json.loads(encoders[1].prompts[0][0])["style_description"]["medium"] == "photograph"
    assert model._select_taps(37) == (0, 3, 6, 9, 12, 15, 18, 21, 24, 27, 30, 33, 35)


class _CharTokenizer:
    """A deterministic character tokenizer without a chat template (the enhancer's plain-text branch)."""

    eos_token_id = 7

    def __call__(self, text, return_tensors="np", add_special_tokens=True):
        return {"input_ids": np.asarray([[11 + (ord(c) % 900) for c in text[:40]]], np.int32)}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def _enhancer_pair(seed):
    """The tiny qwen2 trunk (f32) in both packages on one tokenizer, and a seeded (32, 1000) head."""
    spec = JaxSpec(name="qwen3-vl", family="qwen2.5-vl", subfolder="text_encoder", max_length=16)
    (jenc,) = jax_te.load_text_encoders([spec], tiny=True)
    jenc.module = JaxLLMEncoder(jenc.config, dtype=jnp.float32)
    variables = numpy_variables(jenc.module, jnp.zeros((1, 8), jnp.int32), seed=seed)
    jenc.params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jenc.tokenizer = _CharTokenizer()
    port = bridge(variables, LLMEncoder(LLMEncoderConfig.tiny("qwen2"), dtype=torch.float32))
    enc = te.LLMTextEncoder(TextEncoderSpec(name="qwen3-vl", family="qwen2.5-vl", max_length=16), port,
                            jenc.tokenizer)
    head = np.random.default_rng(seed).standard_normal((32, 1000)).astype(np.float32)
    return jenc, enc, head


def test_greedy_prompt_enhancer_matches_jax_token_for_token():
    """``upsample_prompt`` at temperature 0 (12 new tokens, no KV cache) on
    the tiny qwen2 trunk and a seeded head: the port's tokens are the JAX
    loop's, token for token; an eos id ends both at the same step.  Sampling
    (temperature 1) draws from the port's generator: the same seed gives the
    same caption twice (the JAX ``categorical`` draws differ: ROADMAP Queue
    3)."""
    jenc, enc, head = _enhancer_pair(12)
    prompt = "a lighthouse on a cliff"
    theirs = jax_enhancer.upsample_prompt(jenc, head, prompt, temperature=0.0, max_new_tokens=12)
    ours = prompt_enhancer.upsample_prompt(enc, torch.from_numpy(head), prompt, temperature=0.0, max_new_tokens=12)
    assert ours == theirs and len(ours.split()) == 12
    tokens = ours.split()
    stop = next(k for k in range(1, 12) if tokens[k] not in tokens[:k])  # a token first drawn at step k
    enc.tokenizer.eos_token_id = jenc.tokenizer.eos_token_id = int(tokens[stop])
    stopped = prompt_enhancer.upsample_prompt(enc, head, prompt, temperature=0.0, max_new_tokens=12)
    assert stopped == jax_enhancer.upsample_prompt(jenc, head, prompt, temperature=0.0, max_new_tokens=12)
    assert stopped.split() == tokens[:stop]
    sampled = [prompt_enhancer.upsample_prompt(enc, head, prompt, temperature=1.0, max_new_tokens=6, seed=3)
               for _ in range(2)]
    assert sampled[0] == sampled[1]


def test_enhancer_head_reader_and_hub_refusal(tmp_path):
    """``load_enhancer_head`` of a local file and of a folder: the (hidden,
    vocab) kernel equal to the JAX reader's; the hidden-size check; a hub id
    is refused by name (the JAX function would download it)."""
    rng = np.random.default_rng(13)
    weight = rng.standard_normal((50, 16)).astype(np.float32)
    np_save_file({"lm_head.weight": weight}, str(tmp_path / "head.safetensors"))
    for path in (str(tmp_path / "head.safetensors"), str(tmp_path)):
        ours = prompt_enhancer.load_enhancer_head(path)
        assert np.array_equal(ours.numpy(), jax_enhancer.load_enhancer_head(path)) and ours.shape == (16, 50)
    with pytest.raises(ValueError, match="hidden size"):
        prompt_enhancer.load_enhancer_head(str(tmp_path), hidden_size=32)
    with pytest.raises(RuntimeError, match="diffusers/qwen3-vl-8b-instruct-lm-head.*downloads nothing"):
        prompt_enhancer.load_enhancer_head(Ideogram.DEFAULT_PROMPT_ENHANCER_HEAD)


def test_thirty_two_channel_wall_and_unmasked_renders_in_both_packages():
    """Quirks kept (ROADMAP Queue 3): ``LATENT_CHANNEL_COUNT`` 32 meets the
    16-channel ``VAEConfig.flux()`` both trainers build, so the published
    ``input_proj`` (128 packed features) refuses the 64 its VAE's latents
    pack to, in both packages; the render payload's ``attention_mask`` is
    not read by ``inference_conditioning`` in either package."""
    assert Ideogram.LATENT_CHANNEL_COUNT == JaxIdeogram.LATENT_CHANNEL_COUNT == 32
    assert VAEConfig.flux().latent_channels == JaxVAEConfig.flux().latent_channels == 16
    wide = dataclasses.replace(IdeogramConfig.tiny(), in_channels=128)
    jwide = dataclasses.replace(jit_.IdeogramConfig.tiny(), in_channels=128)
    values = _tiny_values()
    jmodel, model = JaxIdeogram(JaxTrainingConfig(values), arch=jwide), Ideogram(config_namespace(values), arch=wide)
    assert model.latent_channels == jmodel.latent_channels == 32
    prepared = _prepared(IdeogramConfig.tiny(), seed=14)  # 4-channel latents: 16 packed features
    prepared["noisy_latents"] = np.repeat(prepared["noisy_latents"], 4, axis=-1)  # 16 channels, 64 packed
    jmodule = jmodel.create_module()
    spec = {"llm_features": jnp.zeros((1, 8, wide.llm_features_dim)), "x": jnp.zeros((1, 8, 128)),
            "t": jnp.zeros((1,)), "position_ids": jnp.zeros((1, 8, 3), jnp.int32),
            "segment_ids": jnp.zeros((1, 8), jnp.int32), "indicator": jnp.zeros((1, 8), jnp.int32)}
    variables = numpy_variables(jmodule, **spec, seed=15)
    with pytest.raises(Exception):
        jmodel.model_predict(jax.tree_util.tree_map(jnp.asarray, variables),
                             jax.tree_util.tree_map(jnp.asarray, prepared))
    module = bridge(variables, model.create_module())
    with pytest.raises(RuntimeError):
        model.model_predict(module, {k: t(v) for k, v in prepared.items()})
    payload = {"text_embeds": np.zeros((1, 6, 96), np.float32), "attention_mask": np.ones((1, 6), np.int32)}
    assert sorted(model.inference_conditioning({k: t(v) for k, v in payload.items()})) == \
        sorted(jmodel.inference_conditioning(payload)) == ["text_embeds"]


def _jax_params(jmodel, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(jmodel).items()}
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0), **example))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise_and_keeps_the_packing_unpermuted(tmp_path):
    """The JAX exporter's file of a seeded tiny transformer (two shards):
    its names and shapes are the port's layout, the port's tree bitwise the
    JAX ``load_ideogram_params`` tree, the imported module bitwise the
    bridged JAX tree.  Quirk kept (ROADMAP Queue 3): ``input_proj`` and
    ``final_linear`` are read 1:1, not permuted from the reference's
    (c, ph, pw) packing to the (ph, pw, c) one the family packs (the JAX
    family's docstring says they are)."""
    jmodel, model = _pair(_tiny_values())
    weights = export_ideogram_to_checkpoint(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == ideogram_checkpoint_shapes(model.arch)
    root = tmp_path / "ideogram" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_params(jmodel, str(tmp_path / "ideogram"))
    _assert_trees_bitwise(load_ideogram_params(model, str(tmp_path / "ideogram")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "ideogram"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name
    perm = _flux_pack_permutation(model.arch.in_channels)
    in_w, out_w = torch.from_numpy(weights["input_proj.weight"]), torch.from_numpy(weights["final_layer.linear.weight"])
    assert torch.equal(ours.input_proj.weight, in_w) and not torch.equal(ours.input_proj.weight, in_w[:, perm])
    assert torch.equal(ours.final_linear.weight, out_w) and not torch.equal(ours.final_linear.weight, out_w[perm])


def test_key_map_and_adapter_file_match_jax(tmp_path):
    """``ideogram_key_map`` equals the JAX map (``llm_cond_proj`` keeps its
    own name); an adapter file written by the port round-trips bitwise and
    loads into the JAX template bitwise."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    assert _key_map_for(model) == JAX_KEY_MAPS["ideogram"](jmodel) == ideogram_key_map(model.arch)
    source = _seeded_adapters(model, 4, scale=0.05)
    path = str(tmp_path / "adapter.safetensors")
    save_lora_safetensors(model, source, path)
    target = model.create_module()
    assert load_lora_safetensors(model, path, target) == []
    for (name, a), b in zip(tl.lora_parameters(target).items(), tl.lora_parameters(source).values()):
        assert torch.equal(a, b), name
    template = _variables(jmodel.create_module(), jmodel, seed=1)["lora"]
    loaded = jax_load_lora(jmodel, path, template)
    loaded = loaded[0] if isinstance(loaded, tuple) else loaded
    for name, param in tl.lora_parameters(source).items():
        node = loaded
        for part in name.split("/"):
            node = node[part]
        assert np.array_equal(np.asarray(node), param.detach().numpy().T), name
