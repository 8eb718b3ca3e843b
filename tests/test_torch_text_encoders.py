"""The port's CLIP and T5 encoders against the Flax models the JAX package runs, on the CPU.

Tiny CLIP text models (the JAX package's tiny configs) and tiny T5 encoders
(``relu``, ``gated-gelu`` and Pile-T5's ``gated-silu``) take the Flax models' own params; the same
tokens go through both.  f32 on both sides, so ``last_hidden_state`` and
``pooled`` agree to f32 sum order (relative L2 under 1e-5), with CLIP-G's
exact ``gelu`` as with CLIP-L's ``quick_gelu``.  The pooling
rule is checked for the three cases HF distinguishes.  ``Flux.encode_text``
is held against the JAX family's on the JAX package's tiny encoders, and an
HF torch-layout checkpoint written by ``transformers``' torch classes loads
into the port's modules and gives the HF outputs; a ``umt5`` checkpoint
(AuraFlow's Pile-T5) loads as the JAX package loads it, through
``FlaxT5EncoderModel.from_pretrained``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from transformers import CLIPTextConfig as HFCLIPTextConfig
from transformers import FlaxCLIPTextModel, FlaxT5EncoderModel
from transformers import T5Config as HFT5Config

from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.flux.model import Flux as JaxFlux
from simpletuner_tpu.models.text_encoders import _TinyTokenizer as JaxTinyTokenizer
from simpletuner_tpu.models.text_encoders import load_text_encoders as jax_load_text_encoders

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models.checkpoint_layouts import clip_checkpoint_shapes
from simpletuner_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel, clip_state_dict_from_flax, load_clip_text
from simpletuner_tpu_torch.models.flux import Flux
from simpletuner_tpu_torch.models.t5 import (
    T5Config,
    T5EncoderModel,
    load_t5_encoder,
    relative_position_bucket,
    t5_state_dict_from_flax,
)
from simpletuner_tpu_torch.models.text_encoders import TextEncoder, _TinyTokenizer, load_text_encoders

from torch_parity import rel

PROMPTS = ["a lighthouse on a basalt cliff at dusk", "portrait", "a very long prompt " * 20, ""]


def _tokens(max_length):
    tokens = _TinyTokenizer(max_length)(PROMPTS)
    return tokens["input_ids"], tokens["attention_mask"]


def test_tiny_tokenizer_matches_jax():
    ours, theirs = _TinyTokenizer(77)(PROMPTS), JaxTinyTokenizer(77)(PROMPTS)
    for key in ("input_ids", "attention_mask"):
        assert ours[key].dtype == theirs[key].dtype and np.array_equal(ours[key], theirs[key])


def _clip_pair(eos_token_id, hidden=32):
    config = HFCLIPTextConfig(vocab_size=1000, hidden_size=hidden, intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=2, max_position_embeddings=77, eos_token_id=eos_token_id)
    flax_model = FlaxCLIPTextModel(config, seed=0)
    port = CLIPTextModel(CLIPTextConfig.from_hf(config.to_dict()))
    port.load_state_dict(clip_state_dict_from_flax(flax_model.params))
    return flax_model, port.eval()


# 49407: HF's default eos, which no tiny token equals (pool at 0); 2: argmax of
# the ids; 1: the tiny tokenizer's eos, the first position where it occurs
@pytest.mark.parametrize("eos_token_id", [49407, 2, 1])
@pytest.mark.parametrize("hidden", [32, 64], ids=["clip-l", "clip-g"])
def test_clip_matches_flax(eos_token_id, hidden):
    flax_model, port = _clip_pair(eos_token_id, hidden)
    ids, mask = _tokens(77)
    ref = flax_model(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        out = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert rel(out["last_hidden_state"].numpy(), np.asarray(ref.last_hidden_state)) < 1e-5
    assert rel(out["pooler_output"].numpy(), np.asarray(ref.pooler_output)) < 1e-5
    hidden_state = out["last_hidden_state"].numpy()
    if eos_token_id == 49407:
        expected = np.zeros(len(PROMPTS), np.int64)
    elif eos_token_id == 2:
        expected = ids.argmax(axis=-1)
    else:
        expected = (ids == 1).argmax(axis=-1)
    np.testing.assert_array_equal(out["pooler_output"].numpy(), hidden_state[np.arange(len(PROMPTS)), expected])


def test_clip_g_gelu_matches_flax():
    """CLIP-G's exact-erf ``gelu`` (OpenCLIP bigG; the port refused every
    activation but ``quick_gelu`` before): a tiny CLIP with ``hidden_act="gelu"``
    against ``FlaxCLIPTextModel`` on the same weights, relative L2 under 1e-5
    (f32 both sides); ``quick_gelu`` on the same weights lands far away."""
    config = HFCLIPTextConfig(vocab_size=1000, hidden_size=64, intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=2, max_position_embeddings=77, hidden_act="gelu")
    flax_model = FlaxCLIPTextModel(config, seed=0)
    port = CLIPTextModel(CLIPTextConfig.from_hf(config.to_dict()))
    assert port.config.hidden_act == "gelu"
    port.load_state_dict(clip_state_dict_from_flax(flax_model.params))
    quick = CLIPTextModel(CLIPTextConfig.from_hf({**config.to_dict(), "hidden_act": "quick_gelu"}))
    quick.load_state_dict(port.state_dict())
    ids, mask = _tokens(77)
    ref = flax_model(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(ids), torch.from_numpy(mask))
        other = quick.eval()(torch.from_numpy(ids), torch.from_numpy(mask))
    err = rel(out["last_hidden_state"].numpy(), np.asarray(ref.last_hidden_state))
    assert err < 1e-5 and rel(out["pooler_output"].numpy(), np.asarray(ref.pooler_output)) < 1e-5
    assert rel(other["last_hidden_state"].numpy(), np.asarray(ref.last_hidden_state)) > 100 * err
    full = CLIPTextConfig.clip_g()
    assert (full.hidden_size, full.num_hidden_layers, full.num_attention_heads, full.intermediate_size,
            full.max_position_embeddings, full.hidden_act) == (1280, 32, 20, 5120, 77, "gelu")


def test_clip_with_projection_checkpoint_loads_without_the_projection(tmp_path):
    """SD3's ``text_encoder_2`` is an HF ``CLIPTextModelWithProjection``; the
    JAX package reads it as a plain ``FlaxCLIPTextModel``, so the port drops
    ``text_projection`` and gives HF's ``last_hidden_state``."""
    torch.manual_seed(0)
    hf = transformers.CLIPTextModelWithProjection(HFCLIPTextConfig(
        vocab_size=1000, hidden_size=64, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
        max_position_embeddings=77, hidden_act="gelu", projection_dim=64)).eval()
    hf.save_pretrained(str(tmp_path / "text_encoder_2"), safe_serialization=True)
    port = load_clip_text(str(tmp_path / "text_encoder_2"))
    ids, mask = (torch.from_numpy(x).long() for x in _tokens(77))
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        out = port(ids, mask)["last_hidden_state"]
    assert port.config.hidden_act == "gelu" and rel(out.numpy(), ref.numpy()) < 1e-5
    # the layout the seeded files are written in is HF's, projection included
    hf_shapes = {k: tuple(v.shape) for k, v in hf.state_dict().items() if not k.endswith("position_ids")}
    assert clip_checkpoint_shapes(port.config, projection=True) == hf_shapes


@pytest.mark.parametrize("feed_forward_proj", ["relu", "gated-gelu", "gated-silu"])
def test_t5_matches_flax(feed_forward_proj):
    config = HFT5Config(vocab_size=1000, d_model=32, d_ff=64, num_layers=2, num_heads=2, d_kv=16,
                        feed_forward_proj=feed_forward_proj)
    flax_model = FlaxT5EncoderModel(config, seed=0)
    port = T5EncoderModel(T5Config.tiny(feed_forward_proj))
    port.load_state_dict(t5_state_dict_from_flax(flax_model.params))
    ids, mask = _tokens(64)
    ref = flax_model(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask)).last_hidden_state
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(ids), torch.from_numpy(mask))["last_hidden_state"]
    assert rel(out.numpy(), np.asarray(ref)) < 1e-5


def test_relative_position_buckets_match_flax():
    from transformers.models.t5.modeling_flax_t5 import FlaxT5Attention

    positions = np.arange(-700, 701)
    ref = np.asarray(FlaxT5Attention._relative_position_bucket(jnp.asarray(positions), bidirectional=True,
                                                                num_buckets=32, max_distance=128))
    np.testing.assert_array_equal(relative_position_bucket(torch.from_numpy(positions)).numpy(), ref)


def test_flux_encode_text_matches_jax():
    """Flux.encode_text on the JAX package's tiny encoders and on the port's
    modules with the same params: the cache payload, key for key."""
    config = config_namespace({"model_family": "flux", "model_arch_preset": "tiny", "tokenizer_max_length": 24})
    previous = jl._LORA_TARGET
    try:
        jmodel = JaxFlux(config)
    finally:
        jl.set_lora_target(previous)
    specs = [type(s)(**{**s.__dict__, "max_length": 24}) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    jax_encoders = jax_load_text_encoders(specs, tiny=True)
    jmodel.attach_text_encoders(jax_encoders)
    model = Flux(config)
    ports = load_text_encoders(model.TEXT_ENCODER_CONFIGURATION, tiny=True, device="cpu")
    ports[0].model.load_state_dict(clip_state_dict_from_flax(jax_encoders[0].model.params))
    ports[1].model.load_state_dict(t5_state_dict_from_flax(jax_encoders[1].model.params))
    model.attach_text_encoders([TextEncoder(s, e.model, e.tokenizer) for s, e in zip(specs, ports)])
    ours, theirs = model.encode_text(PROMPTS), jmodel.encode_text(PROMPTS)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "pooled_embeds", "t5_embeds"]
        for key in b:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        assert np.array_equal(a["attention_mask"], b["attention_mask"])
        assert rel(a["t5_embeds"], b["t5_embeds"]) < 1e-5 and rel(a["pooled_embeds"], b["pooled_embeds"]) < 1e-5


def test_hf_torch_checkpoints_load(tmp_path):
    """Checkpoints written by transformers' torch classes load by name into
    the port's modules and give the HF forward's outputs."""
    torch.manual_seed(0)
    hf_clip = transformers.CLIPTextModel(HFCLIPTextConfig(
        vocab_size=1000, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
        max_position_embeddings=77, eos_token_id=2)).eval()
    hf_t5 = transformers.T5EncoderModel(HFT5Config(
        vocab_size=1000, d_model=32, d_ff=64, num_layers=2, num_heads=2, d_kv=16, feed_forward_proj="gated-gelu",
        dropout_rate=0.0)).eval()
    hf_clip.save_pretrained(str(tmp_path / "text_encoder"), safe_serialization=True)
    hf_t5.save_pretrained(str(tmp_path / "text_encoder_2"), safe_serialization=True)
    clip = load_clip_text(str(tmp_path / "text_encoder"))
    t5 = load_t5_encoder(str(tmp_path / "text_encoder_2"))
    assert clip.config.eos_token_id == 2 and t5.config.gated
    ids, mask = (torch.from_numpy(x).long() for x in _tokens(77))
    with torch.no_grad():
        ref_clip = hf_clip(input_ids=ids, attention_mask=mask)
        ref_t5 = hf_t5(input_ids=ids, attention_mask=mask).last_hidden_state
        out_clip, out_t5 = clip(ids, mask), t5(ids, mask)["last_hidden_state"]
    assert rel(out_clip["last_hidden_state"].numpy(), ref_clip.last_hidden_state.numpy()) < 1e-5
    assert rel(out_clip["pooler_output"].numpy(), ref_clip.pooler_output.numpy()) < 1e-5
    assert rel(out_t5.numpy(), ref_t5.numpy()) < 1e-5
    assert os.path.exists(str(tmp_path / "text_encoder_2" / "config.json"))


def test_umt5_checkpoint_loads_as_the_flax_model_loads_it(tmp_path):
    """A tiny ``umt5`` encoder written by ``transformers``' torch class (a
    relative attention bias in every layer, gated-silu): the port's module
    gives what ``FlaxT5EncoderModel.from_pretrained`` gives on the same
    directory (the JAX package's load), which keeps layer 0's bias only and
    shares it with every layer (relative L2 under 1e-5, f32), and so not what
    the torch UMT5 gives."""
    config = transformers.UMT5Config(vocab_size=1000, d_model=32, d_ff=64, num_layers=2, num_heads=2, d_kv=16,
                                     feed_forward_proj="gated-silu", dropout_rate=0.0)
    torch.manual_seed(0)
    hf = transformers.UMT5EncoderModel(config).eval()
    hf.save_pretrained(str(tmp_path / "text_encoder"), safe_serialization=True)
    assert "encoder.block.1.layer.0.SelfAttention.relative_attention_bias.weight" in hf.state_dict()
    port = load_t5_encoder(str(tmp_path / "text_encoder"))
    assert port.config.feed_forward_proj == "gated-silu" and port.config.gated
    flax_model = FlaxT5EncoderModel.from_pretrained(str(tmp_path / "text_encoder"))
    ids, mask = _tokens(24)
    ref = flax_model(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask)).last_hidden_state
    with torch.no_grad():
        out = port(torch.from_numpy(ids), torch.from_numpy(mask))["last_hidden_state"]
        umt5 = hf(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long())
    assert rel(out.numpy(), np.asarray(ref)) < 1e-5
    assert rel(umt5.last_hidden_state.numpy(), np.asarray(ref)) > 1e-3


def test_pile_t5_xl_config_reads_from_its_config_json():
    values = {"model_type": "umt5", "d_model": 2048, "d_ff": 5120, "d_kv": 64, "num_heads": 32, "num_layers": 24,
              "feed_forward_proj": "gated-silu", "vocab_size": 32128, "relative_attention_num_buckets": 32,
              "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6, "dense_act_fn": "silu",
              "is_gated_act": True, "tie_word_embeddings": False}
    assert T5Config.from_hf(values) == T5Config.pile_xl()


def test_byt5_is_read_as_t5_from_its_config_json(tmp_path):
    """HunyuanVideo reads ByT5 through the ``t5-xxl`` spec: a T5 encoder at
    the file's ``config.json`` sizes.  ByT5-small's published sizes (d_model
    1472, 6 heads of 64, d_ff 3584, 12 layers, gated-gelu, 384 byte tokens)
    read onto ``T5Config``; a tiny encoder written by ``transformers``' torch
    class with a ByT5-style config (gated-gelu, untied, byte vocabulary)
    loads into the port's module and gives what
    ``FlaxT5EncoderModel.from_pretrained`` (the JAX package's load) gives on
    the same directory, within 1e-5 relative L2 (f32)."""
    byt5_small = {"model_type": "t5", "architectures": ["T5ForConditionalGeneration"], "d_model": 1472,
                  "d_ff": 3584, "d_kv": 64, "num_heads": 6, "num_layers": 12, "num_decoder_layers": 4,
                  "feed_forward_proj": "gated-gelu", "vocab_size": 384, "relative_attention_num_buckets": 32,
                  "layer_norm_epsilon": 1e-6, "tie_word_embeddings": False}
    assert T5Config.from_hf(byt5_small) == T5Config(vocab_size=384, d_model=1472, d_kv=64, d_ff=3584, num_layers=12,
                                                    num_heads=6, feed_forward_proj="gated-gelu")
    config = HFT5Config(vocab_size=384, d_model=48, d_ff=96, num_layers=2, num_heads=3, d_kv=16,
                        feed_forward_proj="gated-gelu", tie_word_embeddings=False, dropout_rate=0.0)
    torch.manual_seed(1)
    hf = transformers.T5EncoderModel(config).eval()
    hf.save_pretrained(str(tmp_path / "text_encoder_2"), safe_serialization=True)
    port = load_t5_encoder(str(tmp_path / "text_encoder_2"))
    assert port.config == T5Config(vocab_size=384, d_model=48, d_kv=16, d_ff=96, num_layers=2, num_heads=3)
    flax_model = FlaxT5EncoderModel.from_pretrained(str(tmp_path / "text_encoder_2"))
    ids, mask = _tokens(24)
    ids = ids % 384
    ref = flax_model(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask)).last_hidden_state
    with torch.no_grad():
        out = port(torch.from_numpy(ids), torch.from_numpy(mask))["last_hidden_state"]
    assert rel(out.numpy(), np.asarray(ref)) < 1e-5


def test_refusals():
    with pytest.raises(NotImplementedError):
        T5EncoderModel(T5Config.tiny("gelu"))
    with pytest.raises(NotImplementedError):
        CLIPTextModel(CLIPTextConfig.from_hf({"hidden_act": "silu", "hidden_size": 32, "intermediate_size": 64,
                                              "num_hidden_layers": 1, "num_attention_heads": 2}))
    spec = type(Flux.TEXT_ENCODER_CONFIGURATION[0])(name="siglip", family="siglip")  # no builder in either package
    with pytest.raises(NotImplementedError):
        load_text_encoders([spec], tiny=True, device="cpu")
