"""The torch port's Chroma family against the JAX package, on the CPU.

The distilled-guidance approximator and ``chroma_input_vec`` (the
slot-index sincos made on the host), the DiT masked and unmasked with its
LoRA gradients (remat too), the family contract (T5 only, zero pooled
embeds, Flux's inputs), ``encode_text`` on the tiny T5, the tokenizer
subfolder its spec leaves to the T5 builder, and the diffusers import of
the JAX exporter's output without Flux's packing permutation (a quirk kept
from the JAX importer): the same seeded numpy weights and inputs go through
both packages.  The trainer's trajectory is in
test_torch_chroma_trainer.py.  Every tolerance is stated where it is
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
from simpletuner_tpu.models.chroma import transformer as jax_chroma_transformer
from simpletuner_tpu.models.chroma.model import Chroma as JaxChroma
from simpletuner_tpu.models.chroma.transformer import ChromaApproximator as JaxChromaApproximator
from simpletuner_tpu.models.chroma.transformer import ChromaConfig as JaxChromaConfig
from simpletuner_tpu.models.chroma.transformer import ChromaTransformer as JaxChromaTransformer
from simpletuner_tpu.models.weight_export import export_chroma_to_diffusers
from simpletuner_tpu.models.weight_import import load_chroma_params as jax_load_chroma_params
from simpletuner_tpu.training.lora import flux_key_map as jax_flux_key_map

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models import text_encoders as te
from simpletuner_tpu_torch.models.checkpoint_layouts import chroma_checkpoint_shapes
from simpletuner_tpu_torch.models.chroma import Chroma, ChromaConfig, ChromaTransformer, chroma_input_vec
from simpletuner_tpu_torch.models.chroma.transformer import ChromaApproximator, slot_index_table
from simpletuner_tpu_torch.models.flux import Flux, make_img_ids, make_txt_ids
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.t5 import t5_state_dict_from_flax
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import (
    _flux_pack_permutation, flux_params_from_diffusers, load_chroma_params, load_transformer_params,
)
from simpletuner_tpu_torch.training.lora import _key_map_for

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
    return {"model_family": "chroma", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxChroma(JaxTrainingConfig(values)), Chroma(config_namespace(values))


def test_presets_match_jax():
    for name in ("tiny", None):
        ours = getattr(ChromaConfig, name)() if name else ChromaConfig()
        theirs = getattr(JaxChromaConfig, name)() if name else JaxChromaConfig()
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs) and ours.mod_len == theirs.mod_len, name
    cfg = ChromaConfig()  # lodestones/Chroma: Flux's blocks, the 5 x 5120 approximator
    assert (cfg.hidden_size, cfg.depth_double, cfg.depth_single, cfg.num_heads, cfg.head_dim, cfg.mod_len,
            cfg.approximator_hidden, cfg.approximator_layers) == (3072, 19, 38, 24, 128, 344, 5120, 5)
    assert sum(int(np.prod(s)) for s in chroma_checkpoint_shapes(cfg).values()) == 8_899_983_424


def test_input_vec_and_approximator_match_jax():
    """``chroma_input_vec`` at two timesteps (the slot table bitwise the JAX
    one, the sincos within ``F32_REL``) and the approximator (f32) on it."""
    cfg = ChromaConfig.tiny()
    timesteps = np.asarray([0.05, 0.8], np.float32)
    ref = np.asarray(jax_chroma_transformer.chroma_input_vec(JaxChromaConfig.tiny(), jnp.asarray(timesteps)))
    table = slot_index_table(cfg)
    ours = chroma_input_vec(cfg, t(timesteps), torch.from_numpy(table)).numpy()
    assert ours.shape == ref.shape == (2, cfg.mod_len, 64)
    assert np.array_equal(ours[:, :, 32:], ref[:, :, 32:]) and np.array_equal(ours[0, :, 32:], table)
    assert rel(ours, ref) < F32_REL
    japprox = JaxChromaApproximator(JaxChromaConfig.tiny(), dtype=jnp.float32)
    variables = numpy_variables(japprox, jnp.asarray(ref), seed=1)
    port = bridge(variables, ChromaApproximator(cfg, dtype=torch.float32))
    with torch.no_grad():
        out = port(t(ref)).numpy()
    theirs = np.asarray(japprox.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(ref)))
    assert out.shape == theirs.shape == (2, cfg.mod_len, cfg.hidden_size) and rel(out, theirs) < F32_REL


def _inputs(cfg, masked, seed=0, height=8, width=6, txt_len=7):
    rng = np.random.default_rng(seed)
    tokens = (height // 2) * (width // 2)
    img = rng.standard_normal((2, tokens, cfg.in_channels), dtype=np.float32)
    txt = rng.standard_normal((2, txt_len, cfg.txt_in_features), dtype=np.float32)
    img_ids = make_img_ids(2, height, width).numpy()
    txt_ids = make_txt_ids(2, txt_len).numpy()
    timesteps = np.asarray([0.2, 0.9], np.float32)
    seg = None
    if masked:  # Flux's masked training: padded T5 tokens -1, text first
        valid = (np.arange(txt_len)[None] < np.asarray([7, 3])[:, None])
        seg = np.concatenate([np.where(valid, 0, -1), np.zeros((2, tokens))], 1).astype(np.int32)
    return img, img_ids, txt, txt_ids, timesteps, seg


@pytest.mark.parametrize("variant", ["masked", "unmasked", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny DiT (f32, rank-4 adapters) on the same seeded weights: the
    output within ``F32_REL`` with T5 padding masked, unmasked, and under
    remat; the LoRA gradients of a seeded projection of it against
    ``jax.grad`` within ``GRAD_REL``, per adapter."""
    cfg = ChromaConfig.tiny()
    remat = variant == "remat"
    img, img_ids, txt, txt_ids, timesteps, seg = _inputs(cfg, variant != "unmasked")
    weight = np.random.default_rng(9).standard_normal(img.shape).astype(np.float32)
    jmodule = JaxChromaTransformer(config=JaxChromaConfig.tiny(), dtype=jnp.float32, lora_rank=4, remat=remat)
    jargs = [jnp.asarray(a) for a in (img, img_ids, txt, txt_ids, timesteps)]
    jseg = None if seg is None else jnp.asarray(seg)
    variables = numpy_variables(jmodule, *jargs, segment_ids=jseg, seed=1)
    port = bridge(variables, ChromaTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

    def jax_loss(lora):
        out = jmodule.apply({"params": params, "lora": lora}, *jargs, segment_ids=jseg)
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(port)
    out = port(*map(t, (img, img_ids, txt, txt_ids, timesteps)), vec=torch.zeros(2, 768),
               segment_ids=None if seg is None else t(seg))
    assert tuple(out.shape) == ref.shape == img.shape and out.dtype == torch.float32
    assert rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and "double_0/txt_mlp/proj_in/lora_A" in flat
    assert "single_1/linear1/lora_B" in flat and "img_in/lora_A" in flat and "final_proj/lora_A" not in flat
    for path, param in adapters.items():
        assert param.grad is not None and rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


# ---- the family contract -----------------------------------------------------------------------------


def test_contract_and_flux_surface():
    """The family's constants, spec, arch and example batch as the JAX
    family's; ``Chroma`` is a ``Flux`` whose inputs are Flux's; the
    prediction through the family equals the JAX family's within
    ``F32_REL``; true CFG in validation (no guidance embedding); the key map
    is Flux's."""
    jmodel, model = _pair(_tiny_values())
    assert isinstance(model, Flux) and "chroma" in PORTED
    assert isinstance(get_model_family(config_namespace(_tiny_values())), Chroma)
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR", "LATENT_CHANNEL_COUNT"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert model.TEXT_ENCODER_CONFIGURATION[0].tokenizer_subfolder is None
    assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch) and model.latent_channels == 4
    full = {**_tiny_values(), "model_arch_preset": None}
    assert dataclasses.asdict(Chroma(config_namespace(full)).arch) == \
        dataclasses.asdict(JaxChroma(JaxTrainingConfig(full)).arch)
    assert {k: tuple(v.shape) for k, v in model.example_batch(2, 128).items()} == \
        {k: tuple(v.shape) for k, v in jmodel.example_batch(2, 128).items()}
    assert _key_map_for(model) == jax_flux_key_map(jmodel.arch)

    rng = np.random.default_rng(3)
    batch = {"latents": rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
             "t5_embeds": rng.standard_normal((2, 7, 32), dtype=np.float32),
             "pooled_embeds": np.zeros((2, 768), np.float32)}
    prepared = dict(model.prepare_batch(torch.Generator().manual_seed(0), {k: t(v) for k, v in batch.items()}))
    inputs = model.get_model_inputs(prepared)
    assert sorted(inputs) == ["guidance", "img", "img_ids", "timesteps", "txt", "txt_ids", "vec"]
    jmodule = jmodel.create_module()
    variables = numpy_variables(jmodule, *[jnp.asarray(v.numpy()) for k, v in inputs.items()
                                           if k in ("img", "img_ids", "txt", "txt_ids", "timesteps")], seed=5)
    module = bridge(variables, model.create_module())
    with torch.no_grad():
        ours = model.model_predict(module, prepared).numpy()
    jprepared = {k: jnp.asarray(v.numpy()) for k, v in prepared.items()}
    theirs = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables), jprepared))
    assert ours.shape == theirs.shape == (2, 8, 8, 4) and rel(ours, theirs) < F32_REL
    from simpletuner_tpu_torch.training.validation import Validation

    validation = Validation(model, config_namespace(_tiny_values(validation_guidance=4.0)), device="cpu")
    assert validation._wants_cfg()


@pytest.fixture(scope="module")
def encoders():
    """The JAX package's tiny T5 (20 tokens) and the port's module with its params."""
    specs = [dataclasses.replace(s, max_length=20) for s in Chroma.TEXT_ENCODER_CONFIGURATION]
    jax_encoders = jax_te.load_text_encoders(specs, tiny=True)
    ports = te.load_text_encoders(specs, tiny=True, device="cpu")
    ports[0].model.load_state_dict(t5_state_dict_from_flax(jax_encoders[0].model.params))
    return jax_encoders, ports


def test_encode_text_matches_jax(encoders):
    """T5 only: the sequence embeds and mask per prompt, and zero
    ``pooled_embeds`` of width 768; the collate is Flux's (``t5_masks``)."""
    jmodel, model = _pair(_tiny_values())
    jmodel.attach_text_encoders(encoders[0])
    model.attach_text_encoders(encoders[1])
    ours, theirs = model.encode_text(PROMPTS), jmodel.encode_text(PROMPTS)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "pooled_embeds", "t5_embeds"]
        assert a["t5_embeds"].shape == b["t5_embeds"].shape == (20, 32)
        assert np.array_equal(a["pooled_embeds"], np.zeros(768, np.float32)) and a["pooled_embeds"].dtype == np.float32
        np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
        assert rel(a["t5_embeds"], b["t5_embeds"]) < F32_REL
    assert sorted(model.collate_text_embeds(ours)) == ["pooled_embeds", "t5_embeds", "t5_masks"]


def test_t5_tokenizer_comes_from_tokenizer_2(monkeypatch):
    """Quirk kept (ROADMAP Queue 3): Chroma's T5 spec names no tokenizer
    subfolder, so both packages' T5 builders read ``tokenizer_2`` (as for
    PixArt and AuraFlow), where a published Chroma dir keeps ``tokenizer``."""
    import transformers

    seen = {}
    monkeypatch.setattr(te, "load_t5_encoder", lambda path, device=None: seen.setdefault("port_model", path))
    monkeypatch.setattr(te, "_tokenizer", lambda kind, path, sub: seen.setdefault("port", sub))
    te.load_text_encoders(Chroma.TEXT_ENCODER_CONFIGURATION, pretrained_path="/chroma", device="cpu")
    monkeypatch.setattr(transformers.FlaxT5EncoderModel, "from_pretrained",
                        classmethod(lambda cls, path, subfolder="": seen.setdefault("jax_model", subfolder)))
    monkeypatch.setattr(transformers.T5TokenizerFast, "from_pretrained",
                        classmethod(lambda cls, path, subfolder="": seen.setdefault("jax", subfolder)))
    monkeypatch.setattr(jax_te, "TextEncoder", lambda spec, model, tokenizer: None)
    jax_te.load_text_encoders(JaxChroma.TEXT_ENCODER_CONFIGURATION, pretrained_path="/chroma")
    assert seen == {"port_model": "/chroma/text_encoder", "port": "tokenizer_2", "jax_model": "text_encoder",
                    "jax": "tokenizer_2"}


# ---- weight import -------------------------------------------------------------------------------------


def _jax_params(jmodel, seed):
    img, img_ids, txt, txt_ids, timesteps, _ = _inputs(jmodel.arch, False)
    shapes = jax.eval_shape(lambda: JaxChromaTransformer(config=jmodel.arch).init(
        jax.random.PRNGKey(0), *map(jnp.asarray, (img, img_ids, txt, txt_ids, timesteps))))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise_without_the_packing_permutation(tmp_path):
    """The JAX exporter's diffusers file of a seeded tiny transformer (two
    shards in ``transformer/``): its names and shapes are the port's layout,
    the port's tree bitwise the JAX ``load_chroma_params`` tree, the imported
    module bitwise the bridged JAX tree.  Quirk kept (ROADMAP Queue 3):
    ``x_embedder`` / ``proj_out`` are read in the file's feature order,
    where both Flux importers reorder diffusers' (c, ph, pw) packing to the
    port's (ph, pw, c); the tiny arch's 16 packed features make the two
    orders differ."""
    jmodel, model = _pair(_tiny_values())
    weights = export_chroma_to_diffusers(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == chroma_checkpoint_shapes(model.arch)
    root = tmp_path / "chroma" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_chroma_params(jmodel, str(tmp_path / "chroma"))
    tree = load_chroma_params(model, str(tmp_path / "chroma"))
    _assert_trees_bitwise(tree, theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "chroma"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name
    x_embedder = torch.from_numpy(weights["x_embedder.weight"])
    assert torch.equal(ours.img_in.weight, x_embedder)  # the file's (c, ph, pw) order, unpermuted
    perm = _flux_pack_permutation(model.arch.in_channels)
    assert not torch.equal(perm, torch.arange(model.arch.in_channels))
    assert not torch.equal(ours.img_in.weight, x_embedder[:, perm])  # what the Flux importers would read
    flux = flux_params_from_diffusers({"x_embedder.weight": x_embedder, "x_embedder.bias": torch.zeros(64),
                                       "proj_out.weight": torch.from_numpy(weights["proj_out.weight"]),
                                       "context_embedder.weight": torch.zeros(64, 32),
                                       "time_text_embed.timestep_embedder.linear_1.weight": torch.zeros(64, 256),
                                       "time_text_embed.timestep_embedder.linear_2.weight": torch.zeros(64, 64),
                                       "norm_out.linear.weight": torch.zeros(128, 64),
                                       "norm_out.linear.bias": torch.zeros(128)}, 0, 0)
    assert torch.equal(flux["img_in"]["kernel"].t(), x_embedder[:, perm])
