"""The torch port's FLUX.2 family against the JAX package, on the CPU.

The presets and the parameter shapes at the published (dev, klein) and tiny
widths, the DiT with its LoRA gradients (with and without the guidance
embedding, on a non-square grid, under remat) and in bf16, the family
contract (the guidance input, the registry), ``_te_tap_layers`` with its
errors and ``encode_text`` with three taps on a tiny ``mistral`` trunk, the
channel and text-width wall of the published arch that both packages hit,
the import of the JAX exporter's output and the key map with an adapter
file: the same seeded numpy weights and inputs go through both packages.
The trainers' trajectories are in test_torch_flux2_trainer.py.  Every
tolerance is stated where it is checked.  At the tiny size the head dim is
16; the published D = 128 joint shape is held to the plain version on the
card (test_torch_kernels_cuda.py).
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
from simpletuner_tpu.models.flux2 import transformer as jax_f2
from simpletuner_tpu.models.flux2.model import Flux2 as JaxFlux2
from simpletuner_tpu.models.llm_encoder import LLMEncoder as JaxLLMEncoder
from simpletuner_tpu.models.registry import ModelRegistry as JaxModelRegistry
from simpletuner_tpu.models.text_encoders import LLMTextEncoder as JaxLLMTextEncoder
from simpletuner_tpu.models.weight_export import export_flux2_to_diffusers
from simpletuner_tpu.models.weight_import import load_flux2_params as jax_load_flux2_params
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import flux2_checkpoint_shapes
from simpletuner_tpu_torch.models.flux2 import Flux2, Flux2Config, Flux2Transformer
from simpletuner_tpu_torch.models.flux2 import transformer as f2
from simpletuner_tpu_torch.models.llm_encoder import LLMEncoder, LLMEncoderConfig
from simpletuner_tpu_torch.models.registry import PORTED, ModelRegistry, get_model_family
from simpletuner_tpu_torch.models.text_encoders import LLMTextEncoder, _TinyTokenizer
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_flux2_params, load_transformer_params
from simpletuner_tpu_torch.training.lora import _key_map_for, flux2_key_map

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# gradient-derived numbers (test_torch_sdxl.py: f32 gradients through a deep
# net are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
# the family-level f32 comparisons at the guidance-embedded tiny arch: the
# JAX module's f32 output is 0.6-1.0e-5 off a float64 run of the same
# weights there (three seeds), the port's 3-4e-7 (held in
# test_contract_matches_jax), so the two sides are held to 3e-5
FAMILY_REL = 3e-5
# the port's f32 output against its own float64 run
F64_REL = 1e-6
# bf16 on both sides: each rounds its own intermediates (the kernels' plain
# version against XLA's bf16 products)
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
    return {"model_family": "flux2", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxFlux2(JaxTrainingConfig(values)), Flux2(config_namespace(values))


def _jax_config(cfg):
    return jax_f2.Flux2Config(**dataclasses.asdict(cfg))


def _jax_args(cfg, latents, timesteps, context, guidance):
    args = [jnp.asarray(latents), jnp.asarray(timesteps), jnp.asarray(context)]
    return args + ([jnp.asarray(guidance)] if guidance is not None else [])


def _jax_params(arch, seed, height=4, width=4, txt=5):
    jmodule = jax_f2.Flux2Transformer(config=_jax_config(arch))
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), jnp.zeros((1, height, width, arch.in_channels)),
                                                 jnp.zeros(1), jnp.zeros((1, txt, arch.txt_in_features)), jnp.ones(1)))
    return fill_numpy(shapes, seed)["params"]


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_flat(value, path) if isinstance(value, dict) else {path: value})
    return out


@pytest.mark.parametrize("preset", ["tiny", "dev", "klein"])
def test_presets_and_parameter_shapes_match_jax(preset):
    """The three presets as the JAX ones, and the family's arch under the
    tiny preset, the default flavour and ``klein``; the port's parameters
    (``patch_in`` sized from ``in_channels * patch ** 2``) have the shapes
    of the Flax module's (which sizes ``patch_in`` from its input), at the
    published widths cut to 1 + 1 blocks (every block's shapes are the
    same); the published dev size from the checkpoint layout."""
    values = _tiny_values(model_arch_preset="tiny" if preset == "tiny" else None,
                          model_flavour="klein" if preset == "klein" else None)
    jmodel, model = _pair(values)
    expected = {"tiny": Flux2Config.tiny(), "dev": Flux2Config(), "klein": Flux2Config.klein()}[preset]
    assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch) == dataclasses.asdict(expected)
    assert model.latent_channels == jmodel.latent_channels == expected.in_channels
    arch = expected if preset == "tiny" else dataclasses.replace(expected, depth_double=1, depth_single=1)
    theirs = {path: tuple(v.shape) for path, v in _flat(jax.eval_shape(
        lambda: jax_f2.Flux2Transformer(config=_jax_config(arch)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, arch.in_channels)), jnp.zeros(1),
            jnp.zeros((1, 3, arch.txt_in_features)), jnp.ones(1)))["params"]).items()}
    with torch.device("meta"):
        module = Flux2Transformer(arch)
    ours = {}
    for name, param in module.named_parameters():
        path, leaf = name.replace(".", "/").rsplit("/", 1)
        ours[f"{path}/{'kernel' if leaf == 'weight' else leaf}"] = tuple(param.shape)[::-1]
    assert ours == theirs
    assert ("guidance_in_1/kernel" in ours) == expected.guidance_embed
    if preset == "dev":
        assert sum(int(np.prod(s)) for s in flux2_checkpoint_shapes(expected).values()) == 32_223_281_152
        assert (expected.hidden_size, expected.mlp_hidden, expected.txt_in_features) == (6144, 18432, 15360)


def _inputs(cfg, height, width, text_len=5, seed=0):
    rng = np.random.default_rng(seed)
    latents = rng.standard_normal((2, height, width, cfg.in_channels), dtype=np.float32)
    context = rng.standard_normal((2, text_len, cfg.txt_in_features), dtype=np.float32)
    timesteps = rng.uniform(0.05, 0.95, 2).astype(np.float32)
    guidance = rng.uniform(1.0, 5.0, 2).astype(np.float32) if cfg.guidance_embed else None
    return latents, timesteps, context, guidance


def _grad_close(ours, theirs):
    """Within ``GRAD_REL``, or exactly zero on both sides (an adapter no output reads)."""
    if not np.any(theirs):
        return not np.any(ours)
    return rel(ours, theirs) < GRAD_REL


@pytest.mark.parametrize("variant", ["guidance", "klein", "non_square", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny DiT (f32, rank-4 adapters) on the same seeded weights: the
    output within ``F32_REL`` with the guidance embedding and without it (the
    klein path), on a 4 x 10 latent grid and under remat; the LoRA gradients
    of a seeded projection of it against ``jax.grad`` within ``GRAD_REL``,
    per adapter.  The modulation and embedding linears carry no adapter."""
    cfg = dataclasses.replace(Flux2Config.tiny(), guidance_embed=variant != "klein")
    height, width = (4, 10) if variant == "non_square" else (6, 6)
    remat = variant == "remat"
    latents, timesteps, context, guidance = _inputs(cfg, height, width)
    weight = np.random.default_rng(9).standard_normal(latents.shape).astype(np.float32)
    jmodule = jax_f2.Flux2Transformer(config=_jax_config(cfg), dtype=jnp.float32, lora_rank=4, remat=remat)
    jargs = _jax_args(cfg, latents, timesteps, context, guidance)
    variables = numpy_variables(jmodule, *jargs, seed=1)
    port = bridge(variables, Flux2Transformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

    def jax_loss(lora):
        out = jmodule.apply({"params": params, "lora": lora}, *jargs)
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(port)
    out = port(t(latents), t(timesteps), t(context), None if guidance is None else t(guidance))
    assert tuple(out.shape) == ref.shape == latents.shape and out.dtype == torch.float32
    assert rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters)
    assert {"patch_in/lora_A", "txt_in/lora_B", "final_proj/lora_A", "double_0/ff_context_out/lora_B",
            "single_1/qkv_mlp/lora_A", "single_1/proj_out/lora_B"} <= set(flat)
    assert not any(path.startswith(("mod_", "time_in", "guidance_in", "final_mod")) for path in flat)
    for path, param in adapters.items():
        grad = torch.zeros_like(param) if param.grad is None else param.grad  # None: off autograd's graph
        assert _grad_close(grad.numpy().T, flat[path]), path


def test_transformer_bf16_matches_jax():
    """The tiny DiT in bf16 (the trainer's compute dtype; f32 adapters and
    norm scales) against the JAX module in bf16 on the same weights: within
    ``BF16_REL``, each side rounding its own intermediates."""
    cfg = Flux2Config.tiny()
    latents, timesteps, context, guidance = _inputs(cfg, 6, 6, seed=3)
    jmodule = jax_f2.Flux2Transformer(config=_jax_config(cfg), dtype=jnp.bfloat16, lora_rank=4)
    jargs = _jax_args(cfg, latents, timesteps, context, guidance)
    variables = numpy_variables(jmodule, *jargs, seed=4)
    port = bridge(variables, Flux2Transformer(cfg, dtype=torch.bfloat16, lora_rank=4))
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables), *jargs))
    with torch.no_grad():
        out = port(t(latents), t(timesteps), t(context), t(guidance)).numpy()
    assert out.dtype == ref.dtype == np.float32 and rel(out, ref) < BF16_REL


def test_rope_ids_match_jax():
    """The 4-axis position ids (text (0, 0, 0, l) first, then image (0, h, w,
    0) row by row) and their theta-2000 tables equal the JAX module's."""
    from simpletuner_tpu.ops.rope import axial_rope as jax_axial_rope

    from simpletuner_tpu_torch.ops import axial_rope

    ids = f2.flux2_rope_ids(3, 5, 4)
    assert tuple(ids.shape) == (1, 4 + 15, 4)
    np.testing.assert_array_equal(ids[0, :4].numpy(), np.stack([np.zeros(4)] * 3 + [np.arange(4)], -1))
    np.testing.assert_array_equal(ids[0, 4 + 7].numpy(), [0, 1, 2, 0])
    cfg = Flux2Config()
    ours = axial_rope(cfg.axes_dim, ids, cfg.rope_theta)
    theirs = jax_axial_rope(cfg.axes_dim, jnp.asarray(ids.numpy()), cfg.rope_theta)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape and rel(a.numpy(), np.asarray(b)) < F32_REL


# ---- the family contract -----------------------------------------------------------------------------


@pytest.mark.parametrize("flavour", ["dev", "klein"])
def test_contract_matches_jax(flavour):
    """The family's constants, spec, arch and example batch as the JAX
    family's; ``get_model_inputs`` (the guidance input is
    ``flux_guidance_value`` only where the arch embeds guidance);
    ``model_predict`` and ``denoise_fn`` equal to the JAX ``model_predict``
    within ``F32_REL``; the registry builds it; a non-flow prediction type is
    refused; the intermediates tap is refused by name.  ``model_predict``
    within ``F64_REL`` of the port's module run in float64, and within
    ``FAMILY_REL`` of the JAX family's (the JAX side's own f32 error)."""
    values = _tiny_values(model_flavour=flavour, flux_guidance_value=3.5)
    jmodel, model = _pair(values)
    arch = dataclasses.replace(Flux2Config.tiny(), guidance_embed=flavour == "dev")
    jmodel.arch, model.arch = _jax_config(arch), arch
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "MODALITY", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR",
                 "HUGGINGFACE_PATHS", "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR",
                 "LATENT_CHANNEL_COUNT"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert model.is_flow and model.huggingface_path() == jmodel.huggingface_path()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 128).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 128).items()}
    assert "flux2" in PORTED and type(get_model_family(config_namespace(values))) is Flux2
    assert JaxModelRegistry.metadata("flux2") == ModelRegistry.metadata("flux2")
    with pytest.raises(ValueError, match="flow-matching"):
        Flux2(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    with pytest.raises(NotImplementedError, match="item 4h"):
        model.model_predict_with_intermediates(None, {})

    rng = np.random.default_rng(5)
    latents = rng.standard_normal((2, 6, 10, 4)).astype(np.float32)
    prepared = {"noisy_latents": latents, "timesteps": np.asarray([0.2, 0.7], np.float32),
                "text_embeds": rng.standard_normal((2, 7, 32)).astype(np.float32)}
    jin = jmodel.get_model_inputs(jax.tree_util.tree_map(jnp.asarray, prepared))
    inputs = model.get_model_inputs({k: t(v) for k, v in prepared.items()})
    assert sorted(inputs) == sorted(jin) and ("guidance" in inputs) == (flavour == "dev")
    for key in jin:
        np.testing.assert_array_equal(inputs[key].numpy(), np.asarray(jin[key]))
    if flavour == "dev":
        assert inputs["guidance"].tolist() == [3.5, 3.5]
    jmodule = jmodel.create_module()
    variables = numpy_variables(jmodule, **jin, seed=6)
    module = bridge(variables, model.create_module())
    with torch.no_grad():
        ours = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
        denoised = model.denoise_fn(module, model.inference_conditioning(
            {"text_embeds": t(prepared["text_embeds"][:1])}))(t(latents[:1]), torch.tensor(0.2))
    theirs = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                      jax.tree_util.tree_map(jnp.asarray, prepared)))
    assert ours.shape == theirs.shape == latents.shape and rel(ours, theirs) < FAMILY_REL
    assert rel(denoised.numpy(), theirs[:1]) < FAMILY_REL
    module64 = bridge(variables, Flux2Transformer(arch, dtype=torch.float64, lora_rank=4)).double()
    with torch.no_grad():
        ref64 = module64(**{k: v.double() for k, v in inputs.items()}).numpy()
    assert rel(ours, ref64) < F64_REL


@pytest.mark.parametrize("raw, expected", [
    (None, None), ("[10, 20, 30]", (10, 20, 30)), ([-3, -2, -1], (-3, -2, -1)), ("[]", None), ((), None),
    ("[1, 2", ValueError),
])
def test_te_tap_layers_match_jax(raw, expected):
    """``_te_tap_layers``: a JSON string or a list to a tuple of ints, None
    when unset or empty, and the same ``ValueError`` for invalid JSON."""
    jmodel, model = _pair(_tiny_values(custom_text_encoder_intermediary_layers=raw))
    if expected is ValueError:
        for m in (model, jmodel):
            with pytest.raises(ValueError, match="not valid JSON"):
                m._te_tap_layers()
    else:
        assert model._te_tap_layers() == jmodel._te_tap_layers() == expected


def _mistral_pair(seed=5, max_length=12):
    """The tiny ``mistral`` trunk in both packages on one seeded numpy tree
    (f32), behind one tokenizer (the tiny one's ids are per process)."""
    from simpletuner_tpu.models.common import TextEncoderSpec as JaxSpec
    from simpletuner_tpu.models.llm_encoder import LLMEncoderConfig as JaxLLMConfig

    from simpletuner_tpu_torch.models.common import TextEncoderSpec

    cfg = LLMEncoderConfig.tiny("mistral")
    jmodule = JaxLLMEncoder(JaxLLMConfig.tiny("mistral"), dtype=jnp.float32)
    variables = numpy_variables(jmodule, jnp.zeros((1, 8), jnp.int32), seed=seed)
    tokenizer = _TinyTokenizer(max_length)
    jspec = JaxSpec(name="mistral-3", family="mistral-3", subfolder="text_encoder", max_length=max_length)
    spec = TextEncoderSpec(name="mistral-3", family="mistral-3", subfolder="text_encoder", max_length=max_length)
    jenc = JaxLLMTextEncoder(jspec, JaxLLMConfig.tiny("mistral"), jax.tree_util.tree_map(jnp.asarray,
                                                                                        variables["params"]), tokenizer)
    jenc.module = jmodule  # f32: read when the encode is traced
    enc = LLMTextEncoder(spec, bridge(variables, LLMEncoder(cfg, dtype=torch.float32)).eval(), tokenizer)
    return jenc, enc


@pytest.mark.parametrize("taps", [None, "[-3, -2, -1]", "[0, 2]", "[3]", "[-4]"])
def test_encode_text_with_taps_matches_jax(taps):
    """``encode_text`` on a tiny ``mistral`` trunk (2 layers: 3 states,
    embeddings first) in f32: without taps the final-norm state (32 wide);
    with three taps the states side by side (96 wide, as FLUX.2's 15,360 is
    three 5,120-wide Mistral states), or two; within ``F32_REL`` of the JAX
    family and the masks equal; an index past the states (3, -4) raises the
    same ``ValueError`` in both; the collate drops the mask."""
    jmodel, model = _pair(_tiny_values(custom_text_encoder_intermediary_layers=taps))
    jenc, enc = _mistral_pair()
    jmodel.attach_text_encoders([jenc])
    model.attach_text_encoders([enc])
    prompts = ["a lighthouse on a basalt cliff", "", "a cat"]
    if taps in ("[3]", "[-4]"):
        for m in (model, jmodel):
            with pytest.raises(ValueError, match="out of range for a 3-state encoder"):
                m.encode_text(prompts)
        return
    ours, theirs = model.encode_text(prompts), jmodel.encode_text(prompts)
    width = {None: 32, "[-3, -2, -1]": 96, "[0, 2]": 64}[taps]
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "text_embeds"]
        assert a["text_embeds"].shape == (12, width) and a["text_embeds"].dtype == np.float32
        np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
        assert rel(a["text_embeds"], b["text_embeds"]) < F32_REL
    if taps == "[-3, -2, -1]":  # the embeddings, then each block's output
        states = enc.encode_with_hidden_states(prompts)["hidden_states"]
        np.testing.assert_array_equal(ours[1]["text_embeds"], np.concatenate([s[1] for s in states], axis=-1))
    collated, jcollated = model.collate_text_embeds(ours), jmodel.collate_text_embeds(theirs)
    assert sorted(collated) == sorted(jcollated) == ["text_embeds"]


def test_channel_and_text_wall_as_in_jax():
    """Kept from the JAX family (ROADMAP Queue 3): the trainer builds the
    16-channel ``VAEConfig.flux()`` for FLUX.2 (``LATENT_CHANNEL_COUNT`` 32),
    and without taps the prompt embeds are Mistral's last state (5,120
    wide).  A narrow arch with the published channel count (32) and text
    width (15,360): 16-channel latents (64 packed features against
    ``patch_in``'s 128) and 5,120-wide embeds (against ``txt_in``'s 15,360)
    each fail in both packages; 32-channel latents with three taps' width go
    through (within ``FAMILY_REL``)."""
    from simpletuner_tpu.models.vae import VAEConfig as JaxVAEConfig

    from simpletuner_tpu_torch.models.vae import VAEConfig

    assert VAEConfig.flux().latent_channels == JaxVAEConfig.flux().latent_channels == 16
    jmodel, model = _pair(_tiny_values(model_arch_preset=None))
    assert model.LATENT_CHANNEL_COUNT == jmodel.LATENT_CHANNEL_COUNT == model.latent_channels == 32
    assert LLMEncoderConfig.mistral3_24b().hidden_size * 3 == model.arch.txt_in_features == 15360
    arch = dataclasses.replace(Flux2Config.tiny(), in_channels=32, txt_in_features=15360)
    jmodel.arch, model.arch = _jax_config(arch), arch
    rng = np.random.default_rng(8)
    template = {"noisy_latents": np.zeros((1, 4, 4, 32), np.float32), "timesteps": np.asarray([0.5], np.float32),
                "text_embeds": rng.standard_normal((1, 3, 15360)).astype(np.float32)}
    jmodule = jmodel.create_module()
    variables = numpy_variables(jmodule, **jmodel.get_model_inputs(jax.tree_util.tree_map(jnp.asarray, template)),
                                seed=9)
    module = bridge(variables, model.create_module())
    walls = ({**template, "noisy_latents": rng.standard_normal((1, 4, 4, 16)).astype(np.float32)},
             {**template, "text_embeds": rng.standard_normal((1, 3, 5120)).astype(np.float32)})
    for batch in walls:
        with pytest.raises(Exception, match="shape"):
            jmodel.model_predict(jax.tree_util.tree_map(jnp.asarray, variables),
                                 jax.tree_util.tree_map(jnp.asarray, batch))
        with pytest.raises(RuntimeError, match="shapes cannot be multiplied"), torch.no_grad():
            model.model_predict(module, {k: t(v) for k, v in batch.items()})
    with torch.no_grad():  # the latents and the width its arch reads go through
        ours = model.model_predict(module, {k: t(v) for k, v in template.items()}).numpy()
    theirs = np.asarray(jmodel.model_predict(jax.tree_util.tree_map(jnp.asarray, variables),
                                             jax.tree_util.tree_map(jnp.asarray, template)))
    assert ours.shape == (1, 4, 4, 32) and rel(ours, theirs) < FAMILY_REL


# ---- weight import and the key map ------------------------------------------------------------------


@pytest.mark.parametrize("guidance_embed", [True, False])
def test_import_matches_jax_bitwise(tmp_path, guidance_embed):
    """The JAX exporter's file of a seeded tiny transformer (two shards in
    ``transformer/``; the guidance embedder only where the arch has it):
    its names and shapes are ``flux2_checkpoint_shapes``, the port's tree is
    bitwise the JAX ``load_flux2_params`` tree, and the imported module
    bitwise the bridged JAX tree."""
    jmodel, model = _pair(_tiny_values())
    arch = dataclasses.replace(Flux2Config.tiny(), guidance_embed=guidance_embed)
    jmodel.arch, model.arch = _jax_config(arch), arch
    weights = export_flux2_to_diffusers(_jax_params(arch, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == flux2_checkpoint_shapes(arch)
    root = tmp_path / "flux2" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_flux2_params(jmodel, str(tmp_path / "flux2"))
    _assert_trees_bitwise(load_flux2_params(model, str(tmp_path / "flux2")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "flux2"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_key_map_and_adapter_file_match_jax(tmp_path):
    """``flux2_key_map`` equal to the JAX map; an adapter file written by the
    port round-trips through the port's loader bitwise and loads into the
    JAX template; quirk kept (ROADMAP Queue 3): no code reads
    ``DEFAULT_LORA_TARGET``, so without ``lora_target_modules`` every
    adapter-carrying linear is adapted; with the default target names
    (``attn_q`` ... in the JAX module's names) only the image attention is."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    assert _key_map_for(model) == JAX_KEY_MAPS["flux2"](jmodel) == flux2_key_map(model.arch)
    every = {name.rsplit("/", 1)[0] for name in tl.lora_parameters(model.create_module())}
    assert {"patch_in", "txt_in", "final_proj", "double_0/attn_add_q", "single_0/qkv_mlp"} <= every
    targeted = Flux2(config_namespace(_tiny_values(lora_target_modules=list(Flux2.DEFAULT_LORA_TARGET))))
    assert {name.rsplit("/", 1)[0] for name in tl.lora_parameters(targeted.create_module())} == \
        {"double_0/attn_q", "double_0/attn_k", "double_0/attn_v", "double_0/attn_proj"}
    source = _seeded_adapters(model, 4, scale=0.05)
    path = str(tmp_path / "adapter.safetensors")
    save_lora_safetensors(model, source, path)
    target = model.create_module()
    assert load_lora_safetensors(model, path, target) == []
    for (name, a), b in zip(tl.lora_parameters(target).items(), tl.lora_parameters(source).values()):
        assert torch.equal(a, b), name
    template = numpy_variables(jmodel.create_module(), jnp.zeros((1, 4, 4, 4)), jnp.zeros(1), jnp.zeros((1, 5, 32)),
                               jnp.ones(1), seed=1)["lora"]
    loaded = jax_load_lora(jmodel, path, template)
    loaded = loaded[0] if isinstance(loaded, tuple) else loaded
    for name, param in tl.lora_parameters(source).items():
        node = loaded
        for part in name.split("/"):
            node = node[part]
        assert np.array_equal(np.asarray(node), param.detach().numpy().T), name
