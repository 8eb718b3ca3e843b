"""The torch port's Boogu-Image family against the JAX package, on the CPU.

Boogu-Image is the Lumina2 Next-DiT under its own name (the JAX
``extended/model.py::BooguImage``): the family contract and arch, the
family's prediction and its LoRA gradients against ``jax.grad`` through the
JAX family's ``model_predict`` (f32 and bf16), the import through Lumina2's
importer of the file the JAX exporter writes for ``boogu_image``, and the
key map and adapter files.  The Lumina2 blocks themselves are held in
test_torch_lumina2.py.  Every tolerance is stated where it is checked.
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
from simpletuner_tpu.models.extended.model import BooguImage as JaxBooguImage
from simpletuner_tpu.models.weight_export import _EXPORTERS as JAX_EXPORTERS
from simpletuner_tpu.models.weight_import import _IMPORTERS as JAX_IMPORTERS
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import lumina2_checkpoint_shapes
from simpletuner_tpu_torch.models.extended import BooguImage
from simpletuner_tpu_torch.models.lumina2 import Lumina2
from simpletuner_tpu_torch.models.registry import PORTED, ModelRegistry, get_model_family
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import _IMPORTERS, load_lumina2_params, load_transformer_params
from simpletuner_tpu_torch.training.lora import _key_map_for, lumina2_key_map

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
    return {"model_family": "boogu_image", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxBooguImage(JaxTrainingConfig(values)), BooguImage(config_namespace(values))


def _prepared(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"noisy_latents": rng.standard_normal((2, 8, 6, cfg.in_channels)).astype(np.float32),
            "timesteps": np.asarray([0.2, 0.7], np.float32),
            "text_embeds": rng.standard_normal((2, 7, cfg.cap_feat_dim)).astype(np.float32),
            "text_attention_mask": (np.arange(7)[None] < np.asarray([[7], [4]])).astype(np.int32)}


def test_contract_matches_jax():
    """The family's constants, spec and arch (tiny and published: Lumina2's
    2304 wide, 26 layers, 24 query / 8 kv heads of 96, 1.97B parameters) as
    the JAX family's; built by name through the registry, a Lumina2."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR", "LATENT_CHANNEL_COUNT"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert (model.NAME, model.DEFAULT_FLAVOUR) == ("boogu_image", "v0.1")
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch)
    full_values = {**_tiny_values(), "model_arch_preset": None}
    full = ModelRegistry.create("boogu_image", config_namespace(full_values))
    assert dataclasses.asdict(full.arch) == dataclasses.asdict(JaxBooguImage(JaxTrainingConfig(full_values)).arch)
    assert (full.arch.hidden_size, full.arch.depth, full.arch.num_heads, full.arch.num_kv_heads,
            full.arch.head_dim) == (2304, 26, 24, 8, 96)
    assert sum(int(np.prod(s)) for s in lumina2_checkpoint_shapes(full.arch).values()) == 1_972_759_232
    assert "boogu_image" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), Lumina2)
    with pytest.raises(ValueError, match="flow-matching"):
        BooguImage(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_prediction_and_lora_grads_match_jax(dtype):
    """The family's ``model_predict`` (the reversed timestep, the negated
    output, the caption mask) on the same seeded weights as the JAX family's:
    f32 within ``F32_REL`` with the LoRA gradients of a seeded projection
    against ``jax.grad`` within ``GRAD_REL``; bf16 within ``BF16_REL``."""
    values = _tiny_values(mixed_precision=dtype)
    jmodel, model = _pair(values)
    prepared = _prepared(model.arch, 1)
    jmodule = jmodel.create_module()
    jinputs = {k: jnp.asarray(v) for k, v in jmodel.get_model_inputs(prepared).items()}
    variables = numpy_variables(jmodule, **jinputs, seed=2)
    module = bridge(variables, model.create_module())
    jprepared = {k: jnp.asarray(v) for k, v in prepared.items()}
    if dtype == "bf16":
        ref = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables), jprepared))
        with torch.no_grad():
            out = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
        assert rel(out, ref) < BF16_REL
        return
    weight = np.random.default_rng(9).standard_normal(prepared["noisy_latents"].shape).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

    def jax_loss(lora):
        out = jmodel.model_predict({"params": params, "lora": lora}, jprepared)
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(module)
    out = model.model_predict(module, {k: t(v) for k, v in prepared.items()})
    assert rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters)
    for path, param in adapters.items():
        assert param.grad is not None and rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_import_through_lumina2_matches_jax_bitwise(tmp_path):
    """The file the JAX exporter writes for ``boogu_image`` (Lumina2's
    diffusers layout) through the port's importer for the family (Lumina2's,
    as the JAX package registers it): the tree bitwise the JAX importer's,
    the imported module bitwise the bridged JAX tree."""
    jmodel, model = _pair(_tiny_values())
    assert _IMPORTERS["boogu_image"] is load_lumina2_params
    assert JAX_IMPORTERS["boogu_image"].__name__ == "load_lumina2_params"
    example = {k: jnp.asarray(v) for k, v in jmodel.get_model_inputs(_prepared(jmodel.arch, 0)).items()}
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0), **example))
    weights = JAX_EXPORTERS["boogu_image"](fill_numpy(shapes, 4)["params"], jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == lumina2_checkpoint_shapes(model.arch)
    path = str(tmp_path / "boogu.safetensors")
    np_save_file({k: np.ascontiguousarray(v) for k, v in weights.items()}, path)
    theirs = JAX_IMPORTERS["boogu_image"](jmodel, path)
    _assert_trees_bitwise(_IMPORTERS["boogu_image"](model, path), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), path)
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_key_map_and_adapter_file_match_jax(tmp_path):
    """The family's key map is Lumina2's, equal to the JAX family's; an
    adapter file written by the port under the family's name loads back
    bitwise through the port and into the JAX template."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    assert _key_map_for(model) == JAX_KEY_MAPS["boogu_image"](jmodel) == lumina2_key_map(model.arch)
    source = _seeded_adapters(model, 4, scale=0.05)
    path = str(tmp_path / "adapter.safetensors")
    save_lora_safetensors(model, source, path)
    target = model.create_module()
    assert load_lora_safetensors(model, path, target) == []
    for (name, a), b in zip(tl.lora_parameters(target).items(), tl.lora_parameters(source).values()):
        assert torch.equal(a, b), name
    example = {k: jnp.asarray(v) for k, v in jmodel.get_model_inputs(_prepared(jmodel.arch, 0)).items()}
    template = numpy_variables(jmodel.create_module(), **example, seed=1)["lora"]
    loaded = jax_load_lora(jmodel, path, template)
    loaded = loaded[0] if isinstance(loaded, tuple) else loaded
    for name, param in tl.lora_parameters(source).items():
        node = loaded
        for part in name.split("/"):
            node = node[part]
        assert np.array_equal(np.asarray(node), param.detach().numpy().T), name
