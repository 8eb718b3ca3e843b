"""The torch port's Krea-2 family against the JAX package, on the CPU.

The presets (the published one's 12.82B parameters), the zero-centred norm
and the rope tables, the GQA attention (K/V repeated as ``jnp.repeat``
does), the text-fusion and main blocks, the DiT with its LoRA gradients
against ``jax.grad`` (masked text, unmasked, remat, the edit's reference
tokens) and in bf16; the family contract (packing, position ids, the edit
path, ``_select_layers``, ``encode_text`` with taps, the collate); the
import of the JAX exporter's file, the key map and adapter files; a test per
kept quirk.  The trainer's trajectory is in test_torch_cosmos_anima_krea2_trainer.py.
Every tolerance is stated where it is checked.
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
from simpletuner_tpu.models.krea2 import transformer as jkt
from simpletuner_tpu.models.krea2.model import Krea2 as JaxKrea2
from simpletuner_tpu.models.weight_export import export_krea2_to_checkpoint
from simpletuner_tpu.models.weight_import import load_krea2_params as jax_load_params
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import krea2_checkpoint_shapes
from simpletuner_tpu_torch.models.krea2 import Krea2, Krea2Config, Krea2Transformer
from simpletuner_tpu_torch.models.krea2.transformer import Krea2Attention, Krea2Block, Krea2TextFusionBlock, zrms
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_krea2_params, load_transformer_params
from simpletuner_tpu_torch.ops.rope import axial_rope
from simpletuner_tpu_torch.training.lora import _key_map_for, krea2_key_map

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# f32 LoRA gradients (test_torch_sdxl.py: f32 gradients through a deep net
# are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
# bf16 on both sides: each rounds its own intermediates
BF16_REL = 2e-2
# torch's and XLA's f32 cos and sin differ by at most one ulp of 1.0
ROPE_ATOL = 2.0 ** -23


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
    return {"model_family": "krea2", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxKrea2(JaxTrainingConfig(values)), Krea2(config_namespace(values))


def _mask(lengths, length):
    return (np.arange(length)[None] < np.asarray(lengths)[:, None]).astype(np.int32)


def _position_ids(txt_len, height, width, ref=False):
    grid = np.stack(np.meshgrid(np.arange(height // 2), np.arange(width // 2), indexing="ij"), -1).reshape(-1, 2)
    img = np.concatenate([np.zeros((grid.shape[0], 1)), grid], axis=1)
    parts = [np.zeros((txt_len, 3)), img] + ([img] if ref else [])
    return np.concatenate(parts).astype(np.int32)


def _inputs(cfg, lengths, seed=0, height=8, width=12, txt_len=6, ref=False):
    rng = np.random.default_rng(seed)
    img_len = (height // 2) * (width // 2) * (2 if ref else 1)
    out = {
        "hidden_states": rng.standard_normal((2, img_len, cfg.in_channels), dtype=np.float32),
        "encoder_hidden_states": rng.standard_normal((2, txt_len, cfg.num_text_layers, cfg.text_hidden_dim),
                                                     dtype=np.float32),
        "timesteps": np.asarray([0.13, 0.91], np.float32),
        "position_ids": _position_ids(txt_len, height, width, ref),
    }
    if lengths is not None:
        out["encoder_attention_mask"] = _mask(lengths, txt_len)
    return out


def _variables(jmodule, cfg, seed):
    """Seeded weights for every leaf (the zero-init tables, norms and q/k norms drawn)."""
    example = {k: jnp.asarray(v) for k, v in _inputs(cfg, [6, 3]).items()}
    return numpy_variables(jmodule, **example, seed=seed)


def test_presets_and_contract_match_jax():
    """The presets (tiny and published: 6144 wide, 48 query and 12 key/value
    heads of 128, 28 blocks: 12.82B parameters, 434.16M a block, in the
    checkpoint layout, where the JAX docstring says 8.9B), the family's
    constants, spec and example batch as the JAX family's; a non-flow
    prediction type is refused."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "LATENT_CHANNEL_COUNT"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    for ours, theirs in ((Krea2Config.tiny(), jkt.Krea2Config.tiny()), (Krea2Config(), jkt.Krea2Config())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs) and ours.hidden_size == theirs.hidden_size
    full = Krea2(config_namespace({**_tiny_values(), "model_arch_preset": None})).arch
    shapes = krea2_checkpoint_shapes(full)
    assert sum(math.prod(s) for s in shapes.values()) == 12_820_073_036
    per_block = sum(math.prod(s) for k, s in shapes.items() if k.startswith("transformer_blocks.0."))
    assert per_block == 434_159_872 and model.latent_channels == jmodel.latent_channels == 4
    example = {k: (v.shape, v.dtype) for k, v in _inputs(full, [6, 3]).items()}
    tree = jax.eval_shape(lambda: jkt.Krea2Transformer(config=jkt.Krea2Config()).init(
        jax.random.PRNGKey(0), **{k: jnp.zeros(*spec) for k, spec in example.items()}))
    assert sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree)) == 12_820_073_036
    assert "krea2" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), Krea2)
    with pytest.raises(ValueError, match="flow-matching"):
        Krea2(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 64).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 64).items()}


def test_zero_centred_norm_and_rope_match_jax():
    """``zrms`` (scale 1 + w, f32) within one f32 rounding of the JAX norm;
    the interleaved-pair rope tables at theta 1000 over (32, 48, 48) within
    ``ROPE_ATOL`` of the f32 tables the JAX module makes in its forward (its
    float64 ``krea2_rope`` helper is not what the module uses)."""
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal((3, 5, 64)).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(zrms(t(x), t(w)).numpy(), np.asarray(jkt._zrms(jnp.asarray(x), jnp.asarray(w))),
                               rtol=2e-6, atol=2e-6)
    ids = _position_ids(7, 64, 96)
    cos, sin = axial_rope((32, 48, 48), t(ids), 1000.0)
    parts = []
    for i, dax in enumerate((32, 48, 48)):  # the JAX module's own f32 tables
        f = 1.0 / 1000.0 ** (jnp.arange(0, dax, 2, dtype=jnp.float32) / dax)
        parts.append(jnp.asarray(ids)[:, i:i + 1].astype(jnp.float32) * f[None])
    angles = jnp.concatenate([jnp.repeat(a, 2, axis=-1) for a in parts], -1)
    jcos, jsin = jnp.cos(angles), jnp.sin(angles)
    for ours, theirs in ((cos, jcos), (sin, jsin)):  # the JAX table repeats each angle twice
        np.testing.assert_allclose(np.repeat(ours.numpy(), 2, axis=-1), np.asarray(theirs), rtol=0, atol=ROPE_ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_gqa_attention_matches_jax(masked):
    """The GQA attention (4 query heads over 2 key/value heads, rope, the
    sigmoid gate, rank-4 adapters, f32): within ``F32_REL`` of the JAX
    module, with and without a key mask; K/V go to the query heads as
    ``jnp.repeat`` (head h reads head h // 2), so tiling them with
    ``repeat`` instead gives another output."""
    cfg = Krea2Config.tiny()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, cfg.hidden_size)).astype(np.float32)
    ids = _position_ids(4, 4, 6)[:10]
    jcos, jsin = jkt.krea2_rope(ids, cfg.axes_dims_rope, cfg.rope_theta)
    mask = _mask([10, 4], 10).astype(bool) if masked else None
    jattn = jkt.Krea2Attention(4, 2, 16, dtype=jnp.float32, lora_rank=4)
    variables = numpy_variables(jattn, jnp.asarray(x), (jcos, jsin), None if mask is None else jnp.asarray(mask),
                                seed=2)
    port = bridge(variables, Krea2Attention(cfg.hidden_size, 4, 2, 16, dtype=torch.float32, lora_rank=4))
    ref = np.asarray(jattn.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x), (jcos, jsin),
                                 None if mask is None else jnp.asarray(mask)))
    angles = axial_rope(cfg.axes_dims_rope, t(ids), cfg.rope_theta)
    key_ids = None if mask is None else torch.where(t(mask), 1, -1).to(torch.int32)
    with torch.no_grad():
        out = port(t(x), angles, key_ids).numpy()
        original = torch.Tensor.repeat_interleave
        torch.Tensor.repeat_interleave = lambda self, rep, dim: self.repeat(1, 1, rep, 1)
        try:
            tiled = port(t(x), angles, key_ids).numpy()
        finally:
            torch.Tensor.repeat_interleave = original
    assert rel(out, ref) < F32_REL and rel(tiled, ref) > 1e-2


def test_text_fusion_and_main_blocks_match_jax():
    """A text-fusion block with masked keys (6 and 3 of 6 valid) and a main
    block (modulation + table, masked joint keys, rank-4 adapters), f32:
    within ``F32_REL`` of the JAX blocks."""
    cfg = Krea2Config.tiny()
    rng = np.random.default_rng(3)
    text = rng.standard_normal((2, 6, cfg.text_hidden_dim)).astype(np.float32)
    mask = _mask([6, 3], 6)
    jfusion = jkt.Krea2TextFusionBlock(jkt.Krea2Config.tiny(), dtype=jnp.float32)
    variables = numpy_variables(jfusion, jnp.asarray(text), jnp.asarray(mask.astype(bool)), seed=4)
    port = bridge(variables, Krea2TextFusionBlock(cfg, torch.float32))
    ref = jfusion.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(text),
                        jnp.asarray(mask.astype(bool)))
    with torch.no_grad():
        out = port(t(text), torch.where(t(mask) > 0, 1, -1).to(torch.int32))
    assert rel(out.numpy(), ref) < F32_REL

    x = rng.standard_normal((2, 10, cfg.hidden_size)).astype(np.float32)
    temb_mod = rng.standard_normal((2, 1, 6 * cfg.hidden_size)).astype(np.float32)
    ids = _position_ids(4, 4, 6)[:10]
    rope = jkt.krea2_rope(ids, cfg.axes_dims_rope, cfg.rope_theta)
    full = _mask([10, 7], 10)
    jblock = jkt.Krea2Block(jkt.Krea2Config.tiny(), dtype=jnp.float32, lora_rank=4)
    args = (jnp.asarray(x), jnp.asarray(temb_mod), rope, jnp.asarray(full.astype(bool)))
    variables = numpy_variables(jblock, *args, seed=5)
    port = bridge(variables, Krea2Block(cfg, torch.float32, lora_rank=4))
    ref = jblock.apply(jax.tree_util.tree_map(jnp.asarray, variables), *args)
    with torch.no_grad():
        out = port(t(x), t(temb_mod), axial_rope(cfg.axes_dims_rope, t(ids), cfg.rope_theta),
                   torch.where(t(full) > 0, 1, -1).to(torch.int32))
    assert rel(out.numpy(), ref) < F32_REL


@pytest.mark.parametrize("variant", ["masked", "unmasked", "remat", "reference"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny DiT (f32, rank-4 adapters): masked text (6 and 3 of 6
    valid), unmasked, masked under remat, and with the edit's reference
    tokens on a second copy of the grid: the output within ``F32_REL``, the
    LoRA gradients of a seeded projection of it against ``jax.grad`` within
    ``GRAD_REL``, per adapter."""
    cfg = Krea2Config.tiny()
    remat = variant == "remat"
    inputs = _inputs(cfg, None if variant == "unmasked" else [6, 3], seed=6, ref=variant == "reference")
    jmodule = jkt.Krea2Transformer(config=jkt.Krea2Config.tiny(), dtype=jnp.float32, lora_rank=4, remat=remat)
    variables = _variables(jmodule, cfg, seed=7)
    port = bridge(variables, Krea2Transformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    weight = np.random.default_rng(9).standard_normal(inputs["hidden_states"].shape).astype(np.float32)
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
    assert sorted(flat) == sorted(adapters) and "block_1/attn/to_gate/lora_B" in flat
    for path, param in adapters.items():
        assert rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_transformer_bf16_matches_jax():
    """The tiny DiT in bf16 (f32 adapters, norms and time MLP), masked text,
    against the JAX module in bf16 on the same weights: within ``BF16_REL``."""
    cfg = Krea2Config.tiny()
    inputs = _inputs(cfg, [6, 2], seed=8)
    jmodule = jkt.Krea2Transformer(config=jkt.Krea2Config.tiny(), dtype=jnp.bfloat16, lora_rank=4)
    variables = _variables(jmodule, cfg, seed=9)
    port = bridge(variables, Krea2Transformer(cfg, dtype=torch.bfloat16, lora_rank=4))
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                            **{k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}).numpy()
    assert out.dtype == ref.dtype == np.float32 and rel(out, ref) < BF16_REL


class _Taps:
    """A decoder LLM's ``encode_with_hidden_states`` output, fixed."""

    def __init__(self, taps, mask):
        self.taps, self.mask = taps, mask

    def encode_with_hidden_states(self, prompts):
        n = len(prompts)
        return {"hidden_states": tuple(tap[:n] for tap in self.taps), "attention_mask": self.mask[:n],
                "last_hidden_state": self.taps[-1][:n]}


@pytest.mark.parametrize("reference", [False, True])
def test_family_inputs_prediction_and_text_match_jax(reference):
    """``get_model_inputs`` (packing, zero text ids and the grid, the edit's
    second grid and ``control_latents``) equal to the JAX family's; the
    prediction sliced to the target within ``F32_REL`` of the JAX
    ``model_predict``; ``encode_text`` stacks the selected taps as the JAX
    family (12 taps of 37 states at (2, 5, ..., 35), whatever the arch's
    ``num_text_layers``; on a shorter trunk that many taps spread evenly) and the collate keeps the mask as
    ``text_attention_mask``."""
    values = _tiny_values(krea2_reference_latents=reference)
    jmodel, model = _pair(values)
    cfg = model.arch
    rng = np.random.default_rng(10)
    prepared = {"noisy_latents": rng.standard_normal((2, 8, 12, 4)).astype(np.float32),
                "timesteps": np.asarray([0.2, 0.7], np.float32),
                "text_embeds": rng.standard_normal((2, 6, cfg.num_text_layers, cfg.text_hidden_dim)).astype(np.float32),
                "text_attention_mask": _mask([6, 4], 6)}
    if reference:
        prepared["control_latents"] = rng.standard_normal((2, 8, 12, 4)).astype(np.float32)
    ours = model.get_model_inputs({k: t(v) for k, v in prepared.items()})
    theirs = jmodel.get_model_inputs({k: jnp.asarray(v) for k, v in prepared.items()})
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    jmodule = jmodel.create_module()
    variables = _variables(jmodule, cfg, seed=11)
    module = bridge(variables, model.create_module())
    with torch.no_grad():
        out = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
    ref = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                   jax.tree_util.tree_map(jnp.asarray, prepared)))
    assert out.shape == ref.shape == (2, 8, 12, 4) and rel(out, ref) < F32_REL
    with pytest.raises(ValueError, match="reference|match"):
        bad = dict(prepared, control_latents=np.zeros((2, 8, 8, 4), np.float32))
        if not reference:
            raise ValueError("reference latents are read only with krea2_reference_latents")
        model.get_model_inputs({k: t(v) for k, v in bad.items()})

    for available in (37, 5):
        taps = [rng.standard_normal((3, 7, cfg.text_hidden_dim)).astype(np.float32) for _ in range(available)]
        mask = _mask([7, 2, 4], 7)
        assert model._select_layers(available) == jmodel._select_layers(available)
        for m in (jmodel, model):
            m.attach_text_encoders([_Taps(taps, mask)])
        ours, theirs = model.encode_text(["a", "b", "c"]), jmodel.encode_text(["a", "b", "c"])
        for a, b in zip(ours, theirs):
            assert sorted(a) == sorted(b) == ["attention_mask", "text_embeds"]
            assert a["text_embeds"].shape == (7, 12 if available == 37 else cfg.num_text_layers, cfg.text_hidden_dim)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
        collated, jcollated = model.collate_text_embeds(ours), jmodel.collate_text_embeds(theirs)
        assert sorted(collated) == sorted(jcollated) == ["text_attention_mask", "text_embeds"]
    assert model._select_layers(37) == (2, 5, 8, 11, 14, 17, 20, 23, 26, 29, 32, 35)


def test_render_payload_is_unmasked_in_both_packages():
    """Quirk kept (ROADMAP Queue 3): the render batch takes ``encode_text``'s
    payload keys as they are, so the mask rides as ``attention_mask``, which
    ``inference_conditioning`` does not read in either package: renders run
    unmasked, as for Lumina2.  ``text_attention_mask`` (the collate's key)
    is read."""
    jmodel, model = _pair(_tiny_values())
    payload = {"text_embeds": np.zeros((1, 6, 3, 32), np.float32), "attention_mask": _mask([3], 6)}
    assert sorted(model.inference_conditioning({k: t(v) for k, v in payload.items()})) == \
        sorted(jmodel.inference_conditioning(payload)) == ["text_embeds"]
    payload["text_attention_mask"] = payload.pop("attention_mask")
    assert sorted(model.inference_conditioning({k: t(v) for k, v in payload.items()})) == \
        ["text_attention_mask", "text_embeds"]


def test_fully_masked_text_gives_zero_where_jax_gives_nan():
    """Queue 3, JAX behaviour the port does not share: a caption with no
    valid token (mask all 0) leaves every refiner query with no key; the JAX
    module's -inf softmax gives NaN there and the NaN reaches the whole
    output, while the port's attention (the kernels' convention, held by
    their plain version here) gives those rows 0 and a finite output."""
    cfg = Krea2Config.tiny()
    inputs = _inputs(cfg, [0, 3], seed=12)
    jmodule = jkt.Krea2Transformer(config=jkt.Krea2Config.tiny(), dtype=jnp.float32)
    variables = _variables(jmodule, cfg, seed=13)
    port = bridge(variables, Krea2Transformer(cfg, dtype=torch.float32))
    ref = np.asarray(jmodule.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                   **{k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}).numpy()
    assert np.isnan(ref[0]).all() and np.isfinite(out).all()
    assert rel(out[1], ref[1]) < F32_REL


def _jax_params(jmodel, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(jmodel.arch, [6, 3]).items()}
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0), **example))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's file of a seeded tiny transformer (two shards):
    its names and shapes are the port's layout, the port's tree bitwise the
    JAX ``load_krea2_params`` tree (the (c, ph, pw) packing permuted), the
    imported module bitwise the bridged JAX tree."""
    jmodel, model = _pair(_tiny_values())
    weights = export_krea2_to_checkpoint(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == krea2_checkpoint_shapes(model.arch)
    root = tmp_path / "krea2" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_params(jmodel, str(tmp_path / "krea2"))
    _assert_trees_bitwise(load_krea2_params(model, str(tmp_path / "krea2")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "krea2"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_seeded_init_key_map_and_adapter_file_match_jax(tmp_path):
    """Quirk kept: ``init_parameters`` zeroes the tables, norms and q/k
    norms as the Flax initialisers do, so from a seeded base with fresh
    adapters (B = 0) only the B gradients are nonzero; ``krea2_key_map``
    equals the JAX map; an adapter file written by the port round-trips
    bitwise and loads into the JAX template bitwise."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    module = tl.init_parameters(model.create_module(), torch.Generator().manual_seed(0))
    for name, param in module.named_parameters():
        if name.endswith(("scale_shift_table", "norm1", "norm2", "norm_q", "norm_k", "final_norm", "txt_norm")):
            assert not param.any(), name
    assert module.text_projector.abs().sum() > 0
    assert _key_map_for(model) == JAX_KEY_MAPS["krea2"](jmodel) == krea2_key_map(model.arch)
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
