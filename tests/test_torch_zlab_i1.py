"""The torch port's Zlab-i1 family against the JAX package, on the CPU.

The FLUX.2 latent statistics and normalization, the sincos table (its
column-first meshgrid, verbatim) and the RoPE tables, the connector with its
learnable null caption, the block and the U-ViT transformer (the LIFO skips,
the masked joint attention with its rows zeroed, native and non-native grids,
under remat, in bf16) with its LoRA gradients against ``jax.grad``; the
family contract (no timestep, the negated prediction, ``transform_latents``
on 32 channels only), ``encode_text`` and collate, the import of the JAX
exporter's file, the key map and adapter files.  The trainer's trajectory
is in test_torch_longcat_zlab_trainer.py.  Every tolerance is stated where
it is checked.
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
from simpletuner_tpu.models.weight_export import export_zlab_i1_to_checkpoint
from simpletuner_tpu.models.weight_import import load_zlab_i1_params as jax_load_params
from simpletuner_tpu.models.zlab_i1 import latent_utils as jlu
from simpletuner_tpu.models.zlab_i1 import transformer as jzl
from simpletuner_tpu.models.zlab_i1.model import ZlabI1 as JaxZlabI1
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import zlab_i1_checkpoint_shapes
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_transformer_params, load_zlab_i1_params
from simpletuner_tpu_torch.models.zlab_i1 import ZlabI1, ZlabI1Config, ZlabI1Transformer
from simpletuner_tpu_torch.models.zlab_i1 import latent_utils as tlu
from simpletuner_tpu_torch.models.zlab_i1.transformer import I1Block, TextAdapter, rope_angles, sincos_pos_embed
from simpletuner_tpu_torch.training.lora import _key_map_for, zlab_i1_key_map

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
    return {"model_family": "zlab_i1", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxZlabI1(JaxTrainingConfig(values)), ZlabI1(config_namespace(values))


def _mask(lengths, length):
    return (np.arange(length)[None] < np.asarray(lengths)[:, None]).astype(np.int32)


def _inputs(cfg, lengths, seed=0, height=16, width=16, text_len=12, dropout=None):
    rng = np.random.default_rng(seed)
    out = {
        "latents": rng.standard_normal((2, height, width, cfg.in_channels), dtype=np.float32),
        "timesteps": np.asarray([0.13, 0.91], np.float32),
        "context": rng.standard_normal((2, text_len, cfg.text_embed_dim), dtype=np.float32),
        "context_mask": None if lengths is None else _mask(lengths, text_len),
    }
    if dropout is not None:
        out["caption_dropout"] = np.asarray(dropout, np.int32)
    return out


def _variables(jmodule, cfg, seed):
    """Seeded weights for every leaf (the native grid's ``pos_embed``, a nonzero null caption)."""
    example = {k: jnp.asarray(v) for k, v in _inputs(cfg, None).items() if v is not None}
    return numpy_variables(jmodule, **example, seed=seed)


def test_presets_and_contract_match_jax():
    """The presets (tiny and published: 2016 wide, 28 heads of 72, 29 blocks
    as 14 in, 1 mid and 14 out, rope axes (36, 18, 18), 3.17B parameters in
    the checkpoint layout), the family's constants, spec and example batch as
    the JAX family's; a non-flow prediction type is refused."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "LATENT_CHANNEL_COUNT"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    for ours, theirs in ((ZlabI1Config.tiny(), jzl.ZlabI1Config.tiny()), (ZlabI1Config(), jzl.ZlabI1Config())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert (ours.head_dim, ours.num_in_blocks, ours.ffn_inner, ours.axes_dims) == \
            (theirs.head_dim, theirs.num_in_blocks, theirs.ffn_inner, theirs.axes_dims)
    full = ZlabI1(config_namespace({**_tiny_values(), "model_arch_preset": None})).arch
    assert (full.hidden_size, full.num_heads, full.head_dim, full.depth, full.num_in_blocks, full.axes_dims,
            full.in_channels, full.text_embed_dim) == (2016, 28, 72, 29, 14, (36, 18, 18), 32, 2304)
    assert sum(int(np.prod(s)) for s in zlab_i1_checkpoint_shapes(full).values()) == 3_169_429_904
    assert "zlab_i1" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), ZlabI1)
    with pytest.raises(ValueError, match="flow-matching"):
        ZlabI1(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    for resolution in (None, 64):
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in model.example_batch(2, resolution).items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, resolution).items()}


def test_latent_statistics_and_normalization_match_jax():
    """The 128 FLUX.2 channel means and variances equal the JAX tables; the
    2x pixel unshuffle and shuffle bitwise the JAX ones and inverse to each
    other; the normalization within one f32 rounding of the JAX one (2^-22
    relative) and inverted by ``unscale_flux2_latents``."""
    assert tlu.FLUX2_LATENTS_MEAN == jlu.FLUX2_LATENTS_MEAN and tlu.FLUX2_LATENTS_VAR == jlu.FLUX2_LATENTS_VAR
    x = np.random.default_rng(0).standard_normal((2, 8, 6, 32)).astype(np.float32) * 2
    packed = tlu.pixel_unshuffle_2x(t(x))
    assert np.array_equal(packed.numpy(), np.asarray(jlu.pixel_unshuffle_2x(jnp.asarray(x))))
    assert torch.equal(tlu.pixel_shuffle_2x(packed), t(x))
    ours = tlu.normalize_flux2_latents(t(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jlu.normalize_flux2_latents(jnp.asarray(x))),
                               rtol=2.0 ** -22, atol=2.0 ** -22)
    np.testing.assert_allclose(tlu.unscale_flux2_latents(ours).numpy(), x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grid", [(8, 8, 128, 128), (4, 6, 64, 96), (64, 64, 1024, 1024)])
def test_sincos_table_matches_jax_bitwise(grid):
    """The column-first sincos table bitwise the JAX ``sincos_pos_embed``;
    its first half of features encodes the column (equal down a column)."""
    ours = sincos_pos_embed(96, *grid)
    assert np.array_equal(ours, jzl.sincos_pos_embed(96, *grid)) and ours.dtype == np.float32
    rows, cols = grid[:2]
    table = ours.reshape(rows, cols, 96)
    if rows > 1:
        assert np.array_equal(table[0, :, :48], table[1, :, :48]) and not np.array_equal(table[0, :, 48:],
                                                                                         table[1, :, 48:])


def test_rope_tables_match_jax():
    """cos and sin with the per-axis scales (1, 256 / H, 256 / W) at the
    published axes (36, 18, 18): within ``ROPE_ATOL`` of the JAX tables."""
    positions = np.random.default_rng(1).integers(0, 256, (2, 9, 3)).astype(np.int32)
    scales = (1.0, 0.25, 256.0 / 768.0)
    ours = rope_angles(t(positions), (36, 18, 18), scales, 10000.0)
    theirs = jzl.rope_angles(jnp.asarray(positions), (36, 18, 18), scales, 10000.0)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ROPE_ATOL)


def test_text_adapter_and_null_caption_match_jax():
    """The connector (f32, rank-4 adapters): within ``F32_REL``; a dropped
    caption (mask 1) is replaced by the learnable null caption, so its output
    is the same whatever the caption held, in both packages."""
    cfg = ZlabI1Config.tiny()
    rng = np.random.default_rng(2)
    caption = rng.standard_normal((2, 12, cfg.text_embed_dim)).astype(np.float32)
    dropout = np.asarray([0, 1], np.int32)
    jadapter = jzl.TextAdapter(jzl.ZlabI1Config.tiny(), dtype=jnp.float32, lora_rank=4)
    variables = numpy_variables(jadapter, jnp.asarray(caption), jnp.asarray(dropout), seed=3)
    port = bridge(variables, TextAdapter(ZlabI1Config.tiny(), dtype=torch.float32, lora_rank=4))
    apply = jax.jit(jadapter.apply)
    outs = []
    for case in (caption, caption + 1.0):
        ref = np.asarray(apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(case),
                               jnp.asarray(dropout)))
        with torch.no_grad():
            out = port(t(case), t(dropout)).numpy()
        assert rel(out, ref) < F32_REL
        outs.append(out)
    assert np.array_equal(outs[0][1], outs[1][1]) and not np.allclose(outs[0][0], outs[1][0])
    with torch.no_grad():
        null = port(port.null_caption.detach().expand(2, -1, -1).clone(), None).numpy()
    np.testing.assert_array_equal(null[1], outs[0][1])


@pytest.mark.parametrize("use_skip", [False, True])
def test_block_matches_jax(use_skip):
    """One U-ViT block (f32, rank-4 adapters), masked text (12 and 5 of 12
    valid), with and without the skip linears: within ``F32_REL``; masked
    text rows are exactly zero."""
    cfg = ZlabI1Config.tiny()
    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, 10, cfg.hidden_size)).astype(np.float32)
    txt = rng.standard_normal((2, 12, cfg.hidden_size)).astype(np.float32)
    img_angles = tuple(rng.uniform(-1, 1, (2, 10, cfg.head_dim // 2)).astype(np.float32) for _ in range(2))
    txt_angles = tuple(rng.uniform(-1, 1, (2, 12, cfg.head_dim // 2)).astype(np.float32) for _ in range(2))
    mask = _mask([12, 5], 12)
    skip = (rng.standard_normal(img.shape).astype(np.float32), rng.standard_normal(txt.shape).astype(np.float32))
    jblock = jzl.I1Block(jzl.ZlabI1Config.tiny(), use_skip=use_skip, dtype=jnp.float32, lora_rank=4)
    jargs = [jnp.asarray(img), jnp.asarray(txt), tuple(map(jnp.asarray, img_angles)),
             tuple(map(jnp.asarray, txt_angles)), jnp.asarray(mask),
             tuple(map(jnp.asarray, skip)) if use_skip else None]
    variables = numpy_variables(jblock, *jargs, seed=5)
    port = bridge(variables, I1Block(cfg, use_skip=use_skip, dtype=torch.float32, lora_rank=4))
    ref_img, ref_txt = jblock.apply(jax.tree_util.tree_map(jnp.asarray, variables), *jargs)
    with torch.no_grad():
        out_img, out_txt = port(t(img), t(txt), tuple(map(t, img_angles)), tuple(map(t, txt_angles)), t(mask),
                                *(map(t, skip) if use_skip else ()))
    assert rel(out_img.numpy(), ref_img) < F32_REL and rel(out_txt.numpy(), ref_txt) < F32_REL
    assert not out_txt[1, 5:].any()


@pytest.mark.parametrize("variant", ["native_masked", "non_native", "unmasked_dropout", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny U-ViT (f32, rank-4 adapters): on the native 8 x 8 grid (the
    learned ``pos_embed``) with masked text, on a 4 x 6 grid (the table made
    on the host), unmasked with one caption dropped, and under remat: the
    output within ``F32_REL``, the LoRA gradients of a seeded projection of
    it against ``jax.grad`` within ``GRAD_REL``, per adapter (the last out
    block's text-side adapters exactly zero on both sides)."""
    cfg = ZlabI1Config.tiny()
    remat = variant == "remat"
    size = (8, 12) if variant == "non_native" else (16, 16)
    inputs = _inputs(cfg, None if variant == "unmasked_dropout" else [12, 5], seed=6, height=size[0], width=size[1],
                     dropout=[0, 1] if variant == "unmasked_dropout" else None)
    jmodule = jzl.ZlabI1Transformer(config=jzl.ZlabI1Config.tiny(), dtype=jnp.float32, lora_rank=4, remat=remat)
    variables = _variables(jmodule, cfg, seed=7)
    port = bridge(variables, ZlabI1Transformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    weight = np.random.default_rng(9).standard_normal(inputs["latents"].shape).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jargs = {k: jnp.asarray(v) for k, v in inputs.items() if v is not None}

    def jax_loss(lora):
        out = jmodule.apply({"params": params, "lora": lora}, **jargs)
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(port)
    out = port(**{k: t(v) for k, v in inputs.items() if v is not None})
    assert tuple(out.shape) == ref.shape == inputs["latents"].shape and rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and "out_0/skip_text/lora_B" in flat
    for path, param in adapters.items():
        grad = np.zeros(param.shape, np.float32) if param.grad is None else param.grad.numpy()
        if not np.any(flat[path]):  # the last block's text path reaches no output
            assert not np.any(grad) and path.startswith(f"out_{cfg.num_in_blocks - 1}/"), path
        else:
            assert rel(grad.T, flat[path]) < GRAD_REL, path


def test_transformer_bf16_matches_jax():
    """The tiny U-ViT in bf16 (f32 adapters and norm scales), masked text,
    against the JAX module in bf16 on the same weights: within ``BF16_REL``."""
    cfg = ZlabI1Config.tiny()
    inputs = _inputs(cfg, [12, 7], seed=8)
    jmodule = jzl.ZlabI1Transformer(config=jzl.ZlabI1Config.tiny(), dtype=jnp.bfloat16, lora_rank=4)
    variables = _variables(jmodule, cfg, seed=9)
    port = bridge(variables, ZlabI1Transformer(cfg, dtype=torch.bfloat16, lora_rank=4))
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                            **{k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}).numpy()
    assert out.dtype == ref.dtype == np.float32 and rel(out, ref) < BF16_REL


def test_skips_pop_last_in_first_and_no_timestep(monkeypatch):
    """Out block i merges the outputs of in block ``num_in - 1 - i`` (LIFO),
    as the JAX module does, and the forward ignores its timestep (any value
    gives the same output)."""
    cfg = dataclasses.replace(ZlabI1Config.tiny(), depth=5)
    port = tl.init_parameters(ZlabI1Transformer(cfg, dtype=torch.float32), torch.Generator().manual_seed(0))
    inputs = {k: t(v) for k, v in _inputs(cfg, [12, 5], seed=10).items() if v is not None}
    produced, consumed = {}, {}
    original = I1Block.forward

    def recording(self, image_tokens, text_tokens, image_angles, text_angles, text_mask, skip_image=None,
                  skip_text=None):
        name = next(n for n, m in port.named_children() if m is self)
        if skip_image is not None:
            consumed[name] = skip_image
        out = original(self, image_tokens, text_tokens, image_angles, text_angles, text_mask, skip_image, skip_text)
        produced[name] = out[0]
        return out

    monkeypatch.setattr(I1Block, "forward", recording)
    with torch.no_grad():
        first = port(**inputs)
        second = port(**{**inputs, "timesteps": torch.tensor([0.5, 0.0])})
    assert torch.equal(first, second)
    assert sorted(consumed) == ["out_0", "out_1"]
    assert consumed["out_0"] is produced["in_1"] and consumed["out_1"] is produced["in_0"]


def test_family_transform_prediction_and_text_match_jax():
    """``transform_latents`` normalizes 32-channel latents (as the JAX family,
    within one f32 rounding) and leaves the tiny arch's 8 alone;
    ``get_model_inputs`` as the JAX family's, the prediction negated and
    within ``F32_REL`` of the JAX ``model_predict``; ``encode_text`` and
    collate package the states and the mask as the JAX family."""
    jmodel, model = _pair(_tiny_values())
    x32 = np.random.default_rng(11).standard_normal((1, 4, 4, 32)).astype(np.float32)
    np.testing.assert_allclose(model.transform_latents(t(x32)).numpy(),
                               np.asarray(jmodel.transform_latents(jnp.asarray(x32))), rtol=2.0 ** -22,
                               atol=2.0 ** -22)
    x8 = t(x32[..., :8])
    assert model.transform_latents(x8) is x8
    cfg = model.arch
    inputs = _inputs(cfg, [12, 3], seed=12)
    jmodule = jmodel.create_module()
    variables = _variables(jmodule, cfg, seed=13)
    module = bridge(variables, model.create_module())
    prepared = {"noisy_latents": inputs["latents"], "timesteps": inputs["timesteps"],
                "text_embeds": inputs["context"], "text_attention_mask": inputs["context_mask"]}
    assert sorted(model.get_model_inputs({k: t(v) for k, v in prepared.items()})) == \
        sorted(jmodel.get_model_inputs(prepared))
    with torch.no_grad():
        ours = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
        raw = module(**model.get_model_inputs({k: t(v) for k, v in prepared.items()})).numpy()
    theirs = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                      jax.tree_util.tree_map(jnp.asarray, prepared)))
    assert np.array_equal(ours, -raw) and rel(ours, theirs) < F32_REL
    rng = np.random.default_rng(3)
    states = {"last_hidden_state": rng.standard_normal((3, 9, 32)).astype(np.float32),
              "attention_mask": _mask([9, 2, 5], 9)}
    for m in (jmodel, model):
        m.attach_text_encoders([_StandIn(states)])
    ours, theirs = model.encode_text(["a", "b", "c"]), jmodel.encode_text(["a", "b", "c"])
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "text_embeds"]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    collated, jcollated = model.collate_text_embeds(ours), jmodel.collate_text_embeds(theirs)
    assert sorted(collated) == sorted(jcollated) == ["text_attention_mask", "text_embeds"]


def _jax_params(jmodel, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(jmodel.arch, None).items() if v is not None}
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0), **example))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's file of a seeded tiny transformer (two shards): its
    names and shapes are the port's layout (the patch conv, the position
    table, the null caption), the port's tree bitwise the JAX
    ``load_zlab_i1_params`` tree, the imported module bitwise the bridged
    JAX tree."""
    jmodel, model = _pair(_tiny_values())
    weights = export_zlab_i1_to_checkpoint(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == zlab_i1_checkpoint_shapes(model.arch)
    root = tmp_path / "zlab" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_params(jmodel, str(tmp_path / "zlab"))
    _assert_trees_bitwise(load_zlab_i1_params(model, str(tmp_path / "zlab")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "zlab"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_seeded_init_and_key_map_and_adapter_file_match_jax(tmp_path):
    """``init_parameters`` sets the native sincos table (as the Flax
    initialiser) and a zero null caption; ``zlab_i1_key_map`` equals the JAX
    map; an adapter file written by the port round-trips bitwise and loads
    into the JAX template bitwise."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    module = tl.init_parameters(model.create_module(), torch.Generator().manual_seed(0))
    cfg = model.arch
    assert np.array_equal(module.pos_embed.detach().numpy()[0], jzl.sincos_pos_embed(cfg.hidden_size, 8, 8, 128, 128))
    assert not module.text_adapter.null_caption.any()
    assert _key_map_for(model) == JAX_KEY_MAPS["zlab_i1"](jmodel) == zlab_i1_key_map(model.arch)
    source = _seeded_adapters(model, 4, scale=0.05)
    path = str(tmp_path / "adapter.safetensors")
    save_lora_safetensors(model, source, path)
    target = model.create_module()
    assert load_lora_safetensors(model, path, target) == []
    for (name, a), b in zip(tl.lora_parameters(target).items(), tl.lora_parameters(source).values()):
        assert torch.equal(a, b), name
    template = _variables(jmodel.create_module(), cfg, seed=1)["lora"]
    loaded = jax_load_lora(jmodel, path, template)
    loaded = loaded[0] if isinstance(loaded, tuple) else loaded
    for name, param in tl.lora_parameters(source).items():
        node = loaded
        for part in name.split("/"):
            node = node[part]
        assert np.array_equal(np.asarray(node), param.detach().numpy().T), name
