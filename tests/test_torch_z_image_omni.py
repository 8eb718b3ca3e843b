"""The torch port's Z-Image-Omni family against the JAX package, on the CPU.

The RoPE tables, the block (modulated with a per-token noisy / clean
selection, and the refiners' unmodulated form), the transformer in
text-to-image and with a clean reference image and SigLIP features (caption
masked and not, under remat, in bf16) and its LoRA gradients against
``jax.grad``; the kept semantics: each token's noise mask picking its
modulation, the caption taking the first image's mask, the learned pad token
substituted at padded caption positions (which stay attended), the segment
ids all 1; the family contract (reversed timestep, negated prediction, the
edit / omni inputs passed through), ``encode_text`` and collate, the import
of the JAX exporter's file, the key map and adapter files.  The trainer's
trajectory is in test_torch_longcat_zlab_trainer.py.  Every tolerance is
stated where it is checked.
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
from simpletuner_tpu.models.weight_export import export_z_image_omni_to_diffusers
from simpletuner_tpu.models.weight_import import load_z_image_omni_params as jax_load_params
from simpletuner_tpu.models.z_image_omni import transformer as jzo
from simpletuner_tpu.models.z_image_omni.model import ZImageOmni as JaxZImageOmni
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import z_image_omni_checkpoint_shapes
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_transformer_params, load_z_image_omni_params
from simpletuner_tpu_torch.models.z_image_omni import ZImageOmni, ZImageOmniConfig, ZImageOmniTransformer
from simpletuner_tpu_torch.models.z_image_omni import transformer as tzo
from simpletuner_tpu_torch.models.z_image_omni.transformer import ZOmniBlock, rope_angles, rope_frequencies
from simpletuner_tpu_torch.training.lora import _key_map_for, z_image_omni_key_map

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
# the RoPE tables: the frequencies and angles are bitwise the JAX ones (f32
# throughout); torch's and XLA's f32 cos and sin differ by at most one ulp
# of 1.0
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
    return {"model_family": "z_image_omni", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxZImageOmni(JaxTrainingConfig(values)), ZImageOmni(config_namespace(values))


def _mask(lengths, length):
    return (np.arange(length)[None] < np.asarray(lengths)[:, None]).astype(np.int32)


def _inputs(cfg, lengths, seed=0, height=8, width=6, cap_len=7, cond=False, siglip=False):
    rng = np.random.default_rng(seed)
    out = {
        "latents": rng.standard_normal((2, height, width, cfg.in_channels), dtype=np.float32),
        "timesteps": np.asarray([0.13, 0.91], np.float32),
        "context": rng.standard_normal((2, cap_len, cfg.cap_feat_dim), dtype=np.float32),
        "context_mask": None if lengths is None else _mask(lengths, cap_len),
    }
    if siglip:
        out["siglip_embeds"] = rng.standard_normal((2, 3, 2, cfg.siglip_feat_dim), dtype=np.float32)
    if cond:
        out["cond_latents"] = rng.standard_normal((2, height, width, cfg.in_channels), dtype=np.float32)
    return out


def _full_variables(jmodule, cfg, seed):
    """Seeded weights for every leaf, the SigLIP refiners included."""
    example = {k: jnp.asarray(v) for k, v in _inputs(cfg, None, cond=True, siglip=True).items() if v is not None}
    return numpy_variables(jmodule, **example, seed=seed)


def test_presets_and_contract_match_jax():
    """The presets (tiny and published: 3840 wide, 30 heads of 128, 30 layers
    and 2 + 2 + 2 refiners, theta 256, axes (32, 48, 48); 6.51B parameters in
    the checkpoint layout), the family's constants, spec and example batch as
    the JAX family's; a non-flow prediction type is refused."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR", "LATENT_CHANNEL_COUNT"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    for ours, theirs in ((ZImageOmniConfig.tiny(), jzo.ZImageOmniConfig.tiny()),
                         (ZImageOmniConfig(), jzo.ZImageOmniConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert (ours.head_dim, ours.adaln_dim, ours.ffn_inner) == (theirs.head_dim, theirs.adaln_dim, theirs.ffn_inner)
    full = ZImageOmni(config_namespace({**_tiny_values(), "model_arch_preset": None})).arch
    assert (full.hidden_size, full.num_heads, full.head_dim, full.depth, full.refiner_depth, full.rope_theta,
            full.axes_dim, full.adaln_dim, full.ffn_inner) == (3840, 30, 128, 30, 2, 256.0, (32, 48, 48), 256, 10240)
    assert sum(int(np.prod(s)) for s in z_image_omni_checkpoint_shapes(full).values()) == 6_513_259_200
    assert "z_image_omni" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), ZImageOmni)
    with pytest.raises(ValueError, match="flow-matching"):
        ZImageOmni(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 128).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 128).items()}


@pytest.mark.parametrize("axes", [(32, 48, 48), (8, 8, 8)])
def test_rope_tables_match_jax(axes):
    """The f32 frequencies bitwise the JAX module's; cos and sin at (index,
    row, col) ids up to 4,700 (the published sequence's reach) within
    ``ROPE_ATOL`` of the JAX ``rope_angles`` at theta 256."""
    positions = np.random.default_rng(0).integers(0, 4700, (2, 9, 3)).astype(np.int32)
    freqs = rope_frequencies(axes, 256.0)
    for f, d in zip(freqs, axes):
        steps = jnp.arange(0, d, 2, dtype=jnp.float32)
        assert np.array_equal(f.numpy(), np.asarray(1.0 / (256.0 ** (steps / d))))
    ours = rope_angles(t(positions), freqs)
    theirs = jzo.rope_angles(jnp.asarray(positions), axes, 256.0)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape == (2, 9, sum(axes) // 2)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ROPE_ATOL)


@pytest.mark.parametrize("modulation", [True, False])
def test_block_matches_jax(modulation):
    """One block (f32, rank-4 adapters): modulated, each token picking the
    noisy or the clean modulation by its noise mask, masked by segment ids;
    or the refiners' form: within ``F32_REL``."""
    cfg = ZImageOmniConfig.tiny()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.hidden_size), dtype=np.float32)
    angles = tuple(rng.uniform(-1, 1, (2, 9, cfg.head_dim // 2)).astype(np.float32) for _ in range(2))
    cond = [rng.standard_normal((2, cfg.adaln_dim), dtype=np.float32) for _ in range(2)] if modulation else [None] * 2
    noise_mask = (rng.uniform(size=(2, 9)) < 0.5).astype(np.int32) if modulation else None
    seg = _mask([9, 6], 9)
    jblock = jzo.ZOmniBlock(jzo.ZImageOmniConfig.tiny(), modulation=modulation, dtype=jnp.float32, lora_rank=4)
    wrap = lambda v: None if v is None else jnp.asarray(v)  # noqa: E731
    args = [jnp.asarray(x), tuple(map(jnp.asarray, angles)), wrap(cond[0]), wrap(cond[1]), wrap(noise_mask), wrap(seg)]
    variables = numpy_variables(jblock, *args, seed=2)
    port = bridge(variables, ZOmniBlock(cfg, modulation=modulation, dtype=torch.float32, lora_rank=4))
    ref = jblock.apply(jax.tree_util.tree_map(jnp.asarray, variables), *args)
    tt = lambda v: None if v is None else t(v)  # noqa: E731
    with torch.no_grad():
        out = port(t(x), tuple(map(t, angles)), tt(cond[0]), tt(cond[1]), tt(noise_mask), t(seg))
    assert tuple(out.shape) == ref.shape and rel(out.numpy(), ref) < F32_REL


@pytest.mark.parametrize("variant", ["t2i_masked", "t2i_unmasked", "cond_siglip", "cond_only", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny DiT (f32, rank-4 adapters, every module's weights seeded):
    text-to-image with a caption mask (7 and 4 of 7 valid) and without, with a
    clean reference image and SigLIP features, with the reference alone, and
    under remat: the output within ``F32_REL``, the LoRA gradients of a
    seeded projection of it against ``jax.grad`` within ``GRAD_REL``, per
    adapter (the SigLIP modules' exactly zero where no SigLIP input rides)."""
    cfg = ZImageOmniConfig.tiny()
    remat = variant == "remat"
    cond = variant in ("cond_siglip", "cond_only", "remat")
    inputs = _inputs(cfg, None if variant == "t2i_unmasked" else [7, 4], seed=3, cond=cond,
                     siglip=variant in ("cond_siglip", "remat"))
    jmodule = jzo.ZImageOmniTransformer(config=jzo.ZImageOmniConfig.tiny(), dtype=jnp.float32, lora_rank=4,
                                        remat=remat)
    variables = _full_variables(jmodule, cfg, seed=4)
    port = bridge(variables, ZImageOmniTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
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
    assert sorted(flat) == sorted(adapters) and "siglip_refiner_0/attn_q/lora_A" in flat
    for path, param in adapters.items():
        grad = np.zeros(param.shape, np.float32) if param.grad is None else param.grad.numpy()
        if not np.any(flat[path]):
            assert not np.any(grad), path
        else:
            assert rel(grad.T, flat[path]) < GRAD_REL, path


def test_transformer_bf16_matches_jax():
    """The tiny DiT in bf16 (f32 adapters and norm scales) with a reference
    image and SigLIP features, against the JAX module in bf16 on the same
    weights: within ``BF16_REL``."""
    cfg = ZImageOmniConfig.tiny()
    inputs = _inputs(cfg, [7, 5], seed=5, cond=True, siglip=True)
    jmodule = jzo.ZImageOmniTransformer(config=jzo.ZImageOmniConfig.tiny(), dtype=jnp.bfloat16, lora_rank=4)
    variables = _full_variables(jmodule, cfg, seed=6)
    port = bridge(variables, ZImageOmniTransformer(cfg, dtype=torch.bfloat16, lora_rank=4))
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                            **{k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}).numpy()
    assert out.dtype == ref.dtype == np.float32 and rel(out, ref) < BF16_REL


def test_noise_masks_pads_and_segments_as_in_jax(monkeypatch):
    """What the JAX module does, seen in the port: every joint layer gets the
    noise mask ``[caption | cond | noisy | siglip]`` = ``[0 | 0 | 1 | 0]``
    with a reference image (the caption takes the first image's, clean) and
    ``[1 | 1]`` without, and segment ids all 1; the noise refiner's mask is
    ``[0 | 1]`` over (cond, target).  A padded caption token's features never
    reach the output (the learned pad token replaces them) while the pad
    token's own value does (the pads stay attended); both outputs within
    ``F32_REL`` of the JAX module's."""
    cfg = ZImageOmniConfig.tiny()
    inputs = _inputs(cfg, [7, 4], seed=7, cond=True, siglip=True)
    jmodule = jzo.ZImageOmniTransformer(config=jzo.ZImageOmniConfig.tiny(), dtype=jnp.float32)
    variables = _full_variables(jmodule, cfg, seed=8)
    port = bridge(variables, ZImageOmniTransformer(cfg, dtype=torch.float32))
    seen = []
    original = ZOmniBlock.forward

    def recording(self, x, angles, cond_noisy=None, cond_clean=None, noise_mask=None, segment_ids=None):
        seen.append((self.modulation, x.shape[1], None if noise_mask is None else noise_mask.clone(),
                     None if segment_ids is None else segment_ids.clone()))
        return original(self, x, angles, cond_noisy, cond_clean, noise_mask, segment_ids)

    monkeypatch.setattr(ZOmniBlock, "forward", recording)
    apply = jax.jit(jmodule.apply)
    outs = {}
    for name, change in (("base", None), ("pad_features", "pads"), ("pad_token", "token")):
        case = {k: v.copy() for k, v in inputs.items()}
        vars_ = variables
        if change == "pads":
            case["context"][1, 4:] = 50.0
        port_case = port
        if change == "token":
            vars_ = jax.tree_util.tree_map(lambda x: x, variables)
            vars_["params"]["cap_pad_token"] = variables["params"]["cap_pad_token"] + 0.5
            port_case = bridge(vars_, ZImageOmniTransformer(cfg, dtype=torch.float32))
        seen.clear()
        with torch.no_grad():
            outs[name] = port_case(**{k: t(v) for k, v in case.items()}).numpy()
        theirs = np.asarray(apply(jax.tree_util.tree_map(jnp.asarray, vars_), **{k: jnp.asarray(v)
                                                                                  for k, v in case.items()}))
        assert rel(outs[name], theirs) < F32_REL, name
    assert np.array_equal(outs["pad_features"], outs["base"]) and not np.allclose(outs["pad_token"][1], outs["base"][1])
    img = 4 * 3
    joint = [s for s in seen if s[0] and s[1] > 2 * img]
    assert len(joint) == cfg.depth
    expected = np.concatenate([np.zeros((2, 7 + img)), np.ones((2, img)), np.zeros((2, 6))], axis=1)
    for _, _, noise, segments in joint:
        np.testing.assert_array_equal(noise.numpy(), expected)
        assert segments.min() == segments.max() == 1
    refiner = [s for s in seen if s[0] and s[1] == 2 * img]
    assert len(refiner) == cfg.refiner_depth and refiner[0][3] is None
    np.testing.assert_array_equal(refiner[0][2].numpy(), np.concatenate([np.zeros((2, img)), np.ones((2, img))], 1))
    seen.clear()
    with torch.no_grad():
        port(**{k: t(v) for k, v in inputs.items() if k in ("latents", "timesteps", "context", "context_mask")})
    for _, _, noise, _ in [s for s in seen if s[0] and s[1] == 7 + img]:
        assert noise.min() == noise.max() == 1  # text-to-image: the caption rides noisy


def test_model_inputs_and_prediction_match_jax():
    """``get_model_inputs`` passes ``1 - sigma``, the mask, ``control_latents``
    as ``cond_latents`` and ``siglip_embeds``, as the JAX family; the
    prediction is the negated transformer output, within ``F32_REL`` of the
    JAX ``model_predict``; ``inference_conditioning`` keeps the same keys."""
    jmodel, model = _pair(_tiny_values())
    cfg = model.arch
    inputs = _inputs(cfg, [7, 3], seed=10, cond=True, siglip=True)
    jmodule = jmodel.create_module()
    variables = _full_variables(jmodule, cfg, seed=11)
    module = bridge(variables, model.create_module())
    prepared = {"noisy_latents": inputs["latents"], "timesteps": inputs["timesteps"],
                "text_embeds": inputs["context"], "text_attention_mask": inputs["context_mask"],
                "control_latents": inputs["cond_latents"], "siglip_embeds": inputs["siglip_embeds"]}
    ported = model.get_model_inputs({k: t(v) for k, v in prepared.items()})
    assert sorted(ported) == sorted(jmodel.get_model_inputs(prepared))
    np.testing.assert_array_equal(ported["timesteps"].numpy(), 1.0 - inputs["timesteps"])
    with torch.no_grad():
        ours = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
        raw = module(**ported).numpy()
    theirs = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                      jax.tree_util.tree_map(jnp.asarray, prepared)))
    assert np.array_equal(ours, -raw) and rel(ours, theirs) < F32_REL
    batch = {"latents": prepared["noisy_latents"], **{k: prepared[k] for k in
                                                      ("text_embeds", "text_attention_mask", "siglip_embeds")}}
    assert sorted(model.inference_conditioning({k: t(v) for k, v in batch.items()})) == \
        sorted(jmodel.inference_conditioning(batch))


def test_encode_text_and_collate_match_jax():
    """The Qwen states and the mask per prompt, and the collate's
    ``text_attention_mask``, as the JAX family packages them."""
    jmodel, model = _pair(_tiny_values())
    rng = np.random.default_rng(3)
    qwen = {"last_hidden_state": rng.standard_normal((3, 9, 32)).astype(np.float32),
            "attention_mask": _mask([9, 2, 5], 9)}
    for m in (jmodel, model):
        m.attach_text_encoders([_StandIn(qwen)])
    ours, theirs = model.encode_text(["a", "b", "c"]), jmodel.encode_text(["a", "b", "c"])
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "text_embeds"]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    collated, jcollated = model.collate_text_embeds(ours), jmodel.collate_text_embeds(theirs)
    assert sorted(collated) == sorted(jcollated) == ["text_attention_mask", "text_embeds"]
    for key in collated:
        np.testing.assert_array_equal(collated[key], jcollated[key])


def _jax_params(jmodel, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(jmodel.arch, None, cond=True, siglip=True).items()
               if v is not None}
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0), **example))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's diffusers file of a seeded tiny transformer (two
    shards, the ``"2-1"`` patch keys and the SigLIP modules): its names and
    shapes are the port's layout, the port's tree bitwise the JAX
    ``load_z_image_omni_params`` tree, the imported module bitwise the
    bridged JAX tree (the pad token included)."""
    jmodel, model = _pair(_tiny_values())
    weights = export_z_image_omni_to_diffusers(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == z_image_omni_checkpoint_shapes(model.arch)
    assert "all_x_embedder.2-1.weight" in weights and "siglip_refiner.0.attention.to_q.weight" in weights
    root = tmp_path / "z_omni" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_params(jmodel, str(tmp_path / "z_omni"))
    _assert_trees_bitwise(load_z_image_omni_params(model, str(tmp_path / "z_omni")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "z_omni"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_key_map_and_adapter_file_match_jax(tmp_path):
    """``z_image_omni_key_map`` equal to the JAX map; an adapter file written
    by the port round-trips through the port's loader bitwise and loads into
    the JAX template bitwise; with ``DEFAULT_LORA_TARGET`` as the targets
    only the attention projections carry adapters."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    assert _key_map_for(model) == JAX_KEY_MAPS["z_image_omni"](jmodel) == z_image_omni_key_map(model.arch)
    targeted = ZImageOmni(config_namespace(_tiny_values(lora_target_modules=list(ZImageOmni.DEFAULT_LORA_TARGET))))
    assert {name.rsplit("/", 2)[-2] for name in tl.lora_parameters(targeted.create_module())} == \
        {"attn_q", "attn_k", "attn_v", "attn_proj"}
    source = _seeded_adapters(model, 4, scale=0.05)
    path = str(tmp_path / "adapter.safetensors")
    save_lora_safetensors(model, source, path)
    target = model.create_module()
    assert load_lora_safetensors(model, path, target) == []
    for (name, a), b in zip(tl.lora_parameters(target).items(), tl.lora_parameters(source).values()):
        assert torch.equal(a, b), name
    template = _full_variables(jmodel.create_module(), model.arch, seed=1)["lora"]
    loaded = jax_load_lora(jmodel, path, template)
    loaded = loaded[0] if isinstance(loaded, tuple) else loaded
    for name, param in tl.lora_parameters(source).items():
        node = loaded
        for part in name.split("/"):
            node = node[part]
        assert np.array_equal(np.asarray(node), param.detach().numpy().T), name


def test_module_names_keep_the_jax_layout():
    """Every base tensor of the port's module is a leaf of the JAX tree (the
    bridge checks the converse), so the SigLIP stack is built whether or not
    a batch carries SigLIP features, as the JAX family's example batch does."""
    cfg = ZImageOmniConfig.tiny()
    variables = _full_variables(jzo.ZImageOmniTransformer(config=jzo.ZImageOmniConfig.tiny()), cfg, seed=0)
    port = bridge(variables, ZImageOmniTransformer(cfg, lora_rank=0))
    assert "siglip_refiner_0.attn_q.weight" in port.state_dict() and hasattr(tzo, "ADALN_EMBED_DIM")
