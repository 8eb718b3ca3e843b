"""The torch port's Cosmos core, Cosmos-Predict2's EDM path and the EDM
Euler scheduler against the JAX package, on the CPU.

The presets (2B and 14B), the rope tables, the block and the core (image
and clip inputs, per-token timesteps, the learnable position embedding of
the tiny preset, remat, bf16) with LoRA gradients against ``jax.grad``;
the EDM training math (log-normal sigmas, additive noise, the
preconditioned x0 prediction, the (sigma^2 + 1) / sigma^2 weighted loss);
the Karras sigma ladder and its Euler step, and a true-CFG x0 sample loop
against the JAX loop; ``encode_text`` and the collate; the import of the
JAX exporter's file, the key map and adapter files.  The trainer's
trajectory is in test_torch_cosmos_anima_krea2_trainer.py.  Every tolerance
is stated where it is checked.
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
from simpletuner_tpu.models.cosmos1 import transformer as jct
from simpletuner_tpu.models.cosmos2.model import Cosmos2Image as JaxCosmos
from simpletuner_tpu.models.weight_export import export_cosmos1_to_checkpoint
from simpletuner_tpu.models.weight_import import load_cosmos2_params as jax_load_params
from simpletuner_tpu.schedulers import EDMEulerScheduler as JaxEDMEuler
from simpletuner_tpu.schedulers.sampling import classifier_free_guidance as jax_cfg
from simpletuner_tpu.schedulers.sampling import sample_loop as jax_sample_loop
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS
from simpletuner_tpu.training.validation import build_scheduler as jax_build_scheduler

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import cosmos1_checkpoint_shapes
from simpletuner_tpu_torch.models.cosmos1 import Cosmos1Config, Cosmos1Transformer
from simpletuner_tpu_torch.models.cosmos1.transformer import Cosmos1Block, cosmos1_rope
from simpletuner_tpu_torch.models.cosmos2 import Cosmos2Image
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_cosmos2_params, load_transformer_params
from simpletuner_tpu_torch.schedulers import EDMEulerScheduler
from simpletuner_tpu_torch.schedulers.sampling import classifier_free_guidance, sample_loop
from simpletuner_tpu_torch.training.lora import _key_map_for, cosmos1_core_key_map
from simpletuner_tpu_torch.training.validation import build_scheduler

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
    return {"model_family": "cosmos", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxCosmos(JaxTrainingConfig(values)), Cosmos2Image(config_namespace(values))


def _inputs(cfg, seed=0, frames=1, height=8, width=12, text_len=6, tokenwise=False, mask=None):
    rng = np.random.default_rng(seed)
    grid = frames * (height // 2) * (width // 2)
    out = {
        "latents": rng.standard_normal((2, frames, height, width, cfg.in_channels), dtype=np.float32),
        "timesteps": (rng.uniform(0.05, 0.95, (2, grid)) if tokenwise else np.asarray([0.13, 0.91])).astype(
            np.float32),
        "context": rng.standard_normal((2, text_len, cfg.text_embed_dim), dtype=np.float32),
    }
    if mask is not None:
        out["context_mask"] = (np.arange(text_len)[None] < np.asarray(mask)[:, None]).astype(np.int32)
    return out


def _variables(jmodule, cfg, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(cfg).items()}
    return numpy_variables(jmodule, **example, seed=seed)


def test_presets_and_contract_match_jax():
    """The presets (tiny, the 2B one of 1.96B parameters in the checkpoint
    layout and in the JAX tree, the 14B one: 40 heads of 128, 36 layers,
    rope scale (1, 4, 4), no learnable position embedding), the family's
    constants (the EDM sigmas), spec and example batch as the JAX family's;
    the 14B flavour picks the 14B arch, a non-sample prediction type is
    refused and the bucket alignment is forced to 16."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS",
                 "DEFAULT_LORA_TARGET", "LATENT_CHANNEL_COUNT", "sigma_min", "sigma_max", "sigma_data",
                 "sigma_schedule_order"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    for name in ("tiny", "anima", "predict2_2b", "predict2_14b"):
        assert dataclasses.asdict(getattr(Cosmos1Config, name)()) == dataclasses.asdict(getattr(jct.Cosmos1Config,
                                                                                               name)()), name
    full = Cosmos2Image(config_namespace({**_tiny_values(), "model_arch_preset": None})).arch
    b14 = Cosmos2Image(config_namespace({**_tiny_values(), "model_arch_preset": None, "model_flavour": "14b"})).arch
    assert full == Cosmos1Config.predict2_2b() and b14 == Cosmos1Config.predict2_14b()
    assert (b14.num_heads, b14.head_dim, b14.num_layers, b14.rope_scale, b14.learnable_pos_embed) == \
        (40, 128, 36, (1.0, 4.0, 4.0), False)
    assert sum(math.prod(s) for s in cosmos1_checkpoint_shapes(full).values()) == 1_956_405_248
    example = {k: (v.shape, v.dtype) for k, v in _inputs(full).items()}
    tree = jax.eval_shape(lambda: jct.Cosmos1Transformer(config=jct.Cosmos1Config.predict2_2b()).init(
        jax.random.PRNGKey(0), **{k: jnp.zeros(*spec) for k, spec in example.items()}))
    assert sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree)) == 1_956_405_248
    assert "cosmos" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), Cosmos2Image)
    with pytest.raises(ValueError, match="sample-prediction"):
        Cosmos2Image(config_namespace(_tiny_values(prediction_type="flow_matching"))).check_user_config()
    aligned = config_namespace(_tiny_values(aspect_bucket_alignment=64))
    Cosmos2Image(aligned).check_user_config()
    assert aligned.aspect_bucket_alignment == 16
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 64).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 64).items()}


@pytest.mark.parametrize("fps", [None, 12.0])
def test_rope_tables_match_jax_bitwise(fps):
    """The per-axis NTK rope tables (float64, then f32) bitwise the JAX
    ``cosmos1_rope`` at the 2B preset's head dim over a 3 x 64 x 64 grid,
    with frame positions and with fps-scaled ones."""
    cfg = Cosmos1Config.predict2_2b()
    ours = cosmos1_rope(cfg, (3, 64, 64), fps)
    theirs = jct.cosmos1_rope(jct.Cosmos1Config.predict2_2b(), (3, 64, 64), fps)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("masked", [False, True])
def test_block_matches_jax(masked):
    """One block (AdaLN-LoRA, rope self-attention, cross-attention, exact
    gelu; f32, rank-4 adapters), with and without a context mask (6 and 2
    of 6 keys): within ``F32_REL`` of the JAX block."""
    cfg = Cosmos1Config.tiny()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, cfg.hidden_size)).astype(np.float32)
    ctx = rng.standard_normal((2, 6, cfg.text_embed_dim)).astype(np.float32)
    embedded = rng.standard_normal((2, cfg.hidden_size)).astype(np.float32)
    temb = rng.standard_normal((2, 3 * cfg.hidden_size)).astype(np.float32)
    rope = cosmos1_rope(cfg, (1, 4, 6))
    mask = (np.arange(6)[None] < np.asarray([[6], [2]])).astype(np.int32) if masked else None
    jblock = jct.Cosmos1Block(jct.Cosmos1Config.tiny(), dtype=jnp.float32, lora_rank=4)
    jargs = (jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(embedded), jnp.asarray(temb),
             tuple(map(jnp.asarray, rope)), None if mask is None else jnp.asarray(mask.astype(bool)))
    variables = numpy_variables(jblock, *jargs, seed=2)
    port = bridge(variables, Cosmos1Block(cfg, torch.float32, lora_rank=4))
    ref = jblock.apply(jax.tree_util.tree_map(jnp.asarray, variables), *jargs)
    with torch.no_grad():
        out = port(t(x), t(ctx), t(embedded), t(temb), tuple(map(t, rope)),
                   None if mask is None else torch.where(t(mask) > 0, 1, -1).to(torch.int32))
    assert rel(out.numpy(), ref) < F32_REL


@pytest.mark.parametrize("variant", ["image", "clip_fps", "tokenwise", "remat", "published_head"])
def test_core_forward_and_lora_grads_match_jax(variant):
    """The tiny core (f32, rank-4 adapters, the learnable position
    embedding): a one-frame image, a 3-frame clip with fps-scaled rope, (B,
    S) per-token timesteps, under remat, and the anima layout at the tiny
    width (no position embedding, rope scale (1, 4, 4), head dim 64): the
    output within ``F32_REL``, the LoRA gradients of a seeded projection of
    it against ``jax.grad`` within ``GRAD_REL``, per adapter."""
    cfg, jcfg = Cosmos1Config.tiny(), jct.Cosmos1Config.tiny()
    if variant == "published_head":
        change = dict(num_heads=2, head_dim=64, learnable_pos_embed=False, rope_scale=(1.0, 4.0, 4.0))
        cfg, jcfg = dataclasses.replace(cfg, **change), dataclasses.replace(jcfg, **change)
    remat = variant == "remat"
    inputs = _inputs(cfg, seed=3, frames=3 if variant == "clip_fps" else 1, tokenwise=variant == "tokenwise")
    kwargs = {"fps": 12.0} if variant == "clip_fps" else {}
    jmodule = jct.Cosmos1Transformer(config=jcfg, dtype=jnp.float32, lora_rank=4, remat=remat)
    variables = _variables(jmodule, cfg, seed=4)
    port = bridge(variables, Cosmos1Transformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    weight = np.random.default_rng(5).standard_normal(inputs["latents"].shape).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jargs = {k: jnp.asarray(v) for k, v in inputs.items()}

    def jax_loss(lora):
        out = jmodule.apply({"params": params, "lora": lora}, **jargs, **kwargs)
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(port)
    out = port(**{k: t(v) for k, v in inputs.items()}, **kwargs)
    assert tuple(out.shape) == ref.shape == inputs["latents"].shape and rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and "patch_embed/lora_B" in flat
    for path, param in adapters.items():
        assert rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_core_bf16_matches_jax():
    """The tiny core in bf16 (f32 adapters, norm scales and AdaLN heads)
    against the JAX module in bf16 on the same weights: within ``BF16_REL``."""
    cfg = Cosmos1Config.tiny()
    inputs = _inputs(cfg, seed=6)
    jmodule = jct.Cosmos1Transformer(config=jct.Cosmos1Config.tiny(), dtype=jnp.bfloat16, lora_rank=4)
    variables = _variables(jmodule, cfg, seed=7)
    port = bridge(variables, Cosmos1Transformer(cfg, dtype=torch.bfloat16, lora_rank=4))
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                            **{k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}).numpy()
    assert out.dtype == ref.dtype == np.float32 and rel(out, ref) < BF16_REL


def _family_module(jmodel, model, seed):
    jmodule = jmodel.create_module()
    example = {"latents": jnp.zeros((1, 1, 8, 12, 4)), "timesteps": jnp.zeros((1,)),
               "context": jnp.zeros((1, 6, model.arch.text_embed_dim))}
    variables = numpy_variables(jmodule, **example, seed=seed)
    return variables, bridge(variables, model.create_module())


def test_edm_training_math_matches_jax():
    """``prepare_batch`` with the override hooks: sigmas, timesteps (the
    sigmas), x_t = x0 + sigma eps and the x0 target bitwise the JAX ones;
    ``get_model_inputs`` (c_in = 1 / (sigma + 1), timestep sigma /
    (sigma + 1), the one-frame axis) within one f32 rounding;
    ``model_predict`` (x0 = x_t / (sigma + 1) - sigma / (sigma + 1) r) and
    the (sigma^2 + 1) / sigma^2 weighted loss within ``F32_REL`` of the JAX
    family at sigma_min, 1.3 and sigma_max, a loss mask and loss weights
    included; the weight at sigma_min is 250001 and stays f32."""
    jmodel, model = _pair(_tiny_values())
    variables, module = _family_module(jmodel, model, seed=8)
    rng = np.random.default_rng(9)
    batch = {"latents": rng.standard_normal((3, 8, 12, 4)).astype(np.float32),
             "text_embeds": rng.standard_normal((3, 6, 32)).astype(np.float32),
             "override_noise": rng.standard_normal((3, 8, 12, 4)).astype(np.float32),
             "override_sigmas": np.asarray([0.002, 1.3, 80.0], np.float32)}
    ours = model.prepare_batch(torch.Generator().manual_seed(0), {k: t(v) for k, v in batch.items()})
    theirs = jmodel.prepare_batch(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    for key in ("sigmas", "timesteps", "noisy_latents", "noise", "target"):
        assert np.array_equal(ours[key].numpy(), np.asarray(theirs[key])), key
    inputs, jinputs = model.get_model_inputs(ours), jmodel.get_model_inputs(theirs)
    assert sorted(inputs) == sorted(jinputs) and inputs["latents"].shape == (3, 1, 8, 12, 4)
    for key in ("latents", "timesteps"):
        np.testing.assert_allclose(inputs[key].numpy(), np.asarray(jinputs[key]), rtol=2.0 ** -23, atol=0)
    ours["loss_mask"] = t((rng.uniform(size=(3, 8, 12, 4)) > 0.3).astype(np.float32))
    ours["loss_weight"] = t(np.asarray([0.5, 1.0, 2.0], np.float32))
    theirs = dict(theirs, loss_mask=jnp.asarray(ours["loss_mask"].numpy()),
                  loss_weight=jnp.asarray(ours["loss_weight"].numpy()))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    with torch.no_grad():
        pred = model.model_predict(module, ours)
        loss = model.compute_loss(pred, ours)
    jpred = jax.jit(jmodel.model_predict)(jvars, theirs)
    assert rel(pred.numpy(), np.asarray(jpred)) < F32_REL
    jloss = float(jmodel.compute_loss(jpred, theirs))
    assert abs(float(loss) - jloss) <= F32_REL * abs(jloss) and loss.dtype == torch.float32
    sigma = torch.tensor(0.002)
    assert float((sigma ** 2 + 1) / sigma ** 2) == pytest.approx(250001.0, rel=1e-6)


def test_edm_sigma_draw_is_log_normal_and_on_the_device_generator():
    """Without overrides the noise is drawn first and then u; sigma =
    exp(sqrt(2) erfinv(2u - 1)) is a clamped log-normal: over 20,000 draws
    log sigma has mean 0 and std 1 within 0.03, every sigma lies in [0.002,
    80]; the same generator seed gives the same draws."""
    _, model = _pair(_tiny_values())
    latents = torch.zeros((20000, 1, 1, 1))
    first = model.prepare_batch(torch.Generator().manual_seed(3), {"latents": latents})
    again = model.prepare_batch(torch.Generator().manual_seed(3), {"latents": latents})
    sigmas = first["sigmas"]
    assert torch.equal(sigmas, again["sigmas"]) and torch.equal(first["noise"], again["noise"])
    assert float(sigmas.min()) >= 0.002 and float(sigmas.max()) <= 80.0
    log = sigmas.log()
    assert abs(float(log.mean())) < 0.03 and abs(float(log.std()) - 1.0) < 0.03
    gen = torch.Generator().manual_seed(3)
    noise = torch.randn(latents.shape, generator=gen)
    u = torch.rand((20000,), generator=gen)
    assert torch.equal(noise, first["noise"])
    expected = torch.exp(math.sqrt(2.0) * torch.special.erfinv(2.0 * (u * (1 - 2 * 2.0 ** -23) + 2.0 ** -23) - 1.0))
    assert torch.equal(sigmas, expected.clamp(0.002, 80.0))


def test_edm_euler_ladder_and_step_match_jax():
    """The Karras rho = 7 ladder (80 ... 0.002, then 0) bitwise the JAX
    scheduler's at 4 and 30 steps, ``build_scheduler`` gives it for cosmos in
    both packages (with the family's constants), ``init_latents`` and one
    Euler step on an x0 estimate bitwise the JAX ones."""
    jmodel, model = _pair(_tiny_values())
    for steps in (4, 30):
        ours, theirs = EDMEulerScheduler.create(steps), JaxEDMEuler.create(steps)
        assert np.array_equal(ours.sigmas.numpy(), np.asarray(theirs.sigmas))
        assert np.array_equal(ours.timesteps.numpy(), np.asarray(theirs.timesteps))
        assert ours.num_steps == theirs.num_steps == steps
        assert float(ours.sigmas[0]) == pytest.approx(80.0) and float(ours.sigmas[-2]) == pytest.approx(0.002)
    built, jbuilt = build_scheduler(model, 5), jax_build_scheduler(jmodel, 5)
    assert isinstance(built, EDMEulerScheduler) and isinstance(jbuilt, JaxEDMEuler)
    assert np.array_equal(built.sigmas.numpy(), np.asarray(jbuilt.sigmas))
    rng = np.random.default_rng(10)
    noise, x0 = rng.standard_normal((2, 4, 4, 4)).astype(np.float32), rng.standard_normal((2, 4, 4, 4)).astype(
        np.float32)
    latents = built.init_latents(t(noise))
    assert np.array_equal(latents.numpy(), np.asarray(jbuilt.init_latents(jnp.asarray(noise))))
    for i in (0, 3, 4):
        np.testing.assert_allclose(built.step(i, latents, t(x0)).numpy(),
                                   np.asarray(jbuilt.step(i, jnp.asarray(latents.numpy()), jnp.asarray(x0))),
                                   rtol=2.0 ** -22, atol=2.0 ** -22)
    # sigma_next = 0 lands on x0, up to the roundings of latents 80 times its size
    np.testing.assert_allclose(built.step(4, latents, t(x0)).numpy(), x0, rtol=0, atol=1e-4)


def test_true_cfg_x0_sample_loop_matches_jax():
    """A 4-step true-CFG render (guidance 4.5) down the EDM Euler ladder on
    the family's x0 predictions, against the JAX sample loop on the JAX
    family's ``denoise_fn`` from the same noise: within ``F32_REL``."""
    jmodel, model = _pair(_tiny_values())
    variables, module = _family_module(jmodel, model, seed=11)
    rng = np.random.default_rng(12)
    embeds, negative = (rng.standard_normal((1, 6, 32)).astype(np.float32) for _ in range(2))
    noise = rng.standard_normal((1, 8, 12, 4)).astype(np.float32)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jc = jmodel.denoise_fn(jvars, jmodel.inference_conditioning({"text_embeds": jnp.asarray(embeds)}))
    ju = jmodel.denoise_fn(jvars, jmodel.inference_conditioning({"text_embeds": jnp.asarray(negative)}))
    theirs = jax_sample_loop(jax_build_scheduler(jmodel, 4), lambda x, s: jax_cfg(jc(x, s), ju(x, s), 4.5),
                             jnp.asarray(noise))
    c = model.denoise_fn(module, model.inference_conditioning({"text_embeds": t(embeds)}))
    u = model.denoise_fn(module, model.inference_conditioning({"text_embeds": t(negative)}))
    with torch.no_grad():
        ours = sample_loop(build_scheduler(model, 4), lambda x, s: classifier_free_guidance(c(x, s), u(x, s), 4.5),
                           t(noise))
    assert np.isfinite(ours.numpy()).all() and rel(ours.numpy(), np.asarray(theirs)) < F32_REL


def test_encode_text_zeroes_the_pads_and_the_collate_drops_the_mask():
    """``encode_text`` zeroes T5's states past each prompt's mask and keeps
    the mask, as the JAX family; the collate stacks the states only, so the
    zeroed pads still attend in the cross-attention (unmasked, as in JAX)."""
    jmodel, model = _pair(_tiny_values())
    rng = np.random.default_rng(13)
    states = {"last_hidden_state": rng.standard_normal((3, 9, 32)).astype(np.float32),
              "attention_mask": (np.arange(9)[None] < np.asarray([[9], [2], [5]])).astype(np.int32)}
    for m in (jmodel, model):
        m.attach_text_encoders([_StandIn(states)])
    ours, theirs = model.encode_text(["a", "b", "c"]), jmodel.encode_text(["a", "b", "c"])
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "text_embeds"]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert not ours[1]["text_embeds"][2:].any() and ours[1]["text_embeds"][:2].all()
    assert sorted(model.collate_text_embeds(ours)) == sorted(jmodel.collate_text_embeds(theirs)) == ["text_embeds"]


def _jax_params(jmodel, seed):
    example = {"latents": jnp.zeros((1, 1, 8, 12, 4)), "timesteps": jnp.zeros((1,)),
               "context": jnp.zeros((1, 6, jmodel.arch.text_embed_dim))}
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0), **example))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's file of a seeded tiny core (two shards, the
    learnable position tables included): its names and shapes are the port's
    layout, the port's tree bitwise the JAX ``load_cosmos2_params`` tree,
    the imported module bitwise the bridged JAX tree."""
    jmodel, model = _pair(_tiny_values())
    weights = export_cosmos1_to_checkpoint(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == cosmos1_checkpoint_shapes(model.arch)
    root = tmp_path / "cosmos" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_params(jmodel, str(tmp_path / "cosmos"))
    _assert_trees_bitwise(load_cosmos2_params(model, str(tmp_path / "cosmos")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "cosmos"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_seeded_init_key_map_and_adapter_file_match_jax(tmp_path):
    """``init_parameters`` gives unit q/k norm and time-norm scales and
    N(0, 0.02) position tables as the Flax initialisers; the AdaLN heads'
    gates start at temb's (nonzero) share, as in JAX; ``cosmos1_core_key_map``
    equals the JAX map (``patch_embed`` kept under its own name); an adapter
    file written by the port round-trips bitwise and loads into the JAX
    template bitwise."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    module = tl.init_parameters(model.create_module(), torch.Generator().manual_seed(0))
    assert torch.equal(module.block_0.attn1_norm_q, torch.ones(12)) and torch.equal(module.t_norm, torch.ones(24))
    assert 0.01 < float(module.pos_emb_h.detach().std()) < 0.03
    key_map = _key_map_for(model)
    assert key_map == JAX_KEY_MAPS["cosmos"](jmodel) == cosmos1_core_key_map(model.arch)
    assert "patch_embed" not in key_map and key_map["block_1/attn2_out"] == "transformer_blocks.1.attn2.to_out.0"
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
