"""The torch port's LTX-Video family against the JAX package, on the CPU.

The DiT forward and its LoRA gradients with per-sample and per-frame
timesteps, with and without remat, at the tiny width (inner 64: 64 % 6 = 4,
so the RoPE tables pad) on a non-square 3 x 4 x 6 latent grid; ``ltx_rope``
bitwise at the tiny, 2B and 13B widths; ``prepare_batch``'s first-frame
paths (``ltx_protect_first_frame``, and ``ltx_i2v_prob`` /
``ltx_partial_noise_fraction`` with the JAX draws carried across); the family
contract and the video VAE at LTX's config (the 32 / 8 / 128 factors, the
tiny config's encode and decode, and LTX's six-level structure at narrow
widths); the diffusers import of the JAX exporter's file bitwise and
``ltx_checkpoint_shapes``; ``ltx_key_map`` and adapter files in the diffusers
and ComfyUI layouts with the JAX exporter; the JAX ``Trainer`` against the
port's on one cache of mp4 clips, step for step on the per-frame path;
checkpoint inference to an mp4; and a true-CFG render decoded by the video
VAE.  The same seeded numpy weights, inputs and noise go through both
packages; every tolerance is stated where it is checked.  At the tiny size
the head dim is 32; LTX's shapes at head dims 64 and 128 are held on the card
(test_torch_kernels_cuda.py, chip_smoke.py phases 3, 7 and 24).
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

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.ltxvideo.model import LTXVideo as JaxLTXVideo
from simpletuner_tpu.models.ltxvideo.transformer import LTXConfig as JaxLTXConfig
from simpletuner_tpu.models.ltxvideo.transformer import LTXTransformer as JaxLTXTransformer
from simpletuner_tpu.models.ltxvideo.transformer import ltx_rope as jax_ltx_rope
from simpletuner_tpu.models.text_encoders import load_text_encoders as jax_load_text_encoders
from simpletuner_tpu.models.video_vae import VideoAutoencoderKL as JaxVideoAutoencoderKL
from simpletuner_tpu.models.video_vae import VideoVAEConfig as JaxVideoVAEConfig
from simpletuner_tpu.models.weight_export import export_ltx_to_diffusers
from simpletuner_tpu.models.weight_import import load_ltx_params as jax_load_ltx_params
from simpletuner_tpu.training.lora import flatten_lora
from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora
from simpletuner_tpu.training.lora import ltx_key_map as jax_ltx_key_map
from simpletuner_tpu.training.lora import save_lora_safetensors as jax_save_lora
from simpletuner_tpu.training.validation import Validation as JaxValidation

from simpletuner_tpu_torch.configuration import TrainingConfig
from simpletuner_tpu_torch.inference import config_namespace, run_inference
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import ltx_checkpoint_shapes
from simpletuner_tpu_torch.models.ltxvideo import LTXConfig, LTXTransformer, LTXVideo, ltx_rope
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.t5 import t5_state_dict_from_flax
from simpletuner_tpu_torch.models.text_encoders import load_text_encoders
from simpletuner_tpu_torch.models.video_vae import VideoAutoencoderKL
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params, lora_to_flax
from simpletuner_tpu_torch.models.weight_import import (
    load_ltx_params, load_safetensors_file, load_transformer_params, save_safetensors,
)
from simpletuner_tpu_torch.training.lora import load_lora_safetensors, ltx_key_map, save_lora_safetensors
from simpletuner_tpu_torch.training.validation import Validation, noise_generator

from test_torch_wan import _read_mp4, _write_clips
from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# gradient-derived numbers (test_torch_sdxl.py: f32 gradients through a deep
# net are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
# prepare_batch: the same f32 elementwise products on both sides
PREPARE_ATOL = 1e-6
PROMPTS = ["a lighthouse on a basalt cliff at dusk", "", "a cat walking through snow"]


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
    return {"model_family": "ltxvideo", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxLTXVideo(JaxTrainingConfig(values)), LTXVideo(config_namespace(values))


# ---- the transformer ------------------------------------------------------------------------------


def test_presets_match_jax():
    """``LTXConfig()`` (2B), ``tiny()`` and the 13B flavour's arch equal the
    JAX configs field for field; both published widths pad the RoPE tables."""
    assert dataclasses.asdict(LTXConfig()) == dataclasses.asdict(JaxLTXConfig())
    assert dataclasses.asdict(LTXConfig.tiny()) == dataclasses.asdict(JaxLTXConfig.tiny())
    for flavour, expected in (("2b-0.9.5", LTXConfig()), ("13b-0.9.7", LTXConfig.b13())):
        values = {"model_family": "ltxvideo", "model_flavour": flavour}
        ours, theirs = LTXVideo(config_namespace(values)), JaxLTXVideo(JaxTrainingConfig(values))
        assert ours.arch == expected and dataclasses.asdict(ours.arch) == dataclasses.asdict(theirs.arch), flavour
    cfg, big = LTXConfig(), LTXConfig.b13()
    assert (cfg.hidden_size, cfg.depth, cfg.num_heads, cfg.head_dim, cfg.ffn_hidden) == (2048, 28, 32, 64, 8192)
    assert (big.hidden_size, big.depth, big.num_heads, big.head_dim, big.cross_dim) == (4096, 48, 32, 128, 4096)
    assert [c.num_heads * c.head_dim % 6 for c in (LTXConfig.tiny(), cfg, big)] == [4, 2, 4]


@pytest.mark.parametrize("variant", ["per_sample", "per_frame", "per_sample_remat", "per_frame_remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """A tiny DiT (f32, rank-4 adapters) on the same seeded weights, 3 x 4 x 6
    latents (72 tokens, a non-square grid) and 5 text tokens, timesteps (B,)
    or per latent frame (B, T): the output within ``F32_REL`` in relative L2,
    and the LoRA gradients of a seeded projection of it against ``jax.grad``
    within ``GRAD_REL``, per adapter."""
    per_frame, remat = variant.startswith("per_frame"), variant.endswith("remat")
    rng = np.random.default_rng(0)
    latents = rng.standard_normal((2, 3, 4, 6, 8), dtype=np.float32)
    timesteps = rng.uniform(0.02, 0.98, (2, 3) if per_frame else (2,)).astype(np.float32)
    context = rng.standard_normal((2, 5, 32), dtype=np.float32)
    weight = rng.standard_normal((2, 3, 4, 6, 8), dtype=np.float32)
    jmodule = JaxLTXTransformer(config=JaxLTXConfig.tiny(), dtype=jnp.float32, lora_rank=4, remat=remat)
    variables = numpy_variables(jmodule, jnp.asarray(latents), jnp.asarray(timesteps), jnp.asarray(context), seed=1)
    port = bridge(variables, LTXTransformer(LTXConfig.tiny(), dtype=torch.float32, lora_rank=4, remat=remat))

    def jax_loss(lora):
        out = jmodule.apply({"params": variables["params"], "lora": lora}, jnp.asarray(latents),
                            jnp.asarray(timesteps), jnp.asarray(context))
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(variables["lora"])
    adapters = tl.freeze_base(port)
    out = port(t(latents), t(timesteps), t(context))
    assert tuple(out.shape) == ref.shape == (2, 3, 4, 6, 8) and out.dtype == torch.float32
    assert rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and "block_1/attn2_k/lora_A" in flat
    assert "patch_in/lora_B" in flat and "caption_in_2/lora_A" in flat and "time_proj/lora_A" not in flat
    for path, param in adapters.items():
        assert param.grad is not None and rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_per_frame_timesteps_condition_each_frame():
    """Equal per-frame timesteps give the per-sample output (within
    ``F32_REL``), and changing frame 0's timestep changes frame 0's output
    most: every frame's tokens take their own frame's modulation."""
    rng = np.random.default_rng(3)
    latents = t(rng.standard_normal((1, 3, 4, 4, 8), dtype=np.float32))
    context = t(rng.standard_normal((1, 5, 32), dtype=np.float32))
    jmodule = JaxLTXTransformer(config=JaxLTXConfig.tiny(), dtype=jnp.float32)
    variables = numpy_variables(jmodule, jnp.zeros((1, 3, 4, 4, 8)), jnp.zeros((1,)), jnp.zeros((1, 5, 32)), seed=4)
    port = bridge(variables, LTXTransformer(LTXConfig.tiny(), dtype=torch.float32))
    with torch.no_grad():
        sample = port(latents, torch.tensor([0.6]), context).numpy()
        frames = port(latents, torch.tensor([[0.6, 0.6, 0.6]]), context).numpy()
        moved = port(latents, torch.tensor([[0.0, 0.6, 0.6]]), context).numpy()
    assert rel(frames, sample) < F32_REL
    change = np.abs(moved - frames).reshape(3, -1).mean(axis=1)
    assert change[0] > 0 and change[0] == change.max()


def test_ltx_rope_matches_jax_bitwise():
    """``ltx_rope`` equal to the JAX tables element for element at the tiny,
    2B and 13B widths on a non-square grid, the ``inner % 6`` leading entries
    cos 1 and sin 0; ``apply_ltx_rope`` is the interleaved pair rotation."""
    from simpletuner_tpu_torch.models.ltxvideo.transformer import apply_ltx_rope

    for ours_cfg, jax_cfg in ((LTXConfig.tiny(), JaxLTXConfig.tiny()), (LTXConfig(), JaxLTXConfig()),
                              (LTXConfig.b13(), JaxLTXConfig(hidden_size=4096, depth=48, num_heads=32, head_dim=128,
                                                             cross_dim=4096))):
        cos, sin = ltx_rope(ours_cfg, 3, 4, 6)
        jcos, jsin = jax_ltx_rope(jax_cfg, 3, 4, 6)
        inner, pad = ours_cfg.num_heads * ours_cfg.head_dim, ours_cfg.num_heads * ours_cfg.head_dim % 6
        assert cos.shape == sin.shape == (72, inner) and cos.dtype == np.float32
        assert np.array_equal(cos, jcos) and np.array_equal(sin, jsin)
        assert (cos[:, :pad] == 1).all() and (sin[:, :pad] == 0).all()
        assert np.array_equal(cos[:, pad::2], cos[:, pad + 1::2])  # one angle per interleaved pair
    x = torch.arange(8, dtype=torch.float32).reshape(1, 1, 8)
    cos, sin = torch.zeros(1, 8), torch.ones(1, 8)  # a quarter turn of every pair
    assert apply_ltx_rope(x, cos, sin).flatten().tolist() == [-1, 0, -3, 2, -5, 4, -7, 6]


# ---- prepare_batch -------------------------------------------------------------------------------


def _prepare_batch_pair(values, latents_shape, seed):
    """Both families' ``prepare_batch`` on one batch with the same noise and
    sigmas; the JAX i2v draws (``fold_in(rng, 0x17)``, the gate's then the
    fraction's uniform) carried to the port as ``override_i2v_draws``."""
    jmodel, model = _pair(values)
    rng = np.random.default_rng(seed)
    batch = {"latents": rng.standard_normal(latents_shape, dtype=np.float32),
             "text_embeds": rng.standard_normal((latents_shape[0], 5, 32), dtype=np.float32),
             "override_noise": rng.standard_normal(latents_shape, dtype=np.float32),
             "override_sigmas": rng.uniform(0.05, 0.95, latents_shape[0]).astype(np.float32)}
    key = jax.random.PRNGKey(seed)
    theirs = jmodel.prepare_batch(key, {k: jnp.asarray(v) for k, v in batch.items()})
    gate_key, frac_key = jax.random.split(jax.random.fold_in(key, 0x17))
    draws = np.stack([np.asarray(jax.random.uniform(k, (latents_shape[0], 1)))[:, 0] for k in (gate_key, frac_key)])
    ours = model.prepare_batch(torch.Generator().manual_seed(seed),
                               {**{k: t(v) for k, v in batch.items()}, "override_i2v_draws": t(draws)})
    return ours, theirs, batch, draws


@pytest.mark.parametrize("mode", ["protect", "i2v_prob", "default"])
def test_prepare_batch_first_frame_paths_match_jax(mode):
    """``ltx_protect_first_frame``: frame 0 at sigma 0, the noise untouched;
    ``ltx_i2v_prob`` 0.5 with ``ltx_partial_noise_fraction`` 0.2 over 6
    samples: the gated samples' frame 0 sigma and noise scaled by 1 - u x 0.2;
    the default config (``ltx_i2v_prob`` 0.1) also takes the per-frame path.
    ``timesteps`` (B, T), ``noisy_latents``, ``target`` and ``noise`` within
    ``PREPARE_ATOL`` of the JAX family's; ``sigmas`` stay (B,)."""
    extra = {"protect": {"ltx_protect_first_frame": True},
             "i2v_prob": {"ltx_i2v_prob": 0.5, "ltx_partial_noise_fraction": 0.2}, "default": {}}[mode]
    ours, theirs, batch, draws = _prepare_batch_pair(_tiny_values(**extra), (6, 3, 2, 4, 8), seed=11)
    assert tuple(ours["timesteps"].shape) == theirs["timesteps"].shape == (6, 3)
    for key in ("timesteps", "noisy_latents", "target", "noise", "sigmas"):
        assert np.abs(ours[key].numpy() - np.asarray(theirs[key])).max() <= PREPARE_ATOL, key
    sigmas, timesteps = batch["override_sigmas"], ours["timesteps"].numpy()
    np.testing.assert_array_equal(timesteps[:, 1:], np.repeat(sigmas[:, None], 2, axis=1))
    if mode == "protect":
        assert (timesteps[:, 0] == 0).all() and np.array_equal(ours["noise"].numpy(), batch["override_noise"])
        np.testing.assert_array_equal(ours["noisy_latents"][:, 0].numpy(), batch["latents"][:, 0])
    else:
        prob, frac = (0.5, 0.2) if mode == "i2v_prob" else (0.1, 0.05)
        gated = draws[0] < prob
        expected = np.where(gated, 1.0 - np.float32(draws[1] * frac), 1.0).astype(np.float32)
        np.testing.assert_allclose(timesteps[:, 0], sigmas * expected, rtol=1e-6)
        if mode == "i2v_prob":
            assert 0 < gated.sum() < 6  # both branches run


def test_prepare_batch_draws_from_the_generator_and_leaves_other_shapes():
    """Without overrides the i2v draws come from the step's generator after
    the noise and the sigmas (one generator state gives one batch); image
    latents or a one-frame clip keep the per-sample flow preparation."""
    _, model = _pair(_tiny_values(ltx_i2v_prob=1.0))
    batch = {"latents": torch.randn(2, 3, 2, 2, 8, generator=torch.Generator().manual_seed(0)),
             "text_embeds": torch.zeros(2, 5, 32)}
    first = model.prepare_batch(torch.Generator().manual_seed(5), batch)
    second = model.prepare_batch(torch.Generator().manual_seed(5), batch)
    assert all(torch.equal(first[k], second[k]) for k in ("timesteps", "noisy_latents", "noise"))
    assert (first["timesteps"][:, 0] < first["sigmas"]).all()
    for shape in ((2, 1, 2, 2, 8), (2, 4, 4, 8)):
        plain = model.prepare_batch(torch.Generator().manual_seed(5), {**batch, "latents": torch.zeros(shape)})
        assert tuple(plain["timesteps"].shape) == (2,) and torch.equal(plain["timesteps"], plain["sigmas"])


# ---- the family contract and the video VAE at LTX's config -------------------------------------


def test_contract_matches_jax():
    """The class attributes, the text encoder spec (T5-XXL at 128 tokens),
    the example batch and the model inputs; ``ltxvideo`` is ported and built
    by the registry; epsilon prediction is refused as in the JAX family."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "MODALITY", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR",
                 "HUGGINGFACE_PATHS", "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR",
                 "LATENT_CHANNEL_COUNT"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert model.TEXT_ENCODER_CONFIGURATION[0].max_length == 128 and not model.is_i2v and model.is_flow
    assert model.latent_channels == jmodel.latent_channels == 8
    assert {k: tuple(v.shape) for k, v in model.example_batch(2, 64).items()} == \
        {k: tuple(v.shape) for k, v in jmodel.example_batch(2, 64).items()}
    batch = {"noisy_latents": torch.zeros(1, 2, 2, 2, 8), "timesteps": torch.zeros(1, 2),
             "text_embeds": torch.zeros(1, 5, 32)}
    assert model.get_model_inputs(batch).keys() == {"latents", "timesteps", "context"}
    assert "ltxvideo" in PORTED and isinstance(get_model_family(TrainingConfig({"model_family": "ltxvideo"})), LTXVideo)
    with pytest.raises(ValueError, match="flow-matching"):
        get_model_family(TrainingConfig({"model_family": "ltxvideo", "prediction_type": "epsilon"}))
    assert TrainingConfig({"model_family": "ltxvideo"}).ltx_i2v_prob == 0.1  # the default takes the per-frame path


def test_video_vae_config_factors():
    """``video_vae_config()``: LTX's causal VAE (base 64, multipliers 1, 2, 4,
    8, 8, 8, temporal (F, T, T, T, F, F), 128 latents: 32x spatial, 8x
    temporal) and the tiny one (2x, 4x, 8 latents), each the JAX family's;
    121 x 512 x 768 frames give 16 x 16 x 24 latents."""
    for values in ({"model_family": "ltxvideo"}, _tiny_values()):
        jmodel, model = _pair(values)
        assert model.video_vae_config().__dict__ == jmodel.video_vae_config().__dict__
    full = LTXVideo(config_namespace({"model_family": "ltxvideo"})).video_vae_config()
    assert (full.spatial_factor, full.temporal_factor, full.latent_channels) == (32, 8, 128)
    assert (full.base_channels, full.channel_multipliers) == (64, (1, 2, 4, 8, 8, 8))
    assert full.temporal_downsample == (False, True, True, True, False, False)
    tiny = LTXVideo(config_namespace(_tiny_values())).video_vae_config()
    assert (tiny.spatial_factor, tiny.temporal_factor, tiny.latent_channels) == (2, 4, 8)
    assert ((121 - 1) // full.temporal_factor + 1, 512 // full.spatial_factor, 768 // full.spatial_factor) == \
        (16, 16, 24)


@pytest.mark.parametrize("config", ["tiny", "ltx_levels"])
def test_video_vae_at_ltx_config_matches_jax(config):
    """The video VAE (f32) at the family's tiny config (9 x 16 x 24 frames ->
    3 x 8 x 12 latents) and at LTX's six-level structure cut to base 4 and 16
    latents (9 x 64 x 96 frames -> 2 x 2 x 3 latents: 32x spatial, 8x
    temporal) on the same seeded weights: the mean latents and the decode
    of the JAX latents within ``F32_REL`` in relative L2."""
    if config == "tiny":
        cfg = LTXVideo(config_namespace(_tiny_values())).video_vae_config()
        frames, size, latent = (2, 9, 16, 24, 3), (3, 8, 12, 8), (9, 16, 24)
    else:
        full = LTXVideo(config_namespace({"model_family": "ltxvideo"})).video_vae_config()
        cfg = dataclasses.replace(full, base_channels=4, latent_channels=16)
        frames, size, latent = (1, 9, 64, 96, 3), (2, 2, 3, 16), (9, 64, 96)
    jcfg = JaxVideoVAEConfig(**cfg.__dict__)
    x = np.random.default_rng(5).uniform(-1, 1, frames).astype(np.float32)
    jvae = JaxVideoAutoencoderKL(jcfg, dtype=jnp.float32)
    variables = numpy_variables(jvae, jnp.asarray(x), seed=2)
    vae = bridge(variables, VideoAutoencoderKL(cfg, torch.float32))
    with torch.no_grad():
        mean = vae.encode(t(x)).numpy()
    ref = np.asarray(jvae.apply(variables, jnp.asarray(x), method=JaxVideoAutoencoderKL.encode))
    assert mean.shape == ref.shape == (frames[0],) + size and rel(mean, ref) < F32_REL
    with torch.no_grad():
        decoded = vae.decode(t(ref)).numpy()
    ref_decoded = np.asarray(jvae.apply(variables, jnp.asarray(ref), method=JaxVideoAutoencoderKL.decode))
    assert decoded.shape == ref_decoded.shape == (frames[0],) + latent + (3,)
    assert rel(decoded, ref_decoded) < F32_REL


# ---- text encoding -----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoders():
    """The JAX package's tiny T5 (20 tokens) and the port's module with its params."""
    specs = [dataclasses.replace(s, max_length=20) for s in LTXVideo.TEXT_ENCODER_CONFIGURATION]
    jax_encoders = jax_load_text_encoders(specs, tiny=True)
    ports = load_text_encoders(specs, tiny=True, device="cpu")
    ports[0].model.load_state_dict(t5_state_dict_from_flax(jax_encoders[0].model.params))
    return jax_encoders, ports


def test_encode_text_matches_jax(encoders):
    """The T5 last hidden state (pad positions kept) and its mask per
    prompt; the collate drops the mask."""
    jmodel, model = _pair(_tiny_values())
    jmodel.attach_text_encoders(encoders[0])
    model.attach_text_encoders(encoders[1])
    ours, theirs = model.encode_text(PROMPTS), jmodel.encode_text(PROMPTS)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
        assert a["text_embeds"].shape == b["text_embeds"].shape == (20, 32)
        assert rel(a["text_embeds"], b["text_embeds"]) < F32_REL
    assert sorted(model.collate_text_embeds(ours)) == sorted(jmodel.collate_text_embeds(theirs)) == ["text_embeds"]


# ---- weight import and adapter files -------------------------------------------------------------------


def _jax_params(jmodel, seed):
    arch = jmodel.arch
    shapes = jax.eval_shape(lambda: JaxLTXTransformer(config=arch).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 4, 4, arch.in_channels)), jnp.zeros(1),
        jnp.zeros((1, 5, arch.text_dim))))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's diffusers file of a seeded tiny transformer (two
    shards in ``transformer/``): its tensors have the names and shapes of
    ``ltx_checkpoint_shapes``, the port's tree is bitwise the JAX
    ``load_ltx_params`` tree, and the imported module bitwise the bridged
    JAX tree; an e4m3 file imports as its values taken to bf16."""
    jmodel, model = _pair(_tiny_values())
    weights = export_ltx_to_diffusers(_jax_params(jmodel, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == ltx_checkpoint_shapes(model.arch)
    root = tmp_path / "ltx" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_ltx_params(jmodel, str(tmp_path / "ltx"))
    _assert_trees_bitwise(load_ltx_params(model, str(tmp_path / "ltx")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "ltx"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name
    fp8 = {k: torch.from_numpy(v).to(torch.float8_e4m3fn) for k, v in weights.items()}
    save_safetensors(fp8, str(tmp_path / "ltx_fp8.safetensors"))
    low = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "ltx_fp8.safetensors"))
    assert torch.equal(low.block_1.attn2_k.weight, fp8["transformer_blocks.1.attn2.to_k.weight"].float())


def _seeded_adapters(model, seed, scale=1.0):
    module = tl.init_parameters(model.create_module(), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for param in tl.lora_parameters(module).values():
            param.copy_(torch.from_numpy(scale * rng.standard_normal(tuple(param.shape)).astype(np.float32)))
    return module


@pytest.mark.parametrize("fmt", ["diffusers", "comfyui"])
def test_key_map_and_adapter_files_round_trip_with_jax(tmp_path, fmt):
    """``ltx_key_map`` equal to the JAX map; port -> JAX -> port bitwise in the
    diffusers layout (``transformer.transformer_blocks.N.attn1.to_q.lora_A``)
    and the ComfyUI layout (``diffusion_model.`` prefix, ``lora_down`` /
    ``lora_up``), each package's file equal to the other's; the diffusers
    targets ``to_q`` / ``to_k`` / ``to_v`` / ``to_out.0`` adapt the eight
    attention projections of every block and nothing else."""
    jmodel, model = _pair(_tiny_values(lora_alpha=8))
    assert ltx_key_map(model.arch) == jax_ltx_key_map(jmodel.arch)
    module = _seeded_adapters(model, 1)
    original = {k: v.detach().clone() for k, v in tl.lora_parameters(module).items()}
    first, second = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    save_lora_safetensors(model, module, first, format=fmt)
    jax_save_lora(jmodel, lora_to_flax(module), second, format=fmt)
    ours, theirs = load_safetensors_file(first), load_safetensors_file(second)
    assert sorted(ours) == sorted(theirs) and all(torch.equal(ours[k], theirs[k]) for k in theirs)
    prefix = "transformer.transformer_blocks.1.attn2.to_out.0." if fmt == "diffusers" else \
        "diffusion_model.transformer_blocks.1.attn2.to_out.0."
    assert any(k.startswith(prefix) for k in ours), sorted(ours)[:4]
    assert any("ff.net.0.proj" in k for k in ours)
    loaded = jax_load_lora(jmodel, first, lora_to_flax(_seeded_adapters(model, 9)))
    expected, got = flatten_lora(lora_to_flax(module)), flatten_lora(loaded)
    assert all(np.array_equal(got[p][leaf], a) for p, leaves in expected.items() for leaf, a in leaves.items())
    fresh = _seeded_adapters(model, 2)
    assert load_lora_safetensors(model, second, fresh) == []
    assert all(torch.equal(v.detach(), original[k]) for k, v in tl.lora_parameters(fresh).items())
    targeted = LTXVideo(config_namespace(_tiny_values(lora_target_modules=["to_q", "to_k", "to_v", "to_out.0"])))
    adapted = {path.rsplit("/", 2)[-2] for path in tl.lora_parameters(targeted.create_module())}
    assert adapted == {f"{a}_{p}" for a in ("attn1", "attn2") for p in ("q", "k", "v", "proj")}


# ---- the trainer and checkpoint inference --------------------------------------------------------------


def _trainer_values(root, out, **extra):
    return {
        "model_family": "ltxvideo", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
        "optimizer": "adamw", "learning_rate": 1e-3, "lr_scheduler": "constant", "max_train_steps": 2,
        "train_batch_size": 1, "resolution": 40, "report_to": "jsonl", "mixed_precision": "fp32",
        "tokenizer_max_length": 16, "cache_dir": str(root / "cache"), "output_dir": str(root / out),
        "checkpointing_steps": 2, "seed": 42, "ltx_protect_first_frame": True,
        "data_backend_config": [
            {"id": "clips", "dataset_type": "video", "type": "local", "instance_data_dir": str(root / "data"),
             "resolution": 40, "resolution_type": "pixel_area", "aspect_bucket_alignment": 16,
             "caption_strategy": "textfile", "cache_dir_vae": str(root / "cache" / "vae"), "repeats": 1,
             "video": {"num_frames": 9}},
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": str(root / "cache" / "text")},
        ],
        **extra,
    }


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The JAX ``Trainer`` and the port's on one cache: tiny LTX from the JAX
    exporter's file of one seeded tree, warm-started from one seeded adapter,
    2 steps over four clips in two video buckets with the same noise and
    sigmas (the Flux trainer test's recipe) and ``ltx_protect_first_frame``:
    the per-frame path without a random draw.  The JAX run writes the latent
    cache with its video VAE; the port reads it."""
    from simpletuner_tpu import native as jax_native
    from simpletuner_tpu.data.dataset import MultiDatasetIterator as JaxIterator
    from simpletuner_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from simpletuner_tpu.training import trainer as jax_trainer_module
    from simpletuner_tpu.training.trainer import Trainer as JaxTrainer

    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
    from simpletuner_tpu_torch.data.dataset import MultiDatasetIterator
    from simpletuner_tpu_torch.training.trainer import Trainer

    from test_torch_trainer import _overriding

    root = tmp_path_factory.mktemp("ltx_trainer")
    _write_clips(root / "data")
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jmodel, port_model = _pair(_trainer_values(root, "x"))
    path = str(root / "ltx.safetensors")
    exported = export_ltx_to_diffusers(_jax_params(jmodel, 3), jmodel.arch)
    np_save_file({k: np.ascontiguousarray(v) for k, v in exported.items()}, path)
    lora_path = str(root / "init_lora.safetensors")
    save_lora_safetensors(port_model, _seeded_adapters(port_model, 4, scale=0.05), lora_path)
    extra = {"pretrained_model_name_or_path": path, "init_lora": lora_path}
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "ltxvideo")
    rng = np.random.default_rng(5)
    for i in range(4):
        cache.save(f"clip {i}", {"text_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                                 "attention_mask": (np.arange(16) < 4).astype(np.int32)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        mp.setattr(jax_trainer_module, "build_mesh", lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        mp.setattr(JaxIterator, "next_batch", _overriding(JaxIterator.next_batch))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(_trainer_values(root, "jax", **extra)))
        jax_trainer.run()
        mp.setattr(MultiDatasetIterator, "next_batch", _overriding(MultiDatasetIterator.next_batch))
        port_trainer = Trainer(config=_trainer_values(root, "port", **extra), device="cpu")
        port_trainer.run()
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])
    return root, jax_trainer, port_trainer


def test_trainer_matches_jax(trainer_runs):
    """2 steps over 5-D latents on the per-frame path, no state shared between
    the runs: per-step loss within 1e-5 relative (``TRAJECTORY_TOL``), grad
    norm within ``GRAD_REL``; the LoRA export holds the JAX map's names and,
    within ``GRAD_REL`` in relative L2, its tensors; both trainers built the
    family's tiny video VAE and saw the two video buckets."""
    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    root, jax_trainer, port_trainer = trainer_runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [1, 2]
    for a, b in zip(ours, theirs):
        assert abs(a["loss"] - b["loss"]) <= TRAJECTORY_TOL * max(1.0, abs(b["loss"])), (a["step"], a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_REL * abs(b["grad_norm"]), (a["step"], a, b)
    export = "checkpoint-2/pytorch_lora_weights.safetensors"
    mine = load_safetensors_file(str(root / "port" / export))
    jax_file = load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file) and any(".attn1.to_q.lora_" in k for k in mine)
    keys = sorted(mine)
    assert rel(np.concatenate([mine[k].numpy().ravel() for k in keys]),
               np.concatenate([jax_file[k].numpy().ravel() for k in keys])) < GRAD_REL
    tiny = LTXVideo(config_namespace(_tiny_values())).video_vae_config()
    assert isinstance(port_trainer.vae, VideoAutoencoderKL) and port_trainer.vae.config == tiny
    assert jax_trainer.vae.config.__dict__ == tiny.__dict__
    bundle = port_trainer.data_plane.bundles["clips"]
    assert sorted(bundle.metadata_backend.aspect_ratio_bucket_indices) == ["1.0x9", "1.5x9"]
    latents = bundle.vae_cache.load(bundle.metadata_backend.aspect_ratio_bucket_indices["1.5x9"][0])
    assert latents.shape == (3, 16, 24, 8)


def test_checkpoint_inference_writes_mp4(trainer_runs):
    """``run_inference`` from the port's checkpoint-2 on the CPU (the tiny T5
    encodes the prompt): one mp4 of ``validation_num_video_frames`` frames at
    the validation resolution, square."""
    root, _, _ = trainer_runs
    config = root / "render.json"
    values = _trainer_values(root, "port", pretrained_model_name_or_path=str(root / "ltx.safetensors"),
                             validation_resolution=32, validation_num_video_frames=5, validation_guidance=2.0)
    config.write_text(json.dumps(values))
    output = str(root / "render")
    assert run_inference("a clip of waves", checkpoint=str(root / "port" / "checkpoint-2"), config_path=str(config),
                         output=output, steps=2, device="cpu") == 0
    (path,) = [os.path.join(output, "validation", f) for f in os.listdir(os.path.join(output, "validation"))]
    assert path.endswith(".mp4") and _read_mp4(path).shape == (5, 32, 32, 3)


# ---- validation render -----------------------------------------------------------------------------


def test_cfg_render_matches_jax(encoders, monkeypatch, tmp_path):
    """A true-CFG flow Euler render (LTX has no guidance embedding) through
    each package's ``Validation``: prompt and negative prompt encoded by the
    tiny T5 (the JAX params in the port's module), the same DiT weights and
    noise, 4 guided steps over 3 latent frames (9 frames) of 16 x 16, then
    the family's tiny video VAE on one seeded tree: the latents within 1e-4
    (the render tolerance of test_torch_inference.py: f32, sum order only),
    the uint8 frames within one level, and both packages' mp4 files of 9
    frames at 32 x 32."""
    config = _tiny_values(model_type="full", validation_prompt=PROMPTS[0], validation_negative_prompt="blurry",
                          validation_guidance=3.5, validation_num_inference_steps=4, validation_resolution=32,
                          validation_seed=7, tokenizer_max_length=20)
    jmodel, model = _pair(config)
    jmodel.attach_text_encoders(encoders[0])
    model.attach_text_encoders(encoders[1])
    variables = {"params": _jax_params(jmodel, 3)}
    module = bridge(variables, model.create_module())
    vae_config = model.video_vae_config()
    jvae = JaxVideoAutoencoderKL(JaxVideoVAEConfig(**vae_config.__dict__), dtype=jnp.float32)
    vae_vars = numpy_variables(jvae, jnp.zeros((1, 5, 16, 16, 3)), seed=6)
    vae = bridge(vae_vars, VideoAutoencoderKL(vae_config, torch.float32))

    validation = Validation(model, config_namespace(config), device="cpu")
    validation.precompute_embeds()
    assert validation._wants_cfg() and validation._latent_shape(1) == (1, 3, 16, 16, 8)
    latents = validation._render_single(module, validation._embeds[0], 0)  # no decode_fn: the latents
    validation.decode_fn, validation.output_dir = vae.decode, str(tmp_path / "port")
    frames = validation._render_single(module, validation._embeds[0], 0)
    noise = torch.randn((1, 3, 16, 16, 8), generator=noise_generator(7, 0)).numpy()
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    jvalidation = JaxValidation(jmodel, JaxTrainingConfig(config))
    jvalidation.precompute_embeds()
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    ref = np.asarray(jvalidation._render_single(jvars, jvalidation._embeds[0], 0))
    assert latents.shape == ref.shape == (3, 16, 16, 8) and np.isfinite(latents).all()
    assert rel(latents, ref) < 1e-4
    jvalidation = JaxValidation(jmodel, JaxTrainingConfig(config), output_dir=str(tmp_path / "jax"),
                                decode_fn=lambda z: jvae.apply(vae_vars, z, method=JaxVideoAutoencoderKL.decode))
    jvalidation.precompute_embeds()
    ref_frames = np.asarray(jvalidation._render_single(jvars, jvalidation._embeds[0], 0))
    assert frames.shape == ref_frames.shape == (9, 32, 32, 3) and frames.dtype == ref_frames.dtype == np.uint8
    assert np.abs(frames.astype(int) - ref_frames.astype(int)).max() <= 1
    (path,) = validation.run_validations(module, 3, force=True)
    (jax_path,) = jvalidation.run_validations(jvars, 3, force=True)
    assert os.path.basename(path) == os.path.basename(jax_path) == "step_3_0.mp4"
    assert _read_mp4(path).shape == _read_mp4(jax_path).shape == (9, 32, 32, 3)
