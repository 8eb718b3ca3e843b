"""The torch port's LTX-2 latent upsampler, Gemma connectors and
spatial-upscale render against the JAX package, on the CPU.

The upsampler with every head the JAX module has (spatial; spatiotemporal;
temporal with its first-frame crop; rational at 0.75, 1.5, 2 and 4 with the
binomial blur), its GroupNorm(32) and post-add activation, the statistics
wrapper ``upsample_ltx2_video_latents`` and the importer (the config from
the file's metadata) bitwise; the connectors' per-layer masked range
normalisation, the 1-D connector with its per-row roll of left-padded tokens
and tiled registers on a batch of two with different valid counts (and its
refusal of a length that is not a multiple of the register count), the whole
``LTX2TextConnectors`` in f32 and bf16 and its importer bitwise; the
``jax.image.resize`` copies at shrinking and growing ratios; the two-stage
spatial-upscale render of the tiny preset against the JAX
``_render_multistage`` on the same noise, and the staged renders of other
families still refused.  Every tolerance is stated where it is checked.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.ltxvideo2 import connectors as jc
from simpletuner_tpu.models.ltxvideo2 import latent_upsampler as ju
from simpletuner_tpu.models.ltxvideo2.model import LTXVideo2 as JaxLTXVideo2
from simpletuner_tpu.training.validation import Validation as JaxValidation

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models.checkpoint_layouts import (
    ltx2_connector_checkpoint_shapes, ltx2_upsampler_checkpoint_shapes,
)
from simpletuner_tpu_torch.models.ltxvideo2 import LTXVideo2
from simpletuner_tpu_torch.models.ltxvideo2 import connectors as tc
from simpletuner_tpu_torch.models.ltxvideo2 import latent_upsampler as tu
from simpletuner_tpu_torch.models.ltxvideo2.model import resize_linear, resize_nearest
from simpletuner_tpu_torch.models.weight_import import read_safetensors
from simpletuner_tpu_torch.training.validation import Validation, noise_generator

from test_torch_ltxvideo2 import _Encoder, _jax_params
from test_torch_trainer import _seeded
from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# bf16 on both sides: each rounds its own intermediates
BF16_REL = 2e-2
# a sampled render, f32: the render tolerance of test_torch_inference.py
RENDER_REL = 1e-4


@pytest.fixture(autouse=True)
def _restore_jax_globals():
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jl.set_lora_target(None)
    yield
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])


# ---- the latent upsampler ---------------------------------------------------------------------------

HEADS = {
    "spatial": {},
    "spatiotemporal": {"temporal_upsample": True},
    "temporal": {"spatial_upsample": False, "temporal_upsample": True},
    "rational_0.75": {"rational_resampler": True, "spatial_scale": 0.75},
    "rational_1.5": {"rational_resampler": True, "spatial_scale": 1.5},
    "rational_2": {"rational_resampler": True, "spatial_scale": 2.0},
    "rational_4": {"rational_resampler": True, "spatial_scale": 4.0},
}


@pytest.mark.parametrize("head", list(HEADS))
def test_upsampler_heads_match_jax(head):
    """The tiny upsampler (4 channels, 32 mid: GroupNorm of 32 groups, one
    res block a stage) with each head over a (2, 3, 4, 5, 4) latent, f32:
    the output (its shape too) within ``F32_REL`` of the JAX module's."""
    cfg = dataclasses.replace(tu.LTX2UpsamplerConfig.tiny(), **HEADS[head])
    jcfg = dataclasses.replace(ju.LTX2UpsamplerConfig.tiny(), **HEADS[head])
    x = np.random.default_rng(1).standard_normal((2, 3, 4, 5, 4)).astype(np.float32)
    jmodule = ju.LTX2LatentUpsampler(jcfg)
    variables = numpy_variables(jmodule, jnp.asarray(x), seed=2)
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x)))
    port = bridge(variables, tu.LTX2LatentUpsampler(cfg))
    with torch.no_grad():
        out = port(t(x)).numpy()
    assert out.shape == ref.shape and rel(out, ref) < F32_REL
    expected = {"spatial": (2, 3, 8, 10), "spatiotemporal": (2, 6, 8, 10), "temporal": (2, 5, 4, 5)}
    if head in expected:
        assert out.shape[:4] == expected[head]


def test_upsampler_statistics_and_importer_match_jax(tmp_path):
    """A seeded tiny upsampler file (torch layout) with its config in the
    metadata: the port's tree bitwise the JAX importer's, the imported
    module bitwise its bridged tree; ``upsample_ltx2_video_latents`` under
    per-channel mean / std statistics within ``F32_REL`` of JAX's; a
    rational file (``upsampler.conv``) read alike; a ``dims=2`` file refused
    in both packages."""
    for extra in ({}, {"rational_resampler": True, "spatial_scale": 1.5}):
        cfg = dataclasses.replace(tu.LTX2UpsamplerConfig.tiny(), **extra)
        weights = _seeded(ltx2_upsampler_checkpoint_shapes(cfg), seed=3)
        meta = {"config": json.dumps({"dims": 3, **dataclasses.asdict(cfg)})}
        path = str(tmp_path / f"up_{len(extra)}.safetensors")
        np_save_file(weights, path, metadata=meta)
        jmodule, jvars = ju.load_ltx2_latent_upsampler(path)
        assert jmodule.config == ju.LTX2UpsamplerConfig(**dataclasses.asdict(cfg))
        _assert_trees_bitwise(tu.ltx2_upsampler_params(read_safetensors(path), cfg), jvars)
        port = tu.load_ltx2_latent_upsampler(path)
        assert port.config == cfg
        reference = bridge(jax.tree_util.tree_map(np.asarray, jvars), tu.LTX2LatentUpsampler(cfg))
        for (name, a), b in zip(port.state_dict().items(), reference.state_dict().values()):
            assert torch.equal(a, b), name
        rng = np.random.default_rng(4)
        x = rng.standard_normal((1, 2, 3, 4, 4)).astype(np.float32)
        mean, std = rng.standard_normal(4).astype(np.float32), rng.uniform(0.5, 2.0, 4).astype(np.float32)
        ref = ju.upsample_ltx2_video_latents(jnp.asarray(x), jmodule, jvars, jnp.asarray(mean), jnp.asarray(std))
        with torch.no_grad():
            out = tu.upsample_ltx2_video_latents(t(x), port, t(mean), t(std)).numpy()
        assert rel(out, np.asarray(ref)) < F32_REL
    path = str(tmp_path / "dims2.safetensors")
    np_save_file({"x": np.zeros(1, np.float32)}, path, metadata={"config": json.dumps({"dims": 2})})
    for load in (ju.load_ltx2_latent_upsampler, tu.load_ltx2_latent_upsampler):
        with pytest.raises(NotImplementedError, match="dims=3"):
            load(path)


# ---- the Gemma connectors ---------------------------------------------------------------------------

VALID = np.asarray([8, 3])
# left-padded rows: 8 and 3 valid of 8
CONNECTOR_MASK = (np.arange(8)[None] >= 8 - VALID[:, None]).astype(np.int32)


def test_masked_mean_norm_matches_jax():
    """``per_layer_masked_mean_norm`` over (2, 8, 16, 3) stacked layers with
    8 and 3 valid tokens: within ``F32_REL`` of JAX's, the pads 0."""
    x = np.random.default_rng(5).standard_normal((2, 8, 16, 3)).astype(np.float32)
    ref = np.asarray(jc.per_layer_masked_mean_norm(jnp.asarray(x), jnp.asarray(CONNECTOR_MASK), 8.0))
    out = tc.per_layer_masked_mean_norm(t(x), t(CONNECTOR_MASK), 8.0).numpy()
    assert rel(out, ref) < F32_REL and not out[1, :5].any()


def test_connector_roll_and_registers_match_jax():
    """The tiny 1-D connector (2 heads of 8, 4 registers) on a batch of two
    left-padded rows (8 and 3 valid of 8): each row rolled by its own pad,
    the registers tiled over the tail, f32, within ``F32_REL`` of JAX's; a
    length of 6 (not a multiple of 4) refused in both packages."""
    cfg, jcfg = tc.LTX2ConnectorConfig.tiny(), jc.LTX2ConnectorConfig.tiny()
    x = np.random.default_rng(6).standard_normal((2, 8, cfg.inner_dim)).astype(np.float32)
    jmodule = jc.ConnectorTransformer1d(jcfg, dtype=jnp.float32)
    variables = numpy_variables(jmodule, jnp.asarray(x), jnp.asarray(CONNECTOR_MASK), seed=7)
    ref = np.asarray(jmodule.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x),
                                   jnp.asarray(CONNECTOR_MASK)))
    port = bridge(variables, tc.ConnectorTransformer1d(cfg, torch.float32))
    with torch.no_grad():
        out = port(t(x), t(CONNECTOR_MASK)).numpy()
    assert rel(out, ref) < F32_REL
    with pytest.raises(ValueError, match="register count"):
        jmodule.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x[:, :6]),
                      jnp.asarray(CONNECTOR_MASK[:, :6]))
    with pytest.raises(ValueError, match="register count"), torch.no_grad():
        port(t(x[:, :6]), t(CONNECTOR_MASK[:, :6]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_connectors_and_importer_match_jax(tmp_path, dtype):
    """``LTX2TextConnectors`` (tiny: 16 x 3 stacked features, one layer a
    connector) imported from a seeded file in both packages (trees bitwise)
    on the two left-padded rows: video and audio features within
    ``F32_REL`` of JAX's in f32, ``BF16_REL`` in bf16."""
    cfg, jcfg = tc.LTX2ConnectorConfig.tiny(), jc.LTX2ConnectorConfig.tiny()
    path = str(tmp_path / "connectors.safetensors")
    np_save_file(_seeded(ltx2_connector_checkpoint_shapes(cfg), seed=8), path)
    jvars = jc.load_ltx2_connectors(jcfg, path)
    _assert_trees_bitwise(tc.ltx2_connector_params(read_safetensors(path), cfg), jvars)
    port = tc.load_ltx2_connectors(cfg, path, dtype=getattr(torch, dtype))
    x = np.random.default_rng(9).standard_normal((2, 8, 48)).astype(np.float32)
    jmodule = jc.LTX2TextConnectors(jcfg, dtype=getattr(jnp, dtype))
    ref = jmodule.apply(jax.tree_util.tree_map(jnp.asarray, jvars), jnp.asarray(x), jnp.asarray(CONNECTOR_MASK))
    with torch.no_grad():
        out = port(t(x), t(CONNECTOR_MASK))
    for ours, theirs in zip(out, ref):
        assert rel(ours.float().numpy(), np.asarray(theirs.astype(jnp.float32))) < \
            (F32_REL if dtype == "float32" else BF16_REL)


# ---- the resize copies ------------------------------------------------------------------------------


@pytest.mark.parametrize("method,shape_in,shape_out", [
    ("linear", (2, 8, 12), (2, 4, 6)), ("linear", (2, 7, 9), (2, 4, 6)), ("linear", (2, 3, 4), (2, 4, 6)),
    ("nearest", (2, 5, 7, 11), (2, 3, 4, 6)), ("nearest", (2, 2, 2, 3), (2, 3, 4, 6))])
def test_resize_matches_jax_image_resize(method, shape_in, shape_out):
    """``resize_linear`` (antialiased when shrinking) within 2^-22 of
    ``jax.image.resize(..., "linear")`` at shrinking (2x and 7 / 4, 9 / 6)
    and growing ratios; ``resize_nearest`` equal to the ``"nearest"`` one."""
    x = np.random.default_rng(10).uniform(size=shape_in).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), shape_out, method))
    out = (resize_linear if method == "linear" else resize_nearest)(t(x), shape_out).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    assert np.abs(out - ref).max() <= (2.0 ** -22 if method == "linear" else 0.0)


# ---- the spatial-upscale render -------------------------------------------------------------------------


def _render_values(**extra):
    return {"model_family": "ltxvideo2", "model_type": "full", "model_arch_preset": "tiny",
            "mixed_precision": "fp32", "validation_prompt": "a clip of waves", "validation_num_inference_steps": 2,
            "validation_resolution": 32, "validation_num_video_frames": 9, "validation_seed": 7,
            "ltx2_validation_pipeline_mode": "spatial-upscale", **extra}


def test_spatial_upscale_render_matches_jax(monkeypatch, tmp_path):
    """The two-stage render of the tiny preset through each package's
    ``Validation`` (no CFG): the same DiT weights, the same upsampler (the
    JAX tiny preset's, bridged), the same noise for both stages: stage 1 on
    the half-resolution latents (3 x 4 x 4), the x2 upsampler, stage 2
    re-noised at 0.909375 over the 3-sigma ladder; the final latents within
    ``RENDER_REL`` of JAX's.  The trained-stage mode renders single in both
    packages; a run of the port's ``run_validations`` writes the mp4 of the
    decoded clip; the upsampler is refused without a file outside the tiny
    preset; the staged modes of other families are still refused."""
    from simpletuner_tpu_torch.models.sdxl import SDXL
    from simpletuner_tpu_torch.models.video_vae import VideoAutoencoderKL
    from simpletuner_tpu_torch.models.layers import init_parameters

    values = _render_values()
    jmodel, model = JaxLTXVideo2(JaxTrainingConfig(values)), LTXVideo2(config_namespace(values))
    rng = np.random.default_rng(11)
    states = rng.standard_normal((1, 6, 20)).astype(np.float32)
    for m in (jmodel, model):
        m.attach_text_encoders([_Encoder(states, np.ones((1, 6), np.int32))])
    params = _jax_params(jmodel, 12)
    module = bridge({"params": params}, model.create_module())
    jup, jup_vars = jmodel.latent_upsampler()
    model._latent_upsampler = bridge(jax.tree_util.tree_map(np.asarray, jup_vars),
                                     tu.LTX2LatentUpsampler(dataclasses.replace(tu.LTX2UpsamplerConfig.tiny(),
                                                                                in_channels=8)))
    validation = Validation(model, config_namespace(values), device="cpu")
    validation.precompute_embeds()
    full = validation._latent_shape(1)
    stage1 = full[:2] + (full[2] // 2, full[3] // 2) + full[4:]
    out = validation._render(module, validation._embeds[0], 0)
    generator = noise_generator(7, 0)
    noises = {stage1: torch.randn(stage1, generator=generator).numpy(),
              full: torch.randn(full, generator=generator).numpy()}
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noises[tuple(shape)]))
    jvalidation = JaxValidation(jmodel, JaxTrainingConfig(values))
    jvalidation.precompute_embeds()
    ref = np.asarray(jvalidation._render(jax.tree_util.tree_map(jnp.asarray, {"params": params}),
                                         jvalidation._embeds[0], 0))
    assert out.shape == ref.shape == full[1:] and np.isfinite(out).all() and rel(out, ref) < RENDER_REL

    single = dict(values, ltx2_validation_pipeline_mode="trained-stage")
    jsingle, tsingle = JaxLTXVideo2(JaxTrainingConfig(single)), LTXVideo2(config_namespace(single))
    assert not jsingle.supports_multistage_validation() and not tsingle.supports_multistage_validation()
    with pytest.raises(ValueError, match="trained-stage or spatial-upscale"):
        LTXVideo2(config_namespace(dict(values, ltx2_validation_pipeline_mode="full"))).supports_multistage_validation()
    with pytest.raises(ValueError, match="local safetensors"):
        LTXVideo2(config_namespace(dict(values, model_arch_preset=None))).latent_upsampler()

    with torch.device("cpu"):
        vae = init_parameters(VideoAutoencoderKL(model.video_vae_config(), torch.float32),
                              torch.Generator().manual_seed(0))
    validation.decode_fn, validation.output_dir = vae.decode, str(tmp_path)
    (path,) = validation.run_validations(module, 2, force=True)
    assert path.endswith("step_2_0.mp4")
    from test_torch_wan import _read_mp4

    assert _read_mp4(path).shape == (9, 32, 32, 3)

    staged = SDXL(config_namespace({"model_family": "sdxl", "model_arch_preset": "tiny", "validation_prompt": "a",
                                    "sdxl_validation_pipeline_mode": "full-pipeline"}))
    with pytest.raises(NotImplementedError, match="item 4d"):
        Validation(staged, staged.config, device="cpu")
