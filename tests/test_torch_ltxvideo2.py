"""The torch port's LTX-2 DiT and family against the JAX package, on the CPU.

The presets (the published 18.88B against the JAX ``eval_shape``); the RoPE
coordinates (the causal first-frame shift, the audio timestamps) and tables
bitwise, with the pad branch of a width that is not a multiple of 2 ndims,
and the interleaved rotation; one dual-modal block and the whole DiT in f32
and bf16 (both outputs: video and audio) with and without the caption mask,
scalar and tokenwise timesteps, gated attention, and IC-LoRA reference
tokens at ``ref_strength`` with the coordinates re-scaled at spatial and
temporal scale 2; the LoRA gradients against ``jax.grad`` (remat too); the
all-masked caption in both packages side by side; the family contract
(``get_model_inputs`` with IC-LoRA and its scale inference and refusals, the
prediction, ``encode_text``'s tile / truncate shim, the collate, the render
conditioning); every intrinsic conditioning spec through ``prepare_batch``
with its ``loss_mask`` and refusals; the joint audiovisual loss and 3 AdamW
steps through ``build_train_step`` on a batch with audio latents; the import
of the JAX exporter's file bitwise, the key map and an adapter file.  Each
JAX reference of the DiT is computed once (the ``jax_dit`` fixture).
``Trainer.run()`` is in test_torch_ltxvideo2_trainer.py, the upsampler, the
connectors and the spatial-upscale render in test_torch_ltx2_modules.py.
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
from simpletuner_tpu.models.ltxvideo2 import transformer as jt
from simpletuner_tpu.models.ltxvideo2.model import LTXVideo2 as JaxLTXVideo2
from simpletuner_tpu.models.weight_export import export_ltx2_to_diffusers
from simpletuner_tpu.models.weight_import import load_ltx2_params as jax_load_params
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS
from simpletuner_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from simpletuner_tpu.training.train_state import build_train_step as jax_build_train_step
from simpletuner_tpu.training.train_state import create_train_state as jax_create_train_state

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import ltx2_checkpoint_shapes
from simpletuner_tpu_torch.models.ltxvideo2 import LTX2Config, LTX2Transformer, LTXVideo2
from simpletuner_tpu_torch.models.ltxvideo2 import transformer as tt
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.video_vae import VideoVAEConfig
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params, lora_to_flax
from simpletuner_tpu_torch.models.weight_import import load_ltx2_params, load_transformer_params
from simpletuner_tpu_torch.ops import dot_product_attention, key_mask_segments
from simpletuner_tpu_torch.training.lora import _key_map_for, ltx2_key_map
from simpletuner_tpu_torch.training.optimizers import get_optimizer
from simpletuner_tpu_torch.training.train_state import build_train_step, create_train_state

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# f32 LoRA gradients (test_torch_sdxl.py: f32 gradients through a deep net
# are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
# bf16 on both sides: each rounds its own intermediates (the port also keeps
# the attention's output in bf16 for the kernels)
BF16_REL = 2e-2
# torch's and XLA's f32 rotation of the same f32 inputs: a few ulps of the input's scale
ROPE_ATOL = 2.0 ** -21
# the JAX softmax over logits shifted by -10000 against the unshifted one:
# f32 holds the shifted logits to 2^-10
SHIFTED_REL = 1e-3
GRID = (2, 4, 6)  # latent frames, height, width: 48 video tokens
AUDIO = 5
TEXT = 7
# a right-padded (5 of 7 valid) and a left-padded (5 of 7) caption
MASK = np.asarray([[1, 1, 1, 1, 1, 0, 0], [0, 0, 1, 1, 1, 1, 1]], np.int32)


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
    return {"model_family": "ltxvideo2", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxLTXVideo2(JaxTrainingConfig(values)), LTXVideo2(config_namespace(values))


def _gated(jax_side=False):
    base = jt.LTX2Config.tiny() if jax_side else LTX2Config.tiny()
    return dataclasses.replace(base, gated_attn=True, audio_gated_attn=True)


def _inputs(variant, seed=0):
    """The DiT's array inputs for a variant: 2 samples of ``GRID`` video
    tokens, ``AUDIO`` audio tokens, ``TEXT`` caption tokens; tokenwise (B,
    Sv) sigmas or per-sample ones; ``MASK``; IC-LoRA reference tokens of a 1
    x 2 x 3 grid (half the target's height and width) at strengths 0.3 and 1."""
    rng = np.random.default_rng(seed)
    cfg = LTX2Config.tiny()
    seq = math.prod(GRID)
    inputs = {"video_tokens": rng.standard_normal((2, seq, cfg.in_channels)).astype(np.float32),
              "audio_tokens": rng.standard_normal((2, AUDIO, cfg.audio_in_channels)).astype(np.float32),
              "text_embeds": rng.standard_normal((2, TEXT, cfg.caption_channels)).astype(np.float32)}
    parts = variant.split("_")
    if "tokenwise" in parts:
        inputs["timesteps"] = rng.uniform(0.05, 0.95, (2, seq)).astype(np.float32)
        inputs["audio_timesteps"] = rng.uniform(0.05, 0.95, (2,)).astype(np.float32)
    else:
        inputs["timesteps"] = np.asarray([0.13, 0.91], np.float32)
    if "masked" in parts:
        inputs["text_mask"] = MASK
    if "ref" in parts:
        inputs["ref_tokens"] = rng.standard_normal((2, 6, cfg.in_channels)).astype(np.float32)
        inputs["ref_strength"] = np.broadcast_to(np.asarray([[0.3], [1.0]], np.float32), (2, 6)).copy()
    return inputs


def _static(variant):
    kw = {"num_frames": GRID[0], "height": GRID[1], "width": GRID[2]}
    if "ref" in variant.split("_"):
        kw.update(ref_shape=(1, 2, 3), ref_spatial_scale=2, ref_temporal_scale=2)
    return kw


def _jax_module(variant, dtype=jnp.float32, remat=False):
    config = _gated(True) if "gated" in variant.split("_") else jt.LTX2Config.tiny()
    return jt.LTX2Transformer(config=config, dtype=dtype, lora_rank=4, remat=remat)


def _port_module(variant, dtype=torch.float32, remat=False):
    return LTX2Transformer(_gated() if "gated" in variant.split("_") else LTX2Config.tiny(), dtype=dtype, lora_rank=4,
                           remat=remat)


@pytest.fixture(scope="module")
def jax_dit():
    """The JAX DiT (f32, rank-4 adapters): its video and audio outputs and
    the LoRA gradients of a seeded projection of both, once per variant."""
    cache = {}

    def reference(variant):
        if variant not in cache:
            inputs, kw = _inputs(variant, seed=4), _static(variant)
            jmodule = _jax_module(variant)
            jargs = {k: jnp.asarray(v) for k, v in inputs.items()}
            variables = numpy_variables(jmodule, **jargs, **kw, seed=5)
            rng = np.random.default_rng(6)
            w_video = rng.standard_normal((2, math.prod(GRID), 8)).astype(np.float32)
            w_audio = rng.standard_normal((2, AUDIO, 6)).astype(np.float32)
            params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

            def jax_loss(lora):
                video, audio = jmodule.apply({"params": params, "lora": lora}, **jargs, **kw)
                return jnp.sum(video * w_video) + jnp.sum(audio * w_audio), (video, audio)

            (_, (video, audio)), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
                jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
            cache[variant] = (inputs, variables, (w_video, w_audio), (np.asarray(video), np.asarray(audio)),
                              _flat(grads))
        return cache[variant]

    return reference


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---- presets, coordinates and tables ---------------------------------------------------------------


def test_presets_and_contract_match_jax():
    """The presets (tiny and published: 48 blocks of 386,074,624
    parameters, 344,592,640 outside them, 18.88B in the checkpoint layout;
    the JAX ``eval_shape`` at 2 blocks giving the layout's count), the
    family's constants, its Gemma spec at 256 tokens, example batch, video
    VAE at 128 channels (the tiny VAE at 8); ``ltxvideo2`` in ``PORTED``
    (and its ``ltx2`` alias); the refusals of the checkpoint-faithful video
    VAE and of the intermediates tap by name."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "MODALITY", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR",
                 "HUGGINGFACE_PATHS", "DEFAULT_LORA_TARGET", "LATENT_CHANNEL_COUNT", "LTX2_STAGE2_SIGMAS"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    for ours, theirs in ((LTX2Config.tiny(), jt.LTX2Config.tiny()), (LTX2Config(), jt.LTX2Config())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    shapes = ltx2_checkpoint_shapes(LTX2Config())
    per_block = sum(math.prod(s) for k, s in shapes.items() if k.startswith("transformer_blocks.0."))
    outside = sum(math.prod(s) for k, s in shapes.items() if not k.startswith("transformer_blocks."))
    assert (per_block, outside) == (386_074_624, 344_592_640)
    assert sum(math.prod(s) for s in shapes.values()) == 48 * per_block + outside == 18_876_174_592
    two = dataclasses.replace(jt.LTX2Config(), num_layers=2)
    example = {"video_tokens": jnp.zeros((1, 2, 128)), "audio_tokens": jnp.zeros((1, 1, 128)),
               "text_embeds": jnp.zeros((1, 2, 3840)), "timesteps": jnp.zeros((1,))}
    tree = jax.eval_shape(lambda: jt.LTX2Transformer(config=two).init(
        jax.random.PRNGKey(0), **example, num_frames=1, height=1, width=2))
    assert sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree)) == \
        sum(math.prod(s) for s in ltx2_checkpoint_shapes(dataclasses.replace(LTX2Config(), num_layers=2)).values())
    assert "ltxvideo2" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), LTXVideo2)
    assert isinstance(get_model_family(config_namespace(_tiny_values(model_family="ltx2"))), LTXVideo2)
    with pytest.raises(ValueError, match="flow-matching"):
        LTXVideo2(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2).items()}
    for values in (_tiny_values(), {**_tiny_values(), "model_arch_preset": None}):
        ours, theirs = LTXVideo2(config_namespace(values)), JaxLTXVideo2(JaxTrainingConfig(values))
        assert dataclasses.asdict(ours.video_vae_config()) == dataclasses.asdict(theirs.video_vae_config())
    assert model.video_vae_config() == dataclasses.replace(VideoVAEConfig.tiny(), latent_channels=8)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        model.load_video_vae("vae.safetensors")
    with pytest.raises(NotImplementedError, match="item 4h"):
        model.model_predict_with_intermediates(None, {})


@pytest.mark.parametrize("case", ["video", "video_fps24", "audio", "pad", "ref_scaled"])
def test_coordinates_and_rope_tables_match_jax_bitwise(case):
    """The coordinates (a 4 x 3 x 5 grid with the causal first-frame shift,
    at 25 and 24 fps; 9 audio frames) and their f32 tables bitwise the JAX
    functions' at the published widths (4096 over 3 axes: 682 frequencies
    and a 4-channel pad; 2048 over 1) and at 32 over 3 axes (the 2-channel
    pad); the IC-LoRA reference coordinates of a 2 x 3 x 5 grid at spatial
    and temporal scale 2 (as the transformer builds them) bitwise JAX's
    inline ones."""
    cfg, jcfg = LTX2Config(), jt.LTX2Config()
    vmax = (cfg.pos_embed_max_pos, cfg.base_height, cfg.base_width)
    if case.startswith("video") or case == "pad":
        fps = 24.0 if case == "video_fps24" else 25.0
        coords, jcoords = tt.ltx2_video_coords(cfg, 4, 3, 5, fps), jt.ltx2_video_coords(jcfg, 4, 3, 5, fps)
        assert np.array_equal(coords, jcoords) and coords[0, 0] == (0 + 1) / 2 / fps  # the first frame's shift
        dim = 32 if case == "pad" else 4096
        assert dim % 6 == {32: 2, 4096: 4}[dim]
        cos, sin = tt.ltx2_rope_tables(coords, vmax, dim, cfg.rope_theta)
        jcos, jsin = jt.ltx2_rope_tables(jcoords, vmax, dim, jcfg.rope_theta)
    elif case == "audio":
        coords, jcoords = tt.ltx2_audio_coords(cfg, 9), jt.ltx2_audio_coords(jcfg, 9)
        assert np.array_equal(coords, jcoords) and coords.shape == (9, 1)
        cos, sin = tt.ltx2_rope_tables(coords, (20,), 2048, cfg.rope_theta)
        jcos, jsin = jt.ltx2_rope_tables(jcoords, (20,), 2048, jcfg.rope_theta)
    else:
        module = LTX2Transformer(dataclasses.replace(LTX2Config.tiny(), num_layers=0), dtype=torch.float32)
        (cos, sin), _, (ca_cos, ca_sin), _ = module.rope((4, 3, 5), 9, 25.0, ((2, 3, 5), 2, 2), torch.device("cpu"))
        r = jt.ltx2_video_coords(jt.LTX2Config.tiny(), 2, 3, 5)
        first_end = max(1 * 8 + 1 - 8, 0.0) / 25.0
        r[:, 0] = np.clip(r[:, 0] - first_end, 0.0, None)
        r[:, 1] *= 2
        r[:, 2] *= 2
        jcoords = np.concatenate([r, jt.ltx2_video_coords(jt.LTX2Config.tiny(), 4, 3, 5)], axis=0)
        jcos, jsin = jt.ltx2_rope_tables(jcoords, vmax, 32, 10000.0)
        jca = jt.ltx2_rope_tables(jcoords[:, :1], (20,), 16, 10000.0)
        assert np.array_equal(ca_cos.numpy(), np.asarray(jca[0])) and np.array_equal(ca_sin.numpy(), np.asarray(jca[1]))
        cos, sin = cos.numpy(), sin.numpy()
    assert cos.dtype == np.float32 and np.array_equal(cos, np.asarray(jcos)) and np.array_equal(sin, np.asarray(jsin))
    x = np.random.default_rng(1).standard_normal((2,) + cos.shape).astype(np.float32)
    ours = tt.apply_interleaved_rope(t(x), (t(cos), t(sin))).numpy()
    ref = np.asarray(jt.apply_interleaved_rope(jnp.asarray(x), (jnp.asarray(jcos), jnp.asarray(jsin))))
    assert np.abs(ours - ref).max() <= ROPE_ATOL * np.abs(x).max() * 2


# ---- the block and the DiT --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,masked", [("float32", True), ("float32", False), ("bfloat16", True)])
def test_block_matches_jax(dtype, masked):
    """One dual-modal block (gated attention, tokenwise video modulation,
    per-sample audio and cross-modal modulation, the four rope tables, the
    caption mask as key ids against the JAX -10000 bias or none): video and
    audio within ``F32_REL`` of the JAX block in f32, ``BF16_REL`` in bf16."""
    cfg, jcfg = _gated(), _gated(True)
    dim, a_dim, seq = cfg.inner_dim, cfg.audio_inner_dim, math.prod(GRID)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(2)
    video = rng.standard_normal((2, seq, dim)).astype(np.float32)
    audio = rng.standard_normal((2, AUDIO, a_dim)).astype(np.float32)
    text_v = rng.standard_normal((2, TEXT, dim)).astype(np.float32)
    text_a = rng.standard_normal((2, TEXT, a_dim)).astype(np.float32)
    tembs = [0.3 * rng.standard_normal(shape).astype(np.float32) for shape in (
        (2, seq, 6 * dim), (2, 1, 6 * a_dim), (2, 1, 4 * dim), (2, 1, 4 * a_dim), (2, 1, dim), (2, 1, a_dim))]
    module = LTX2Transformer(cfg, dtype=torch.float32)
    ropes = module.rope(GRID, AUDIO, 25.0, None, torch.device("cpu"))
    bias = ((1.0 - MASK.astype(np.float32)) * -10000.0)[:, None, None, :] if masked else None
    jblock = jt.LTX2Block(jcfg, dtype=jdtype, lora_rank=4)
    cast = lambda x: jnp.asarray(x).astype(jdtype)  # noqa: E731
    args = (cast(video), cast(audio), cast(text_v), cast(text_a), *map(jnp.asarray, tembs),
            *[(jnp.asarray(c.numpy()), jnp.asarray(s.numpy())) for c, s in ropes],
            None if bias is None else jnp.asarray(bias), None if bias is None else jnp.asarray(bias))
    variables = numpy_variables(jblock, *args, seed=3)
    ref = jax.jit(jblock.apply)(jax.tree_util.tree_map(jnp.asarray, variables), *args)
    port = bridge(variables, tt.LTX2Block(cfg, tdtype, lora_rank=4))
    key_ids = key_mask_segments(t(MASK)) if masked else None
    ids = (torch.ones((2, seq), dtype=torch.int32), torch.ones((2, AUDIO), dtype=torch.int32)) if masked else \
        (None, None)
    with torch.no_grad():
        out = port(t(video).to(tdtype), t(audio).to(tdtype), t(text_v).to(tdtype), t(text_a).to(tdtype),
                   *map(t, tembs), *ropes, *ids, key_ids)
    tol = F32_REL if dtype == "float32" else BF16_REL
    for ours, theirs in zip(out, ref):
        assert rel(ours.float().numpy(), np.asarray(theirs.astype(jnp.float32))) < tol


VARIANTS = ["unmasked", "masked_tokenwise", "gated_masked", "ref_tokenwise"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_transformer_forward_and_lora_grads_match_jax(jax_dit, variant):
    """The DiT (f32, rank-4 adapters) per variant: unmasked with
    per-sample sigmas; the caption mask with tokenwise sigmas (the audio
    stream's own); gated attention with the mask; IC-LoRA reference tokens
    (dropped from the output) at strengths 0.3 / 1 with the coordinates at
    spatial and temporal scale 2, tokenwise:
    video and audio within ``F32_REL`` of the JAX module's, the LoRA
    gradients of a seeded projection of both against ``jax.grad`` within
    ``GRAD_REL``, per adapter."""
    inputs, variables, (w_video, w_audio), (video_ref, audio_ref), flat = jax_dit(variant)
    port = bridge(variables, _port_module(variant))
    adapters = tl.freeze_base(port)
    video, audio = port(**{k: t(v) for k, v in inputs.items()}, **_static(variant))
    assert tuple(video.shape) == video_ref.shape and tuple(audio.shape) == audio_ref.shape
    assert rel(video.detach().numpy(), video_ref) < F32_REL and rel(audio.detach().numpy(), audio_ref) < F32_REL
    ((video * t(w_video)).sum() + (audio * t(w_audio)).sum()).backward()
    assert sorted(flat) == sorted(adapters) and "block_1/audio_to_video_attn/to_q/lora_A" in flat
    assert not any(name.startswith(("time_embed", "av_ca")) or "gate_logits" in name for name in flat)
    for path, param in adapters.items():
        assert rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_transformer_remat_matches_jax(jax_dit):
    """Under remat (every block checkpointed) the output and the LoRA
    gradients of the ``masked_tokenwise`` variant against the JAX module
    (without remat: the same function) within ``F32_REL`` / ``GRAD_REL``."""
    inputs, variables, (w_video, w_audio), (video_ref, _), flat = jax_dit("masked_tokenwise")
    port = bridge(variables, _port_module("masked_tokenwise", remat=True))
    adapters = tl.freeze_base(port)
    video, audio = port(**{k: t(v) for k, v in inputs.items()}, **_static("masked_tokenwise"))
    assert rel(video.detach().numpy(), video_ref) < F32_REL
    ((video * t(w_video)).sum() + (audio * t(w_audio)).sum()).backward()
    for path, param in adapters.items():
        assert rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


@pytest.mark.parametrize("variant", ["gated_masked", "ref_tokenwise"])
def test_transformer_bf16_matches_jax(variant):
    """The DiT in bf16 (f32 adapters, norms and tables) against the JAX
    module in bf16: video and audio within ``BF16_REL``."""
    inputs, kw = _inputs(variant, seed=7), _static(variant)
    jmodule = _jax_module(variant, dtype=jnp.bfloat16)
    jargs = {k: jnp.asarray(v) for k, v in inputs.items()}
    variables = numpy_variables(jmodule, **jargs, **kw, seed=8)
    ref = jax.jit(lambda v: jmodule.apply(v, **jargs, **kw))(jax.tree_util.tree_map(jnp.asarray, variables))
    port = bridge(variables, _port_module(variant, dtype=torch.bfloat16))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}, **kw)
    for ours, theirs in zip(out, ref):
        assert ours.dtype == torch.float32 and rel(ours.numpy(), np.asarray(theirs)) < BF16_REL


def test_all_masked_caption_jax_and_port_side_by_side():
    """JAX behaviour the port does not share (ROADMAP): on a caption with
    no valid token the JAX -10000 bias shifts every logit alike, so its
    prompt attention is the unmasked one (within ``SHIFTED_REL``), while the
    kernels' key ids give 0.  Shown at the op (head dim 128) and through the
    DiT: sample 0 all-masked, sample 1 with valid keys; the port's sample 1
    within ``F32_REL`` of JAX, its sample 0 apart from JAX's (and from its
    own unmasked output), JAX's sample 0 its unmasked output."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 9, 2, 128)).astype(np.float32)
    k, v = (rng.standard_normal((2, TEXT, 2, 128)).astype(np.float32) for _ in range(2))
    empty = np.asarray([[0] * TEXT, MASK[1]], np.int32)
    logits = jnp.einsum("bshd,bthd->bhst", q, k) / math.sqrt(128)
    dense = np.asarray(jnp.einsum("bhst,bthd->bshd", jax.nn.softmax(
        logits + ((1.0 - jnp.asarray(empty, jnp.float32)) * -10000.0)[:, None, None, :], -1), v))
    out = dot_product_attention(t(q), t(k), t(v), q_segment_ids=torch.ones((2, 9), dtype=torch.int32),
                                kv_segment_ids=key_mask_segments(t(empty))).numpy()
    unmasked = dot_product_attention(t(q), t(k), t(v)).numpy()
    assert not out[0].any() and rel(dense[0], unmasked[0]) < SHIFTED_REL and rel(out[1], dense[1]) < F32_REL

    inputs, kw = _inputs("masked", seed=9), _static("masked")
    jmodule = _jax_module("masked")
    variables = numpy_variables(jmodule, **{k: jnp.asarray(v) for k, v in inputs.items()}, **kw, seed=10)
    port = bridge(variables, _port_module("masked"))
    results = {}
    apply = jax.jit(lambda v, a: jmodule.apply(v, **a, **kw))
    for name, mask in (("empty", empty), ("none", None)):
        args = {**inputs, "text_mask": mask} if mask is not None else {k: v for k, v in inputs.items()
                                                                        if k != "text_mask"}
        jout = apply(jax.tree_util.tree_map(jnp.asarray, variables), {k: jnp.asarray(v) for k, v in args.items()})
        with torch.no_grad():
            tout = port(**{k: t(v) for k, v in args.items()}, **kw)
        results[name] = (np.asarray(jout[0]), tout[0].numpy())
    (jax_empty, port_empty), (jax_none, port_none) = results["empty"], results["none"]
    assert rel(jax_empty[0], jax_none[0]) < SHIFTED_REL
    assert rel(port_empty[1], jax_empty[1]) < F32_REL
    assert rel(port_empty[0], jax_empty[0]) > 1e-2 and rel(port_empty[0], port_none[0]) > 1e-2


# ---- the family -------------------------------------------------------------------------------------


class _Encoder:
    def __init__(self, states, mask):
        self.states, self.mask = states, mask

    def encode(self, prompts):
        n = len(prompts)
        return {"last_hidden_state": self.states[:n], "attention_mask": self.mask[:n]}


def _prepared(seed=0, **extra):
    rng = np.random.default_rng(seed)
    prepared = {"noisy_latents": rng.standard_normal((2,) + GRID + (8,)).astype(np.float32),
                "timesteps": np.asarray([0.13, 0.91], np.float32),
                "text_embeds": rng.standard_normal((2, TEXT, 20)).astype(np.float32)}
    prepared.update(extra)
    return prepared


def _model_inputs_equal(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        a, b = ours[key], theirs[key]
        if isinstance(b, (int, tuple)):
            assert a == b, key
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)


def test_family_inputs_prediction_and_text_match_jax(jax_dit):
    """``get_model_inputs`` equal to the JAX family's: plain; with tokenwise
    ``token_timesteps`` (the audio keeping the scalar sigma) and the caption
    mask; with a 5-D ``control_latents`` at half the target's height and
    width (the spatial scale 2 inferred), with the scale set (3) and at the
    same grid (1), each with ``conditioning_strength``; the refusals (channels,
    a grid that does not divide, a non-uniform scale) in both packages.
    ``model_predict`` within ``F32_REL`` of the JAX DiT; ``encode_text``'s
    tile (a 6-wide state to 20) and truncate (a 32-wide one) shim, the
    collate (``text_embeds`` alone) and ``inference_conditioning`` with an
    installed reference, equal to the JAX family's."""
    rng = np.random.default_rng(3)
    tok = rng.uniform(0.05, 0.95, (2, math.prod(GRID))).astype(np.float32)
    control = rng.standard_normal((2, 1, 2, 3, 8)).astype(np.float32)
    cases = [({}, {}), ({"token_timesteps": tok, "text_attention_mask": MASK}, {}),
             ({"control_latents": control, "conditioning_strength": np.asarray([0.4, 1.0], np.float32)}, {}),
             ({"control_latents": control}, {"ltx2_reference_spatial_scale_factor": 3}),
             ({"control_latents": rng.standard_normal((2, 2) + GRID[1:] + (8,)).astype(np.float32)}, {})]
    for extra, config in cases:
        jmodel, model = _pair(_tiny_values(**config))
        prepared = _prepared(**extra)
        _model_inputs_equal(model.get_model_inputs({k: t(v) for k, v in prepared.items()}),
                            jmodel.get_model_inputs({k: jnp.asarray(v) for k, v in prepared.items()}))
    for control, match in ((np.zeros((2, 1, 2, 3, 4), np.float32), "match target latent channels"),
                           (np.zeros((2, 1, 3, 4, 8), np.float32), "evenly divide"),
                           (np.zeros((2, 1, 2, 6, 8), np.float32), "uniform")):
        jmodel, model = _pair(_tiny_values())
        for m, conv in ((jmodel, jnp.asarray), (model, t)):
            with pytest.raises(ValueError, match=match):
                m.get_model_inputs({k: conv(v) for k, v in _prepared(control_latents=control).items()})

    inputs, variables, _, (video_ref, _), _ = jax_dit("unmasked")
    jmodel, model = _pair(_tiny_values())
    module = bridge(variables, model.create_module())
    prepared = {"noisy_latents": inputs["video_tokens"].reshape((2,) + GRID + (8,)),
                "audio_noisy_latents": inputs["audio_tokens"], "timesteps": inputs["timesteps"],
                "text_embeds": inputs["text_embeds"]}
    with torch.no_grad():
        out = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
    assert out.shape == (2,) + GRID + (8,) and rel(out.reshape(video_ref.shape), video_ref) < F32_REL

    for width in (6, 32):
        states = rng.standard_normal((2, 5, width)).astype(np.float32)
        mask = (np.arange(5)[None] < np.asarray([5, 2])[:, None]).astype(np.int32)
        jmodel, model = _pair(_tiny_values())
        for m in (jmodel, model):
            m.attach_text_encoders([_Encoder(states, mask)])
        mine, theirs = model.encode_text(["a", "b"]), jmodel.encode_text(["a", "b"])
        for a, b in zip(mine, theirs):
            assert sorted(a) == sorted(b) == ["attention_mask", "text_embeds"] and a["text_embeds"].shape == (5, 20)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
        collated, jcollated = model.collate_text_embeds(mine), jmodel.collate_text_embeds(theirs)
        assert sorted(collated) == sorted(jcollated) == ["text_embeds"]
        np.testing.assert_array_equal(collated["text_embeds"], jcollated["text_embeds"])
    reference = rng.standard_normal((1, 1, 3, 4, 8)).astype(np.float32)
    for m in (jmodel, model):
        m.set_validation_video_conditioning(reference, 0.75)
    batch = {"text_embeds": rng.standard_normal((1, TEXT, 20)).astype(np.float32),
             "audio_latents": np.zeros((1, 3, 6), np.float32)}
    cond = model.inference_conditioning({k: t(v) for k, v in batch.items()})
    jcond = jmodel.inference_conditioning({k: jnp.asarray(v) for k, v in batch.items()})
    assert sorted(cond) == sorted(jcond) == ["audio_latents", "conditioning_strength", "control_latents",
                                             "text_embeds"]
    for key in cond:
        np.testing.assert_array_equal(cond[key].numpy(), np.asarray(jcond[key]), err_msg=key)


# ---- intrinsic conditioning ---------------------------------------------------------------------------

LATENT = (2, 3, 4, 6, 8)  # B, F, H, W, C


def _mask_batch(kind, rng):
    if kind == "mask3_shrink":
        return {"loss_mask": (rng.uniform(size=(2, 8, 12)) > 0.5).astype(np.float32)}
    if kind == "mask3_grow":
        return {"conditioning_pixel_values": rng.uniform(-1.0, 1.0, (2, 3, 4)).astype(np.float32)}
    if kind == "mask2_shared":
        return {"conditioning_pixel_values": (rng.uniform(size=(7, 9)) > 0.4).astype(np.float32)}
    if kind == "mask4_shrink":
        return {"loss_mask": (rng.uniform(size=(2, 5, 7, 11)) > 0.5).astype(np.float32)}
    if kind == "mask4_grow":
        return {"loss_mask": (rng.uniform(size=(2, 2, 2, 3)) > 0.5).astype(np.float32)}
    return {}


SPECS = {
    "first_frame": ({"ltx2_first_frame_conditioning_probability": 1.0}, None),
    "prefix": ({"ltx2_prefix_conditioning_probability": 1.0, "ltx2_prefix_conditioning_frames": 2}, None),
    "suffix": ({"ltx2_intrinsic_conditioning": '[{"type": "suffix", "temporal_boundary": 2}]'}, None),
    "spatial_crop": ({"ltx2_intrinsic_conditioning": {"type": "spatial_crop", "spatial_region": [1, 2, 3, 9]}},
                     "loss3"),
    "mask3_shrink": ({"ltx2_mask_conditioning_probability": 1.0}, "mask3_shrink"),
    "mask3_grow": ({"ltx2_intrinsic_conditioning": [{"type": "mask", "probability": 1.0}]}, "mask3_grow"),
    "mask2_shared": ({"ltx2_mask_conditioning_probability": 1.0}, "mask2_shared"),
    "mask4_shrink": ({"ltx2_mask_conditioning_probability": 1.0}, "mask4_shrink"),
    "mask4_grow": ({"ltx2_intrinsic_conditioning": '[{"type": "mask"}]'}, "mask4_grow"),
    "two_specs": ({"ltx2_first_frame_conditioning_probability": 1.0,
                   "ltx2_intrinsic_conditioning": {"type": "spatial_crop", "region": [0, 0, 2, 3]}}, None),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_intrinsic_conditioning_matches_jax(name):
    """Each intrinsic spec (the first frame; a 2-frame prefix and suffix; a
    spatial crop over a 3-D (B, H', W') loss mask shrunk to the latent grid;
    a mask spec over 3-D masks shrinking 8 x 12 -> 4 x 6 (antialiased) and
    growing 3 x 4 -> 4 x 6 from [-1, 1] pixel values, a shared 2-D one, 4-D
    masks shrinking 5 x 7 x 11 and growing 2 x 2 x 3 (nearest); two specs
    together) at probability 1 through ``prepare_batch`` with the same noise
    and sigmas: the conditioned noisy latents, ``token_timesteps`` and the
    ``loss_mask`` it leaves equal to the JAX family's (the resize weights
    within f32 rounding: 1e-6), and the masked loss within ``F32_REL``."""
    config, extra = SPECS[name]
    jmodel, model = _pair(_tiny_values(**config))
    rng = np.random.default_rng(11)
    batch = {"latents": rng.standard_normal(LATENT).astype(np.float32),
             "text_embeds": rng.standard_normal((2, TEXT, 20)).astype(np.float32),
             "override_noise": rng.standard_normal(LATENT).astype(np.float32),
             "override_sigmas": np.asarray([0.3, 0.8], np.float32)}
    batch.update(_mask_batch(extra, rng))
    if extra == "loss3":
        batch["loss_mask"] = rng.uniform(size=(2, 8, 12)).astype(np.float32)
    ours = model.prepare_batch(torch.Generator(), {k: t(v) for k, v in batch.items()})
    theirs = jmodel.prepare_batch(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    for key in ("noisy_latents", "token_timesteps", "loss_mask"):
        assert ours[key].shape == theirs[key].shape, key
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(theirs[key]), rtol=0, atol=1e-6, err_msg=key)
    keep = ours["loss_mask"].numpy()
    assert 0 < keep.sum() < keep.size or name.startswith("mask")
    pred = rng.standard_normal(LATENT).astype(np.float32)
    assert abs(float(model.compute_loss(t(pred), ours)) - float(jmodel.compute_loss(jnp.asarray(pred), theirs))) \
        <= F32_REL * abs(float(jmodel.compute_loss(jnp.asarray(pred), theirs)))


def test_intrinsic_conditioning_refusals_and_draws():
    """The refusals in both packages (an unknown type, a temporal boundary
    past the clip, a crop region of 3 values and an unordered one, a
    missing mask, a 5-D mask); at probability 0.5 the port draws each
    sample's gate from the step's generator after the base draws: a whole
    first frame or none per sample, the same draws for the same seed."""
    rng = np.random.default_rng(12)
    base = {"latents": rng.standard_normal(LATENT).astype(np.float32),
            "text_embeds": rng.standard_normal((2, TEXT, 20)).astype(np.float32)}
    for config, batch, match in (
            ({"ltx2_intrinsic_conditioning": {"type": "bogus"}}, {}, "Unsupported"),
            ({"ltx2_prefix_conditioning_probability": 1.0, "ltx2_prefix_conditioning_frames": 4}, {}, "requested"),
            ({"ltx2_intrinsic_conditioning": {"type": "spatial_crop", "region": [0, 1, 2]}}, {}, "requires"),
            ({"ltx2_intrinsic_conditioning": {"type": "spatial_crop", "region": [3, 0, 1, 2]}}, {}, "ordered"),
            ({"ltx2_mask_conditioning_probability": 1.0}, {}, "missing"),
            ({"ltx2_mask_conditioning_probability": 1.0}, {"loss_mask": np.ones((2, 1, 3, 4, 6), np.float32)},
             "expects")):
        jmodel, model = _pair(_tiny_values(**config))
        full = {**base, **batch}
        with pytest.raises(ValueError, match=match):
            jmodel.prepare_batch(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in full.items()})
        with pytest.raises(ValueError, match=match):
            model.prepare_batch(torch.Generator(), {k: t(v) for k, v in full.items()})
    _, model = _pair(_tiny_values(ltx2_first_frame_conditioning_probability=0.5))
    batch = {**{k: t(v) for k, v in base.items()}, "latents": t(np.tile(base["latents"][:1], (8, 1, 1, 1, 1))),
             "text_embeds": t(np.tile(base["text_embeds"][:1], (8, 1, 1)))}
    runs = [model.prepare_batch(torch.Generator().manual_seed(3), batch)["token_timesteps"] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    first = (runs[0][:, :24] == 0).all(dim=1)
    assert 0 < int(first.sum()) < 8 and bool((runs[0][:, 24:] > 0).all())
    assert first.tolist() == (runs[0][:, :24] == 0).any(dim=1).tolist()


# ---- the joint audiovisual loss and the train step -----------------------------------------------------

STEPS = 3


def _train_values(**extra):
    return _tiny_values(optimizer="adamw", learning_rate=1e-3, adam_weight_decay=0.01, max_grad_norm=1.0,
                        lr_scheduler="constant", max_train_steps=STEPS, **extra)


def _batches(seed=13):
    rng = np.random.default_rng(seed)
    base = {"latents": rng.standard_normal(LATENT).astype(np.float32),
            "audio_latents": rng.standard_normal((2, AUDIO, 6)).astype(np.float32),
            "text_embeds": rng.standard_normal((2, TEXT, 20)).astype(np.float32)}
    return [{**base, "override_noise": rng.standard_normal(LATENT).astype(np.float32),
             "override_audio_noise": rng.standard_normal((2, AUDIO, 6)).astype(np.float32),
             "override_sigmas": rng.uniform(0.05, 0.95, 2).astype(np.float32)} for _ in range(STEPS)]


def test_joint_av_loss_grads_and_adamw_steps_match_jax():
    """A batch with 5 audio latent tokens, the first frame held clean:
    ``prepare_batch``'s audio stream (the same sigmas, ``override_audio_noise``)
    equal to the JAX family's; ``loss_fn`` (the mean of the video and audio
    flow losses) and its ``audio_loss`` within ``F32_REL``, its LoRA
    gradients on every adapter against ``jax.grad`` within ``GRAD_REL``;
    3 AdamW steps through ``build_train_step`` against the JAX step (loss,
    grad norm and ``audio_loss`` within ``GRAD_REL`` each step, the adapters
    after them within ``GRAD_REL``)."""
    values = _train_values(ltx2_first_frame_conditioning_probability=1.0)
    jmodel, model = _pair(values)
    batches = _batches()
    plain = batches[0]
    ours = model.prepare_batch(torch.Generator(), {k: t(v) for k, v in plain.items()})
    theirs = jmodel.prepare_batch(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in plain.items()})
    for key in ("audio_noisy_latents", "audio_target", "token_timesteps"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(theirs[key]), rtol=0, atol=1e-6, err_msg=key)
    jmodule = jmodel.create_module()
    inputs = jmodel.get_model_inputs(theirs)
    variables = fill_numpy(jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), **inputs)), seed=14)
    module = bridge(variables, model.create_module())
    adapters = tl.freeze_base(module)

    def jax_loss(lora):
        loss, aux = jmodel.loss_fn({"params": variables["params"], "lora": lora}, jax.random.PRNGKey(0),
                                   {k: jnp.asarray(v) for k, v in plain.items()})
        return loss, aux["audio_loss"]

    (jloss, jaudio), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    loss, aux = model.loss_fn(module, torch.Generator(), {k: t(v) for k, v in plain.items()})
    assert abs(float(loss.detach()) - float(jloss)) <= F32_REL * abs(float(jloss))
    assert abs(float(aux["audio_loss"]) - float(jaudio)) <= F32_REL * abs(float(jaudio))
    loss.backward()
    jgrads = _flat(jgrads)
    assert sorted(jgrads) == sorted(adapters)
    for path, param in adapters.items():
        assert rel(param.grad.numpy().T, jgrads[path]) < GRAD_REL, path

    tx_j = jax_get_optimizer(JaxTrainingConfig(values), 1e-3)
    state_j = jax_create_train_state(jmodel, jax.tree_util.tree_map(jnp.asarray, variables), tx_j)
    step_j = jax.jit(jax_build_train_step(jmodel, tx_j))
    tx_t = get_optimizer(model.config, 1e-3)
    state_t = create_train_state(model, bridge(variables, model.create_module()), tx_t)
    step_t = build_train_step(model, tx_t)
    for i, batch in enumerate(batches):
        state_j, m_j = step_j(state_j, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(i))
        state_t, m_t = step_t(state_t, {k: t(v) for k, v in batch.items()}, torch.Generator())
        for key in ("loss", "grad_norm", "audio_loss"):
            assert abs(float(m_t[key]) - float(m_j[key])) <= GRAD_REL * abs(float(m_j[key])), (i, key)
    final_j, final_t = _flat(state_j.trainable["lora"]), _flat(lora_to_flax(state_t.module))
    assert sorted(final_j) == sorted(final_t)
    for key in final_j:
        assert rel(final_t[key], final_j[key]) < GRAD_REL, key


# ---- the import and the adapter files -------------------------------------------------------------------


def _jax_params(jmodel, seed):
    inputs = {k: jnp.asarray(v) for k, v in _inputs("masked").items()}
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0), **inputs,
                                                                **_static("masked")))
    return fill_numpy(shapes, seed)["params"]


@pytest.mark.parametrize("gated", [False, True])
def test_import_matches_jax_bitwise(tmp_path, gated):
    """The JAX exporter's file of a seeded tiny transformer (two shards;
    gated streams too): its names and shapes are the port's layout, the
    port's tree bitwise the JAX ``load_ltx2_params`` tree, the imported
    module bitwise the bridged JAX tree."""
    values = _tiny_values()
    jmodel, model = _pair(values)
    if gated:
        jmodel.arch, model.arch = _gated(True), _gated()
    params = _jax_params(jmodel, 4)
    weights = export_ltx2_to_diffusers(params, jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == ltx2_checkpoint_shapes(model.arch)
    root = tmp_path / "ltx2" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_params(jmodel, str(tmp_path / "ltx2"))
    _assert_trees_bitwise(load_ltx2_params(model, str(tmp_path / "ltx2")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "ltx2"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_key_map_and_adapter_file_match_jax(tmp_path):
    """``ltx2_key_map`` equals the JAX map; an adapter file written by the
    port round-trips bitwise and loads into the JAX template bitwise."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    assert _key_map_for(model) == JAX_KEY_MAPS["ltxvideo2"](jmodel) == ltx2_key_map(model.arch)
    source = _seeded_adapters(model, 4, scale=0.05)
    path = str(tmp_path / "adapter.safetensors")
    save_lora_safetensors(model, source, path)
    target = model.create_module()
    assert load_lora_safetensors(model, path, target) == []
    for (name, a), b in zip(tl.lora_parameters(target).items(), tl.lora_parameters(source).values()):
        assert torch.equal(a, b), name
    inputs = {k: jnp.asarray(v) for k, v in _inputs("masked").items()}
    template = numpy_variables(jmodel.create_module(), **inputs, **_static("masked"), seed=1)["lora"]
    loaded = jax_load_lora(jmodel, path, template)
    loaded = loaded[0] if isinstance(loaded, tuple) else loaded
    for name, param in tl.lora_parameters(source).items():
        node = loaded
        for part in name.split("/"):
            node = node[part]
        assert np.array_equal(np.asarray(node), param.detach().numpy().T), name
