"""The torch port's Flux layers and transformer against the JAX package, on the CPU.

Each Flax module gets seeded numpy weights (torch_parity.numpy_variables),
which go to JAX as they are and to the port through its weight bridge; the
same numpy inputs go through both.  No weight is zero: AdaLN ``lin`` kernels
and LoRA ``B`` matrices start at zero in both frameworks, which would zero
every gate and keep attention (and the adapter) from the output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.flux import transformer as jt
from simpletuner_tpu.ops import rope as jrope

from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.flux import transformer as tt
from simpletuner_tpu_torch.models.weight_bridge import flax_to_state_dict, load_flax_params
from simpletuner_tpu_torch.ops import rope as trope

from torch_parity import bridge, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _adapt_every_lora_dense():
    """Building a JAX model family installs a LoRA target predicate for the
    process; these module-level tests adapt every LoRADense, as the port does."""
    previous = jl._LORA_TARGET
    jl.set_lora_target(None)
    yield
    jl.set_lora_target(previous)


# ---- ops/rope ------------------------------------------------------------------------------


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (2, 40, 3)).astype(np.int32)
    cos_j, sin_j = jrope.axial_rope((8, 12, 12), jnp.asarray(ids))
    cos_t, sin_t = trope.axial_rope((8, 12, 12), t(ids))
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6)
    x = rng.standard_normal((2, 40, 3, 32), dtype=np.float32)
    np.testing.assert_allclose(
        trope.apply_rope(t(x), cos_t, sin_t).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), cos_j, sin_j)),
        atol=1e-6,
    )
    with pytest.raises(ValueError):
        trope.rope_frequencies(7, t(ids[..., 0]))


# ---- models/layers ----------------------------------------------------------------------------


def test_norms_and_timestep_embedding_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 64), dtype=np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    rms = load_flax_params(tl.RMSNorm(64, dtype=torch.float32), {"scale": scale})
    ref = jl.RMSNorm(dtype=jnp.float32).apply({"params": {"scale": scale}}, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(rms(t(x)).numpy(), np.asarray(ref), **F32)

    ref = jl.LayerNorm(use_scale=False, use_bias=False, dtype=jnp.float32).apply({}, jnp.asarray(x))
    np.testing.assert_allclose(tl.layer_norm(t(x), torch.float32).numpy(), np.asarray(ref), **F32)

    for dim in (256, 33):
        times = np.array([0.0, 0.25, 1.0], np.float32)
        # args reach 1000 rad: f32 sin/cos of large arguments differ by a few ulp of 1000
        np.testing.assert_allclose(
            tl.timestep_embedding(t(times), dim).numpy(),
            np.asarray(jl.timestep_embedding(jnp.asarray(times), dim)),
            atol=1e-4,
        )


@pytest.mark.parametrize("name", ["mlp_embedder", "feed_forward", "ada_ln_zero", "lora_dense"])
def test_layer_matches_jax(name):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 48), dtype=np.float32)
    if name == "mlp_embedder":
        flax_mod, port = jl.MLPEmbedder(64, dtype=jnp.float32), tl.MLPEmbedder(48, 64, dtype=torch.float32)
    elif name == "feed_forward":
        flax_mod = jl.FeedForward(48, 2.0, dtype=jnp.float32, lora_rank=4)
        port = tl.FeedForward(48, 2.0, dtype=torch.float32, lora_rank=4)
    elif name == "ada_ln_zero":
        flax_mod, port = jl.AdaLayerNormZero(3, dtype=jnp.float32), tl.AdaLayerNormZero(48, 3, dtype=torch.float32)
    else:
        flax_mod = jl.LoRADense(40, dtype=jnp.float32, lora_rank=4, lora_alpha=8.0)
        port = tl.LoRADense(48, 40, dtype=torch.float32, lora_rank=4, lora_alpha=8.0)
    args = (jnp.asarray(x), 48) if name == "ada_ln_zero" else (jnp.asarray(x),)
    variables = numpy_variables(flax_mod, *args)
    bridge(variables, port)
    ref = jax.jit(flax_mod.apply, static_argnums=(2,) if name == "ada_ln_zero" else ())(variables, *args)
    with torch.no_grad():
        out = port(t(x))
    if name == "ada_ln_zero":
        assert len(out) == 3
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), **F32)
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_unported_layer_options_raise():
    with pytest.raises(NotImplementedError):
        tl.LoRADense(8, 8, lora_rank=2, lora_algo="lokr")


def test_seeded_init_mirrors_flax_initialisers():
    gen = torch.Generator().manual_seed(0)
    block = tl.init_parameters(tt.SingleStreamBlock(tt.FluxConfig.tiny(), dtype=torch.float32, lora_rank=4), gen)
    assert (block.modulation.lin.weight == 0).all()  # AdaLN-Zero
    assert (block.norm_q.scale == 1).all() and (block.linear1.bias == 0).all()
    assert (block.linear1.lora_B == 0).all()
    w = block.linear1.weight
    # truncated at 2 sigma, unit-variance-corrected lecun normal: std 1/sqrt(fan_in)
    assert w.abs().max() <= 2 * (64 ** -0.5) / 0.8796 + 1e-6
    assert abs(w.std().item() - 64 ** -0.5) < 0.01


# ---- models/flux/transformer ----------------------------------------------------------------


def _stream_inputs(seed, batch=1, txt=6, img=16, dim=64, heads=2, head_dim=32, axes=(8, 12, 12)):
    rng = np.random.default_rng(seed)
    ids = np.concatenate(
        [np.zeros((batch, txt, 3), np.int32), np.asarray(jt.make_img_ids(batch, 8, 8))], axis=1
    )
    rope_j = jrope.axial_rope(axes, jnp.asarray(ids))
    rope_t = trope.axial_rope(axes, t(ids))
    return rng, rope_j, rope_t


@pytest.mark.parametrize("masked", [False, True])
def test_double_stream_block_matches_jax(masked):
    cfg = jt.FluxConfig.tiny()
    rng, rope_j, rope_t = _stream_inputs(3)
    img = rng.standard_normal((1, 16, 64), dtype=np.float32)
    txt = rng.standard_normal((1, 6, 64), dtype=np.float32)
    vec = rng.standard_normal((1, 64), dtype=np.float32)
    seg = None
    if masked:
        seg = np.zeros((1, 22), np.int32)
        seg[:, 3:6] = -1
    block = jt.DoubleStreamBlock(cfg, dtype=jnp.float32, lora_rank=4)
    seg_j = None if seg is None else jnp.asarray(seg)
    variables = numpy_variables(block, img, txt, vec, rope_j, seg_j)
    ref_img, ref_txt = jax.jit(block.apply)(variables, img, txt, vec, rope_j, seg_j)
    port = bridge(variables, tt.DoubleStreamBlock(tt.FluxConfig.tiny(), dtype=torch.float32, lora_rank=4))
    with torch.no_grad():
        out_img, out_txt = port(t(img), t(txt), t(vec), rope_t, None if seg is None else t(seg))
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img), **F32)
    np.testing.assert_allclose(out_txt.numpy(), np.asarray(ref_txt), **F32)


def test_single_stream_block_matches_jax():
    cfg = jt.FluxConfig.tiny()
    rng, rope_j, rope_t = _stream_inputs(4)
    x = rng.standard_normal((1, 22, 64), dtype=np.float32)
    vec = rng.standard_normal((1, 64), dtype=np.float32)
    block = jt.SingleStreamBlock(cfg, dtype=jnp.float32, lora_rank=4)
    variables = numpy_variables(block, x, vec, rope_j)
    ref = jax.jit(block.apply)(variables, x, vec, rope_j)
    port = bridge(variables, tt.SingleStreamBlock(tt.FluxConfig.tiny(), dtype=torch.float32, lora_rank=4))
    with torch.no_grad():
        out = port(t(x), t(vec), rope_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def _flux_inputs(seed, batch=1, height=8, width=8, txt_len=12, valid=5):
    rng = np.random.default_rng(seed)
    inputs = {
        "img": rng.standard_normal((batch, height * width // 4, 16), dtype=np.float32),
        "img_ids": np.asarray(jt.make_img_ids(batch, height, width)),
        "txt": rng.standard_normal((batch, txt_len, 32), dtype=np.float32),
        "txt_ids": np.asarray(jt.make_txt_ids(batch, txt_len)),
        "timesteps": np.array([0.7] * batch, np.float32),
        "vec": rng.standard_normal((batch, 32), dtype=np.float32),
        "guidance": np.array([3.5] * batch, np.float32),
    }
    seg = np.zeros((batch, txt_len + height * width // 4), np.int32)
    seg[:, valid:txt_len] = -1
    return inputs, seg


# f32: only f32 sum order differs -> 1e-4 relative L2 over 4 blocks.
# bf16: both sides round to bf16 after every op, but at different sites
# (F.linear fuses the bias add, torch's gelu/silu round once, XLA may keep
# f32 inside fusions), so outputs agree to a few bf16 ulps: 3e-2 relative L2.
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_flux_transformer_matches_jax(dtype, masked):
    jdt, tdt, tol = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}[dtype]
    inputs, seg = _flux_inputs(5)
    model = jt.FluxTransformer(config=jt.FluxConfig.tiny(), dtype=jdt, lora_rank=4)
    variables = numpy_variables(model, **inputs)
    port = bridge(variables, tt.FluxTransformer(tt.FluxConfig.tiny(), dtype=tdt, lora_rank=4))
    seg_arg = seg if masked else None
    ref = np.asarray(jax.jit(model.apply)(variables, **inputs, segment_ids=seg_arg))
    with torch.no_grad():
        out = port(**{k: t(v) for k, v in inputs.items()}, segment_ids=None if seg_arg is None else t(seg_arg))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel(out.numpy(), ref) < tol
    if masked:
        # the mask matters: without it the port lands far from the masked reference
        with torch.no_grad():
            unmasked = port(**{k: t(v) for k, v in inputs.items()})
        assert rel(unmasked.numpy(), ref) > 5 * rel(out.numpy(), ref)


def test_pack_unpack_and_ids_match_jax():
    rng = np.random.default_rng(6)
    latents = rng.standard_normal((2, 8, 12, 16), dtype=np.float32)
    packed = tt.pack_latents(t(latents))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jt.pack_latents(jnp.asarray(latents))))
    np.testing.assert_array_equal(tt.unpack_latents(packed, 8, 12).numpy(), latents)
    np.testing.assert_array_equal(tt.make_img_ids(2, 8, 12).numpy(), np.asarray(jt.make_img_ids(2, 8, 12)))
    np.testing.assert_array_equal(tt.make_txt_ids(2, 7).numpy(), np.asarray(jt.make_txt_ids(2, 7)))


def test_bridge_refuses_quantized_and_incomplete_trees():
    from simpletuner_tpu.training.quantization import QuantizedParam

    port = tl.LoRADense(4, 3, dtype=torch.float32)
    good = {"kernel": np.ones((4, 3), np.float32), "bias": np.zeros(3, np.float32)}
    assert flax_to_state_dict(good, port)["weight"].shape == (3, 4)
    int8_tree = {"kernel": np.ones((4, 3), np.int8), "bias": good["bias"]}
    scales = {"kernel_scale": np.full(3, 0.5, np.float32)}
    # a quantized leaf needs a port layer quantized in the same mode
    with pytest.raises(ValueError):
        flax_to_state_dict(int8_tree, port)
    quantized = tl.LoRADense(4, 3, dtype=torch.float32)
    quantized.quantize_("int8")
    state = flax_to_state_dict(int8_tree, quantized, qscales=scales)
    assert state["weight"].dtype == torch.int8 and state["weight_scale"].tolist() == [0.5] * 3
    with pytest.raises(ValueError):
        flax_to_state_dict({"kernel": np.ones((4, 3), np.int8), "bias": good["bias"]}, port)
    # what is still unported: legacy QuantizedParam leaves, other storage dtypes
    legacy = QuantizedParam(jnp.ones((4, 3), jnp.int8), jnp.ones(3), 1)
    with pytest.raises(NotImplementedError):
        flax_to_state_dict({"kernel": legacy, "bias": good["bias"]}, quantized)
    with pytest.raises(NotImplementedError):
        flax_to_state_dict({"kernel": np.ones((4, 3), np.int32), "bias": good["bias"]}, port)
    with pytest.raises(KeyError):
        flax_to_state_dict({"kernel": good["kernel"]}, port)
    with pytest.raises(ValueError):
        flax_to_state_dict({"kernel": np.ones((3, 4), np.float32), "bias": good["bias"]}, port)
