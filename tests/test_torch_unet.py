"""The torch port's UNet (``models/unet.py``) against the JAX package, on the CPU.

The same seeded numpy weights (every leaf nonzero, LoRA B included, so the
adapters reach the output) and inputs go through the Flax module and the
port's, bridged by ``weight_bridge``: the blocks, the ``tiny`` UNet (SD 1.x
shape) and the ``tiny_xl`` UNet (SDXL shape, with the added conditioning),
forward and the LoRA gradients of a fixed linear loss against ``jax.grad``,
with remat off and on.  Everything is f32; only the order of f32 sums
differs.  Outputs are held to a relative L2 of 1e-5.  The LoRA gradients
pass back through every level, and at this depth f32 itself is the limit:
against the same computation in float64 (JAX with x64, measured once
outside the suite), the JAX f32 gradients are off by up to 2.9e-5 and the
port's by up to 2.0e-5 in relative L2 per adapter, so each adapter's
gradient is held to 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models import unet as ju

from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models import unet as tu

from torch_parity import bridge, numpy_variables, rel, t

F32_REL = 1e-5
GRAD_REL = 1e-4  # f32 gradients through the whole UNet (module docstring)


@pytest.fixture(autouse=True)
def _restore_jax_globals():
    """Building a JAX model family installs a process-wide LoRA target
    predicate; the module-level cases adapt every LoRADense."""
    previous = jl._LORA_TARGET
    jl.set_lora_target(None)
    yield
    jl.set_lora_target(previous)


def _configs(name):
    return getattr(ju.UNetConfig, name)(), getattr(tu.UNetConfig, name)()


def _inputs(cfg, seed, batch=2, size=8, txt=9):
    rng = np.random.default_rng(seed)
    inputs = [rng.standard_normal((batch, size, size, cfg.in_channels), dtype=np.float32),
              np.asarray(rng.integers(0, 1000, batch), np.int32),
              rng.standard_normal((batch, txt, cfg.cross_attention_dim), dtype=np.float32)]
    if cfg.addition_embed_dim:
        inputs.append(rng.standard_normal((batch, cfg.addition_embed_dim), dtype=np.float32))
    return inputs


def test_config_presets_match():
    for name in ("sd15", "sd21", "sdxl", "tiny", "tiny_xl"):
        ours, theirs = _configs(name)[1], _configs(name)[0]
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), name


def test_resnet_block_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 6, 16), dtype=np.float32)
    temb = rng.standard_normal((2, 40), dtype=np.float32)
    block = ju.ResnetBlock(32, norm_groups=8, dtype=jnp.float32)  # 16 -> 32: the 1x1 shortcut
    variables = numpy_variables(block, x, temb)
    ref = np.asarray(jax.jit(block.apply)(variables, x, temb))
    port = bridge(variables, tu.ResnetBlock(16, 32, 40, 8, dtype=torch.float32))
    with torch.no_grad():
        out = port(t(x).permute(0, 3, 1, 2), t(temb)).permute(0, 2, 3, 1)
    assert rel(out.numpy(), ref) < F32_REL


def test_spatial_transformer_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 6, 32), dtype=np.float32)
    context = rng.standard_normal((2, 7, 24), dtype=np.float32)
    block = ju.SpatialTransformer(depth=2, num_heads=2, head_dim=16, norm_groups=8, lora_rank=4,
                                  dtype=jnp.float32)
    variables = numpy_variables(block, x, context)
    ref = np.asarray(jax.jit(block.apply)(variables, x, context))
    port = bridge(variables, tu.SpatialTransformer(32, 24, 2, 2, 16, 8, dtype=torch.float32, lora_rank=4))
    with torch.no_grad():
        out = port(t(x).permute(0, 3, 1, 2), t(context)).permute(0, 2, 3, 1)
    assert rel(out.numpy(), ref) < F32_REL


def test_sdxl_added_cond_matches_jax():
    rng = np.random.default_rng(2)
    time_ids = np.asarray([[1024, 1024, 0, 0, 1024, 1024], [896, 1152, 32, 0, 832, 1216]], np.float32)
    pooled = rng.standard_normal((2, 64), dtype=np.float32)
    ours = tu.make_sdxl_added_cond(t(time_ids), t(pooled), 8).numpy()
    theirs = np.asarray(ju.make_sdxl_added_cond(jnp.asarray(time_ids), jnp.asarray(pooled), 8))
    assert ours.shape == theirs.shape == (2, 64 + 6 * 8)
    np.testing.assert_array_equal(ours[:, :64], pooled)  # pooled first
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,remat", [("tiny", False), ("tiny_xl", False), ("tiny_xl", True)],
                         ids=["tiny-plain", "tiny_xl-plain", "tiny_xl-remat"])
def test_unet_forward_and_lora_grads_match_jax(name, remat):
    cfg_j, cfg_t = _configs(name)
    inputs = _inputs(cfg_j, 3)
    model = ju.UNet2DCondition(config=cfg_j, dtype=jnp.float32, lora_rank=4, remat=remat)
    variables = numpy_variables(model, *inputs)
    port = bridge(variables, tu.UNet2DCondition(cfg_t, dtype=torch.float32, lora_rank=4, remat=remat))
    weight = np.random.default_rng(4).standard_normal(inputs[0].shape[:3] + (cfg_j.out_channels,), dtype=np.float32)

    def loss_j(lora):
        out = model.apply({"params": variables["params"], "lora": lora}, *[jnp.asarray(x) for x in inputs])
        return jnp.sum(out * weight), out

    (loss_ref, ref), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(port)
    out = port(*[t(x) for x in inputs])
    loss = (out * t(weight)).sum()
    loss.backward()
    assert out.dtype == torch.float32 and tuple(out.shape) == np.asarray(ref).shape
    assert rel(out.detach().numpy(), np.asarray(ref)) < F32_REL
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters)
    for path, param in adapters.items():
        assert param.grad is not None and rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_unet_adapters_sit_on_attention_and_feed_forward():
    port = tu.UNet2DCondition(tu.UNetConfig.tiny_xl(), dtype=torch.float32, lora_rank=4)
    leaves = {path.rsplit("/", 2)[-2] for path in tl.lora_parameters(port)}
    assert leaves == {"to_q", "to_k", "to_v", "to_out", "ff_proj", "ff_out"}


def test_unet_refusals_and_init():
    cfg = tu.UNetConfig.tiny_xl()
    port = tl.init_parameters(tu.UNet2DCondition(cfg, dtype=torch.float32), torch.Generator().manual_seed(0))
    inputs = [t(x) for x in _inputs(cfg, 5, batch=1)]
    assert torch.isfinite(port(*inputs)).all()
    assert port.down_0_attn_0.blocks_0.norm1.weight.eq(1).all() and port.conv_in.weight.std() > 0
    with pytest.raises(NotImplementedError, match="item 7"):
        port(*inputs, controlnet_skip_residuals=(inputs[0],))
    with pytest.raises(NotImplementedError, match="item 7"):
        port(*inputs, grounding_boxes=torch.zeros(1, 2, 4))
    with pytest.raises(NotImplementedError, match="item 4h"):
        port(*inputs, intermediates=True)
    with pytest.raises(NotImplementedError, match="item 6"):
        tu.UNet2DCondition(dataclasses.replace(cfg, class_embed_timestep=True))
    with pytest.raises(ValueError, match="added_cond"):
        port(*inputs[:3])
