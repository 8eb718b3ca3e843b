"""The torch port's HiDream-I1 family against the JAX package, on the CPU.

The presets, the MoE (top-k with a tie in the gate scores, the
un-normalised routing, the load-balance term), the full-width RMS norms and
the axial rope, the double and single blocks, the DiT with its LoRA
gradients and its list of load-balance terms (one or two Llama layers,
remat, bf16), the family contract (the negated output, ``loss_fn`` with and
without the load-balancing loss, ``moe_gate_loss``), the train step's aux
metric (one step and two micro-steps against the JAX step),
``encode_text`` / collate over four encoders, the import of the JAX
exporter's output, the key map and the quirks kept from the JAX family:
the same seeded numpy weights and inputs go through both packages.  The
trainer's trajectory is in test_torch_hidream_trainer.py.  Every tolerance
is stated where it is checked.  At the tiny size the head dim is 24; the
published D = 128 shapes are held to the plain version on the card
(test_torch_kernels_cuda.py).
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
from simpletuner_tpu.models.hidream import transformer as jax_hd
from simpletuner_tpu.models.hidream.model import HiDream as JaxHiDream
from simpletuner_tpu.models.weight_export import export_hidream_to_diffusers
from simpletuner_tpu.models.weight_import import load_hidream_params as jax_load_hidream_params
from simpletuner_tpu.ops.rope import axial_rope as jax_axial_rope
from simpletuner_tpu.training.lora import hidream_key_map as jax_hidream_key_map
from simpletuner_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from simpletuner_tpu.training.train_state import build_train_step as jax_build_train_step
from simpletuner_tpu.training.train_state import create_train_state as jax_create_train_state

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import hidream_checkpoint_shapes
from simpletuner_tpu_torch.models.hidream import HiDream, HiDreamConfig, HiDreamTransformer
from simpletuner_tpu_torch.models.hidream import transformer as hd
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import load_hidream_params, load_transformer_params
from simpletuner_tpu_torch.training.lora import _key_map_for, hidream_key_map
from simpletuner_tpu_torch.training.optimizers import get_optimizer
from simpletuner_tpu_torch.training.train_state import build_train_step, create_train_state

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# gradient-derived numbers (test_torch_sdxl.py: f32 gradients through a deep
# net are a few 1e-5 off float64 on either side)
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
    return {"model_family": "hidream", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxHiDream(JaxTrainingConfig(values)), HiDream(config_namespace(values))


def _jax_config(cfg):
    return jax_hd.HiDreamConfig(**dataclasses.asdict(cfg))


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_presets_match_jax():
    """The tiny and published presets as the JAX ones (with their derived
    FFN widths: 6912 and 3584 at the published size); the published
    parameter count from the checkpoint layout (17.1B)."""
    for ours, theirs in ((HiDreamConfig.tiny(), jax_hd.HiDreamConfig.tiny()), (HiDreamConfig(), jax_hd.HiDreamConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert (ours.hidden_size, ours.ffn_inner, ours.shared_ffn_inner) == \
            (theirs.hidden_size, theirs.ffn_inner, theirs.shared_ffn_inner)
    cfg = HiDreamConfig()
    assert (cfg.hidden_size, cfg.ffn_inner, cfg.shared_ffn_inner) == (2560, 6912, 3584)
    assert sum(int(np.prod(s)) for s in hidream_checkpoint_shapes(cfg).values()) == 17_105_733_184
    for preset in ("tiny", None):
        jmodel, model = _pair(_tiny_values(model_arch_preset=preset))
        assert dataclasses.asdict(model.arch) == dataclasses.asdict(jmodel.arch)


def _moe_pair(cfg, seed, tie=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 6, cfg.hidden_size)).astype(np.float32)
    jmoe = jax_hd.HiDreamMoE(_jax_config(cfg), dtype=jnp.float32, lora_rank=4)
    variables = numpy_variables(jmoe, jnp.asarray(x), seed=seed + 1)
    if tie:  # two experts with one gate row: their scores tie for every token
        variables["params"]["gate"][1] = variables["params"]["gate"][0]
    port = bridge(variables, hd.HiDreamMoE(cfg, dtype=torch.float32, lora_rank=4))
    return x, jmoe, variables, port


@pytest.mark.parametrize("case", ["top1", "top2_of_4", "tie"])
def test_moe_matches_jax(case):
    """The MoE (f32, rank-4 shared-expert adapters): the output within
    ``F32_REL`` and the load-balance term within 1e-6 relative of the JAX
    ``sow``; top-1 of 2 (tiny), top-2 of 4 (published routing) and a tie in
    the gate scores, where ``scores >= top_vals[..., -1:]`` selects both tied
    experts (more than k) in both packages."""
    cfg = HiDreamConfig.tiny() if case != "top2_of_4" else dataclasses.replace(HiDreamConfig.tiny(), num_experts=4,
                                                                               top_k=2)
    if case == "tie":
        cfg = dataclasses.replace(cfg, num_experts=3)
    x, jmoe, variables, port = _moe_pair(cfg, 3, tie=case == "tie")
    ref, state = jmoe.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x),
                            mutable=["intermediates"])
    (jaux,) = state["intermediates"]["moe_aux"]
    with torch.no_grad():
        out, aux = port(t(x))
    assert tuple(out.shape) == ref.shape and rel(out.numpy(), ref) < F32_REL
    assert aux.dim() == 0 and abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    if case == "tie":
        scores = torch.softmax(torch.einsum("bsd,ed->bse", t(x), port.gate), dim=-1)
        chosen = scores >= torch.topk(scores, cfg.top_k, dim=-1).values[..., -1:]
        assert torch.equal(scores[..., 0], scores[..., 1]) and int(chosen.sum(-1).max()) > cfg.top_k


def test_rope_and_full_width_rms_match_jax():
    """The axial tables over [image (0, row, col), text zeros] against the
    JAX ``axial_rope`` on the same ids, and ``_rms_full`` (eps 1e-5, over
    the whole projection), within ``F32_REL``."""
    cfg = HiDreamConfig()
    port = HiDreamTransformer.__new__(HiDreamTransformer)
    nn_init = torch.nn.Module.__init__
    nn_init(port)
    port.config, port._rope = cfg, {}
    cos, sin = port.rope(3, 5, 7, torch.device("cpu"))
    rows, cols = jnp.repeat(jnp.arange(3.0), 5), jnp.tile(jnp.arange(5.0), 3)
    ids = jnp.concatenate([jnp.stack([jnp.zeros_like(rows), rows, cols], -1), jnp.zeros((7, 3))], 0)
    jcos, jsin = jax_axial_rope(cfg.axes_dim, ids[None], cfg.rope_theta)
    assert cos.shape == (1, 22, 64) and rel(cos.numpy(), jcos) < F32_REL and rel(sin.numpy(), jsin) < F32_REL
    rng = np.random.default_rng(0)
    x, scale = rng.standard_normal((2, 5, 48)).astype(np.float32), rng.standard_normal(48).astype(np.float32)
    assert rel(hd._rms_full(t(x), t(scale)).numpy(), jax_hd._rms_full(jnp.asarray(x), jnp.asarray(scale))) < F32_REL


def _rope(cfg, hh, ww, txt_len):
    rows, cols = jnp.repeat(jnp.arange(float(hh)), ww), jnp.tile(jnp.arange(float(ww)), hh)
    ids = jnp.concatenate([jnp.stack([jnp.zeros_like(rows), rows, cols], -1), jnp.zeros((txt_len, 3))], 0)
    return tuple(np.asarray(a) for a in jax_axial_rope(cfg.axes_dim, ids[None], cfg.rope_theta))


@pytest.mark.parametrize("kind", ["double", "single"])
def test_blocks_match_jax(kind):
    """One double block (image first in the joint attention, the MoE on the
    image stream, SwiGLU on the text) or single block, f32 with rank-4
    adapters and drawn (non-zero) adaLN: the streams within ``F32_REL``, the
    load-balance term within 1e-6 relative."""
    cfg = HiDreamConfig.tiny()
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 6, cfg.hidden_size)).astype(np.float32)
    txt = rng.standard_normal((2, 5, cfg.hidden_size)).astype(np.float32)
    adaln = rng.standard_normal((2, cfg.hidden_size)).astype(np.float32)
    if kind == "double":
        cos, sin = _rope(cfg, 2, 3, 5)
        jblock = jax_hd.HiDreamDoubleBlock(_jax_config(cfg), dtype=jnp.float32, lora_rank=4)
        jargs = (jnp.asarray(img), jnp.asarray(txt), jnp.asarray(adaln), (jnp.asarray(cos), jnp.asarray(sin)))
        port_cls, args = hd.HiDreamDoubleBlock, (img, txt, adaln, cos, sin)
    else:
        cos, sin = _rope(cfg, 2, 3, 5)
        merged = np.concatenate([img, txt], axis=1)
        jblock = jax_hd.HiDreamSingleBlock(_jax_config(cfg), dtype=jnp.float32, lora_rank=4)
        jargs = (jnp.asarray(merged), jnp.asarray(adaln), (jnp.asarray(cos), jnp.asarray(sin)))
        port_cls, args = hd.HiDreamSingleBlock, (merged, adaln, cos, sin)
    variables = numpy_variables(jblock, *jargs, seed=2)
    port = bridge(variables, port_cls(cfg, dtype=torch.float32, lora_rank=4))
    ref, state = jblock.apply(jax.tree_util.tree_map(jnp.asarray, variables), *jargs, mutable=["intermediates"])
    (jaux,) = state["intermediates"]["ff_i"]["moe_aux"]
    with torch.no_grad():
        *outs, aux = port(*map(t, args))
    for a, b in zip(outs, ref if kind == "double" else (ref,)):
        assert tuple(a.shape) == b.shape and rel(a.numpy(), b) < F32_REL
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))


def _inputs(cfg, n_sel=1, seed=0, size=(6, 4)):
    rng = np.random.default_rng(seed)
    latents = rng.standard_normal((2, *size, cfg.in_channels)).astype(np.float32)
    timesteps = rng.uniform(0.05, 0.95, 2).astype(np.float32)
    t5 = rng.standard_normal((2, 5, cfg.t5_dim)).astype(np.float32)
    llama = rng.standard_normal((2, n_sel, 4, cfg.llama_dim)).astype(np.float32)
    pooled = rng.standard_normal((2, cfg.pooled_dim)).astype(np.float32)
    return latents, timesteps, t5, llama, pooled


def _jax_aux_terms(state):
    terms = []

    def collect(node):
        for key, value in node.items():
            if key == "moe_aux":
                terms.append(np.asarray(value[0]))
            elif isinstance(value, dict):
                collect(value)

    collect(state["intermediates"])
    return terms


@pytest.mark.parametrize("variant", ["one_layer", "two_layers", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny DiT (f32, rank-4 adapters, drawn adaLN) on the same seeded
    weights, with one Llama layer (what ``encode_text`` gives) or two (block
    ``i`` reads ``i % 2``) and under remat: the output within ``F32_REL``,
    the load-balance terms (one per MoE, in block order) within 1e-6
    relative of the JAX ``sow``s; the LoRA gradients of a seeded projection
    against ``jax.grad`` within ``GRAD_REL`` (exactly zero on both sides for
    an adapter no output reads)."""
    cfg = HiDreamConfig.tiny()
    remat = variant == "remat"
    latents, timesteps, t5, llama, pooled = _inputs(cfg, n_sel=2 if variant == "two_layers" else 1)
    weight = np.random.default_rng(9).standard_normal(latents.shape).astype(np.float32)
    jmodule = jax_hd.HiDreamTransformer(config=_jax_config(cfg), dtype=jnp.float32, lora_rank=4, remat=remat)
    jargs = [jnp.asarray(a) for a in (latents, timesteps, t5, llama, pooled)]
    variables = numpy_variables(jmodule, *jargs, seed=1)
    port = bridge(variables, HiDreamTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=remat))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

    def jax_loss(lora):
        out, state = jmodule.apply({"params": params, "lora": lora}, *jargs, mutable=["intermediates"])
        return jnp.sum(out * weight), (out, state)

    (_, (ref, state)), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(port)
    out, aux = port(*map(t, (latents, timesteps, t5, llama, pooled)), with_aux=True)
    assert tuple(out.shape) == ref.shape == weight.shape and out.dtype == torch.float32
    assert rel(out.detach().numpy(), ref) < F32_REL
    jaux = _jax_aux_terms(state)
    assert len(aux) == len(jaux) == cfg.depth_double + cfg.depth_single
    assert abs(float(torch.stack(aux).mean().detach()) - float(np.mean(jaux))) <= 1e-6 * abs(float(np.mean(jaux)))
    (out * t(weight)).sum().backward()
    flat = _flat(grads)
    assert sorted(flat) == sorted(adapters)
    assert {"patch_in/lora_A", "caption_proj_t5/lora_B", "caption_proj_2/lora_A", "double_0/ff_t/w2/lora_A",
            "single_1/ff_i/shared_experts/w3/lora_B", "final_proj/lora_A"} <= set(flat)
    assert not any("experts_w" in path or "ada" in path or "final_mod" in path for path in flat)
    for path, param in adapters.items():
        grad = torch.zeros_like(param) if param.grad is None else param.grad  # None: off autograd's graph
        ours, theirs = grad.numpy().T, flat[path]
        assert (not np.any(ours)) if not np.any(theirs) else rel(ours, theirs) < GRAD_REL, path


def test_transformer_bf16_matches_jax():
    """The tiny DiT in bf16 (f32 adapters, gate and norm scales) against the
    JAX module in bf16 on the same weights: within ``BF16_REL``."""
    cfg = HiDreamConfig.tiny()
    args = _inputs(cfg, seed=3)
    jmodule = jax_hd.HiDreamTransformer(config=_jax_config(cfg), dtype=jnp.bfloat16, lora_rank=4)
    jargs = [jnp.asarray(a) for a in args]
    variables = numpy_variables(jmodule, *jargs, seed=4)
    port = bridge(variables, HiDreamTransformer(cfg, dtype=torch.bfloat16, lora_rank=4))
    assert port.double_0.ff_i.gate.dtype == torch.float32 and port.double_0.ff_i.experts_w1.dtype == torch.bfloat16
    ref = np.asarray(jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables), *jargs))
    with torch.no_grad():
        out = port(*map(t, args)).numpy()
    assert rel(out, ref) < BF16_REL


# ---- the family contract, the loss and the step's aux metric -----------------------------------------


def _batch(model, seed=5, n_sel=2):
    cfg = model.arch
    latents, _, t5, llama, pooled = _inputs(cfg, n_sel=n_sel, seed=seed, size=(4, 4))
    rng = np.random.default_rng(seed + 1)
    return {"latents": latents, "t5_embeds": t5, "llama_embeds": llama, "pooled_embeds": pooled,
            "override_noise": rng.standard_normal(latents.shape).astype(np.float32),
            "override_sigmas": rng.uniform(0.05, 0.95, 2).astype(np.float32)}


def test_contract_matches_jax():
    """Constants, specs (four encoders; the Llama and T5 tokenizer
    subfolders left to the builders), arch and example batch as the JAX
    family's; ``model_predict`` is the negated DiT output and equals the JAX
    ``model_predict`` within ``F32_REL``, ``denoise_fn`` too; the registry
    builds it; a non-flow prediction type is refused; the intermediates taps
    are refused by name."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "MODALITY", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR",
                 "HUGGINGFACE_PATHS", "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR", "VAE_SHIFT_FACTOR",
                 "LATENT_CHANNEL_COUNT", "LLAMA_SELECTED_LAYERS"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [dataclasses.asdict(s) for s in model.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in jmodel.TEXT_ENCODER_CONFIGURATION]
    assert [s.tokenizer_subfolder for s in model.TEXT_ENCODER_CONFIGURATION] == [None] * 4
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 64).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 64).items()}
    assert "hidream" in PORTED and type(get_model_family(config_namespace(_tiny_values()))) is HiDream
    with pytest.raises(ValueError, match="flow-matching"):
        HiDream(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    with pytest.raises(NotImplementedError, match="item 4h"):
        model.model_predict_with_intermediates(None, {})
    batch = _batch(model)
    prepared = {"noisy_latents": batch["latents"], "timesteps": batch["override_sigmas"],
                **{k: batch[k] for k in ("t5_embeds", "llama_embeds", "pooled_embeds")}}
    jmodule = jmodel.create_module()
    variables = numpy_variables(jmodule, **jmodel.get_model_inputs(jax.tree_util.tree_map(jnp.asarray, prepared)),
                                seed=6)
    module = bridge(variables, model.create_module())
    with torch.no_grad():
        ours = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
        raw = module(**model.get_model_inputs({k: t(v) for k, v in prepared.items()})).numpy()
        cond = model.inference_conditioning({k: t(v[:1]) for k, v in prepared.items()})
        denoised = model.denoise_fn(module, cond)(t(batch["latents"][:1]), torch.tensor(float(prepared["timesteps"][0])))
    theirs = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                      jax.tree_util.tree_map(jnp.asarray, prepared)))
    assert np.array_equal(ours, -raw) and rel(ours, theirs) < F32_REL and rel(denoised.numpy(), theirs[:1]) < F32_REL


@pytest.mark.parametrize("balance", [False, True])
def test_loss_fn_and_moe_gate_loss_match_jax(balance):
    """``loss_fn`` on one batch with the same noise and sigmas: the loss
    within ``F32_REL`` and ``moe_gate_loss`` within 1e-6 relative of the JAX
    ``loss_fn``'s, with ``hidream_use_load_balancing_loss`` off (the metric
    only) and on (weight 0.5: the loss moves by half the metric)."""
    values = _tiny_values(hidream_use_load_balancing_loss=balance, hidream_load_balancing_loss_weight=0.5)
    jmodel, model = _pair(values)
    assert model.moe_aux_weight == jmodel.moe_aux_weight == (0.5 if balance else 0.0)
    batch = _batch(model)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    variables = fill_numpy(jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jbatch)), seed=7)
    module = bridge(variables, model.create_module())
    jloss, jaux = jax.jit(jmodel.loss_fn)(jax.tree_util.tree_map(jnp.asarray, variables), jax.random.PRNGKey(0), jbatch)
    with torch.no_grad():
        loss, aux = model.loss_fn(module, torch.Generator(), {k: t(v) for k, v in batch.items()})
    assert sorted(aux) == sorted(jaux) == ["moe_gate_loss", "timesteps"] and aux["moe_gate_loss"].dim() == 0
    assert abs(float(aux["moe_gate_loss"]) - float(jaux["moe_gate_loss"])) <= 1e-6 * float(jaux["moe_gate_loss"])
    assert abs(float(loss) - float(jloss)) <= F32_REL * abs(float(jloss))
    if balance:
        with torch.no_grad():
            plain, _ = HiDream(config_namespace(_tiny_values())).loss_fn(module, torch.Generator(),
                                                                         {k: t(v) for k, v in batch.items()})
        assert abs(float(loss) - float(plain) - 0.5 * float(aux["moe_gate_loss"])) <= 1e-6


@pytest.mark.parametrize("accum", [1, 2])
def test_step_carries_moe_gate_loss_as_jax(accum):
    """The aux repair: the train step's metrics hold every 0-d value of
    ``loss_fn``'s aux dict, as the JAX step's do: ``moe_gate_loss`` after
    one step with one micro-batch, and averaged over two micro-steps under
    ``grad_accum_steps`` 2 (within 1e-6 relative); the loss and grad norm
    within ``GRAD_REL``; the (B,) timesteps are not a metric in either."""
    values = _tiny_values(hidream_use_load_balancing_loss=True, optimizer="adamw", learning_rate=1e-3)
    jmodel, model = _pair(values)
    batches = [_batch(model, seed=s) for s in range(accum)]
    batch = batches[0] if accum == 1 else {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    variables = fill_numpy(jax.eval_shape(lambda: jmodel.init_params(
        jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, batches[0]))), seed=8)
    tx_j = jax_get_optimizer(JaxTrainingConfig(values), 1e-3)
    state_j = jax_create_train_state(jmodel, jax.tree_util.tree_map(jnp.asarray, variables), tx_j)
    _, metrics_j = jax.jit(jax_build_train_step(jmodel, tx_j, grad_accum_steps=accum))(
        state_j, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0))
    tx_t = get_optimizer(model.config, 1e-3)
    state_t = create_train_state(model, bridge(variables, model.create_module()), tx_t)
    _, metrics_t = build_train_step(model, tx_t, grad_accum_steps=accum)(
        state_t, {k: t(v) for k, v in batch.items()}, torch.Generator())
    assert sorted(metrics_t) == sorted(metrics_j) == ["grad_norm", "loss", "moe_gate_loss", "skipped_nonfinite"]
    assert all(v.dim() == 0 for v in metrics_t.values())
    gate_j = float(metrics_j["moe_gate_loss"])
    assert abs(float(metrics_t["moe_gate_loss"]) - gate_j) <= 1e-6 * gate_j
    if accum == 2:  # the mean of the two micro-steps' terms
        with torch.no_grad():
            module = bridge(variables, model.create_module())
            terms = [float(model.loss_fn(module, torch.Generator(), {k: t(v) for k, v in b.items()})[1]
                           ["moe_gate_loss"]) for b in batches]
        assert abs(float(np.mean(terms)) - gate_j) <= 1e-6 * gate_j and terms[0] != terms[1]
    for key in ("loss", "grad_norm"):
        assert abs(float(metrics_t[key]) - float(metrics_j[key])) <= GRAD_REL * abs(float(metrics_j[key])), key


class _StandIn:
    """A text encoder's ``encode`` output, fixed: the packaging is what is compared."""

    def __init__(self, out):
        self.out = out

    def encode(self, prompts):
        return {k: v[:len(prompts)] for k, v in self.out.items()}


def test_encode_text_and_collate_as_jax():
    """Quirk kept (ROADMAP Queue 3): four encoders; the CLIP-L and CLIP-G
    pooled states concatenated; the Llama encoder gives no per-layer states,
    so the final state alone is stacked (one layer); collate drops T5's
    mask; every array equal to the JAX family's."""
    jmodel, model = _pair(_tiny_values())
    rng = np.random.default_rng(3)
    mask = (np.arange(6)[None] < np.asarray([[6], [2], [4]])).astype(np.int32)
    clip_l = {"last_hidden_state": rng.standard_normal((3, 77, 12)).astype(np.float32),
              "attention_mask": mask, "pooled": rng.standard_normal((3, 12)).astype(np.float32)}
    clip_g = {"last_hidden_state": rng.standard_normal((3, 77, 20)).astype(np.float32),
              "attention_mask": mask, "pooled": rng.standard_normal((3, 20)).astype(np.float32)}
    t5 = {"last_hidden_state": rng.standard_normal((3, 6, 32)).astype(np.float32), "attention_mask": mask}
    llama = {"last_hidden_state": rng.standard_normal((3, 6, 32)).astype(np.float32), "attention_mask": mask,
             "pooled": rng.standard_normal((3, 32)).astype(np.float32)}
    for m in (jmodel, model):
        m.attach_text_encoders([_StandIn(clip_l), _StandIn(clip_g), _StandIn(t5), _StandIn(llama)])
    prompts = ["a", "b", "c"]
    ours, theirs = model.encode_text(prompts), jmodel.encode_text(prompts)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["attention_mask", "llama_embeds", "pooled_embeds", "t5_embeds"]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert ours[0]["llama_embeds"].shape == (1, 6, 32) and ours[0]["pooled_embeds"].shape == (32,)
    collated, jcollated = model.collate_text_embeds(ours), jmodel.collate_text_embeds(theirs)
    assert sorted(collated) == sorted(jcollated) == ["llama_embeds", "pooled_embeds", "t5_embeds"]
    for key in collated:
        np.testing.assert_array_equal(collated[key], jcollated[key])


def test_tiny_preset_pooled_width_does_not_fit_its_tiny_clips_as_in_jax():
    """Quirk kept (ROADMAP Queue 3): the tiny arch reads a 32-wide pooled
    vector while the tiny CLIP-L and CLIP-G the tiny preset builds are 32 and
    64 wide (96 concatenated), in both packages; the trainer test widens the
    tiny arch's ``pooled_dim`` (test_torch_hidream_trainer.py)."""
    from simpletuner_tpu_torch.models.clip import CLIPTextConfig
    from simpletuner_tpu_torch.models.text_encoders import load_text_encoders

    assert HiDreamConfig.tiny().pooled_dim == jax_hd.HiDreamConfig.tiny().pooled_dim == 32
    encoders = load_text_encoders(HiDream.TEXT_ENCODER_CONFIGURATION[:2], tiny=True, device="cpu")
    assert [e.model.config.hidden_size for e in encoders] == [32, 64]
    assert CLIPTextConfig.tiny(hidden_size=64).hidden_size == 64


# ---- weight import and the key map ------------------------------------------------------------------


def _jax_params(arch, seed):
    jmodule = jax_hd.HiDreamTransformer(config=_jax_config(arch))
    args = [jnp.zeros(s) for s in ((1, 4, 4, arch.in_channels), (1,), (1, 3, arch.t5_dim), (1, 1, 2, arch.llama_dim),
                                   (1, arch.pooled_dim))]
    return fill_numpy(jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args)), seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's file of a seeded tiny transformer (two shards in
    ``transformer/``): its names and shapes are ``hidream_checkpoint_shapes``,
    the port's tree (the experts' torch (out, in) weights stacked to (E, in,
    out)) is bitwise the JAX ``load_hidream_params`` tree, and the imported
    module bitwise the bridged JAX tree."""
    jmodel, model = _pair(_tiny_values())
    weights = export_hidream_to_diffusers(_jax_params(model.arch, 4), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == hidream_checkpoint_shapes(model.arch)
    root = tmp_path / "hd" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_hidream_params(jmodel, str(tmp_path / "hd"))
    ours = load_hidream_params(model, str(tmp_path / "hd"))
    assert tuple(ours["double_0"]["ff_i"]["experts_w2"].shape) == (2, model.arch.ffn_inner, model.arch.hidden_size)
    _assert_trees_bitwise(ours, theirs)
    module = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "hd"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(module.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_key_map_adapters_and_default_targets_match_jax(tmp_path):
    """``hidream_key_map`` equal to the JAX map; an adapter file round-trips
    through the port's loader bitwise and loads into the JAX template; quirk
    kept (ROADMAP Queue 3): the routed experts are plain parameters with no
    adapter, and without ``lora_target_modules`` every adapter-carrying
    linear is adapted, the caption projections, the shared experts and
    ``ff_t`` included."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    assert _key_map_for(model) == jax_hidream_key_map(jmodel.arch) == hidream_key_map(model.arch)
    every = {name.rsplit("/", 1)[0] for name in tl.lora_parameters(model.create_module())}
    assert {"caption_proj_0", "caption_proj_t5", "double_0/ff_t/w1", "single_0/ff_i/shared_experts/w2",
            "patch_in", "final_proj"} <= every
    assert not any("experts_w" in name or name.endswith(("ada", "final_mod")) for name in every)
    source = _seeded_adapters(model, 4, scale=0.05)
    path = str(tmp_path / "adapter.safetensors")
    save_lora_safetensors(model, source, path)
    target = model.create_module()
    assert load_lora_safetensors(model, path, target) == []
    for (name, a), b in zip(tl.lora_parameters(target).items(), tl.lora_parameters(source).values()):
        assert torch.equal(a, b), name
    args = [jnp.zeros(s) for s in ((1, 4, 4, 4), (1,), (1, 3, 32), (1, 1, 2, 32), (1, 32))]
    template = numpy_variables(jmodel.create_module(), *args, seed=1)["lora"]
    loaded = jax_load_lora(jmodel, path, template)
    loaded = loaded[0] if isinstance(loaded, tuple) else loaded
    for name, param in tl.lora_parameters(source).items():
        node = loaded
        for part in name.split("/"):
            node = node[part]
        assert np.array_equal(np.asarray(node), param.detach().numpy().T), name
