"""The torch port's Cosmos3 MoT family against the JAX package, on the CPU.

The presets (the published 15.2B against the JAX ``eval_shape``), the
interleaved mRoPE at the real temporal offset (the vision t ids past
15,064), patchify / unpatchify and the position ids, one MoT layer and the
whole transformer with its LoRA gradients against ``jax.grad`` (with and
without ``noisy_mask``, remat) and in bf16 (the vision prediction and the
logits); the family contract (the inputs, sigma x 1000 per token, the
prediction, the collate, ``encode_text`` through the salted-hash fallback
within one process and through a seeded word-level tokenizer); LoRA
gradients on the default targets and AdamW steps through
``build_train_step`` against the JAX step; ``Trainer.run()`` and the render
stopping at the missing 48-channel video VAE in both packages; the import of
the JAX exporter's file bitwise, the key map and an adapter file.  The
reasoner and the replay are in test_torch_cosmos3_reasoner.py, the AVAE in
test_torch_cosmos3_audio.py.  Every tolerance is stated where it is checked.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.cosmos3 import transformer as jct
from simpletuner_tpu.models.cosmos3.model import Cosmos3 as JaxCosmos3
from simpletuner_tpu.models.weight_export import export_cosmos3_to_checkpoint
from simpletuner_tpu.models.weight_import import load_cosmos3_params as jax_load_params
from simpletuner_tpu.training.lora import _KEY_MAPS as JAX_KEY_MAPS
from simpletuner_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from simpletuner_tpu.training.train_state import build_train_step as jax_build_train_step
from simpletuner_tpu.training.train_state import create_train_state as jax_create_train_state

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.checkpoint_layouts import cosmos3_checkpoint_shapes
from simpletuner_tpu_torch.models.cosmos3 import Cosmos3, Cosmos3Config, Cosmos3OmniTransformer
from simpletuner_tpu_torch.models.cosmos3 import transformer as tct
from simpletuner_tpu_torch.models.registry import PORTED, get_model_family
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params, lora_to_flax
from simpletuner_tpu_torch.models.weight_import import load_cosmos3_params, load_transformer_params
from simpletuner_tpu_torch.training.lora import _key_map_for, cosmos3_key_map
from simpletuner_tpu_torch.training.optimizers import get_optimizer
from simpletuner_tpu_torch.training.train_state import build_train_step, create_train_state

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# f32 LoRA gradients (test_torch_sdxl.py: f32 gradients through a deep net
# are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
# bf16 on both sides: each rounds its own intermediates (the port also
# rounds q and k to bf16 after the rope, for the kernels)
BF16_REL = 2e-2
# torch's and XLA's f32 cos and sin of the same f32 angle (up to 15,100
# radians at the vision ids' temporal offset) differ by a few ulps of 1.0
ROPE_ATOL = 2.0 ** -20


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
    return {"model_family": "cosmos3", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxCosmos3(JaxTrainingConfig(values)), Cosmos3(config_namespace(values))


def _prepared(cfg, seed=0, txt_len=6, frames=2, height=4, width=6, batch=2):
    rng = np.random.default_rng(seed)
    return {"noisy_latents": rng.standard_normal((batch, frames, height, width, cfg.latent_channel)).astype(np.float32),
            "timesteps": rng.uniform(0.05, 0.95, batch).astype(np.float32),
            "text_ids": rng.integers(0, cfg.vocab_size, (batch, txt_len)).astype(np.int32)}


def _inputs(jmodel, seed=0, noisy_mask=False, **grid):
    """The module inputs of the JAX family for seeded latents, ids and sigmas
    (tokenwise sigmas in place of the broadcast ones, and a 0/1 noisy mask)."""
    prepared = _prepared(jmodel.arch, seed, **grid)
    inputs = {k: np.asarray(v) for k, v in jmodel.get_model_inputs(
        {k: jnp.asarray(v) for k, v in prepared.items()}).items()}
    rng = np.random.default_rng(seed + 1)
    inputs["timesteps"] = rng.uniform(0.0, 1000.0, inputs["timesteps"].shape).astype(np.float32)
    if noisy_mask:
        inputs["noisy_mask"] = (rng.uniform(size=inputs["timesteps"].shape) < 0.6).astype(np.float32)
    return inputs


def _variables(jmodule, jmodel, seed, noisy_mask=False):
    example = {k: jnp.asarray(v) for k, v in _inputs(jmodel, noisy_mask=noisy_mask).items()}
    return numpy_variables(jmodule, **example, seed=seed)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_presets_and_contract_match_jax():
    """The presets (tiny and published: 4096 wide, 36 layers of 385.9M for
    both pathways, the 151,936-row table and head; 15.2B parameters in the
    checkpoint layout, as the JAX ``eval_shape``), the family's constants
    and example batch; a non-flow prediction type and the intermediates tap
    are refused; the registry builds it."""
    jmodel, model = _pair(_tiny_values())
    for attr in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "MODALITY", "DEFAULT_RESOLUTION", "DEFAULT_FLAVOUR",
                 "HUGGINGFACE_PATHS", "DEFAULT_LORA_TARGET", "LATENT_CHANNEL_COUNT", "TEXT_ENCODER_CONFIGURATION"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    for ours, theirs in ((Cosmos3Config.tiny(), jct.Cosmos3Config.tiny()), (Cosmos3Config(), jct.Cosmos3Config())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.patch_latent_dim == theirs.patch_latent_dim
    full = Cosmos3(config_namespace({**_tiny_values(), "model_arch_preset": None})).arch
    shapes = cosmos3_checkpoint_shapes(full)
    per_layer = sum(math.prod(s) for k, s in shapes.items() if k.startswith("layers.0."))
    assert per_layer == 385_892_864 and full.patch_latent_dim == 192
    spec = {"text_ids": ((1, 4), jnp.int32), "vision_tokens": ((1, 4, 192), jnp.float32),
            "position_ids": ((1, 3, 8), jnp.int32), "timesteps": ((1, 4), jnp.float32)}
    tree = jax.eval_shape(lambda: jct.Cosmos3OmniTransformer(config=jct.Cosmos3Config()).init(
        jax.random.PRNGKey(0), **{k: jnp.zeros(*v) for k, v in spec.items()}))
    total = sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree))
    assert sum(math.prod(s) for s in shapes.values()) == total == 15_156_222_144
    assert "cosmos3" in PORTED and isinstance(get_model_family(config_namespace(_tiny_values())), Cosmos3)
    with pytest.raises(ValueError, match="flow-matching"):
        Cosmos3(config_namespace(_tiny_values(prediction_type="epsilon"))).check_user_config()
    with pytest.raises(NotImplementedError, match="item 4h"):
        model.model_predict_with_intermediates(None, {})
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.example_batch(2, 64).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.example_batch(2, 64).items()}
    assert model.latent_channels == jmodel.latent_channels == 2


def test_mrope_matches_jax_at_the_vision_offset():
    """The interleaved mRoPE at the published head dim 128 (sections (24,
    20, 20), theta 5e6) over the family's ids for 64 text tokens and a 5 x 44
    x 80 latent grid: text (i, i, i), vision t ids 15,064 + t (angles near
    15,068 radians), h and w restarting at 0; the H / W selections and the
    float64 ``inv_freq`` rounded to f32 bitwise the JAX ones, cos and sin
    within ``ROPE_ATOL``."""
    jmodel, model = _pair(_tiny_values())
    cfg, jcfg = Cosmos3Config(), jct.Cosmos3Config()
    ids = jct.cosmos3_position_ids(jcfg, 64, 5, 44, 80)
    ours = model.position_ids(64, 5, 44, 80, "cpu")
    assert np.array_equal(ours.numpy(), ids) and ours.dtype == torch.int32
    assert ids[0, 64] == 15064 and ids[0].max() == 15068 and ids[1, 64:].max() == 21 and ids[2, 64:].max() == 39
    constants = tct.mrope_constants(cfg)
    expected = (1.0 / (cfg.rope_theta ** (np.arange(0, 128, 2, dtype=np.float64) / 128))).astype(np.float32)
    assert np.array_equal(constants[0], expected) and constants[1].sum() == 20 and constants[2].sum() == 20
    batch = np.stack([ids, ids])
    cos, sin = tct.cosmos3_mrope(cfg, t(batch))
    jcos, jsin = jax.jit(jct.cosmos3_mrope, static_argnums=0)(jcfg, jnp.asarray(batch))
    for a, b in ((cos, jcos), (sin, jsin)):
        assert a.shape == (2, ids.shape[1], 128) and np.abs(a.numpy() - np.asarray(b)).max() <= ROPE_ATOL


def test_patchify_unpatchify_and_position_ids_match_jax():
    """``cosmos3_patchify`` in (t, h, w, p, q, c) order and its inverse
    bitwise the JAX functions; the position ids of a grid equal."""
    rng = np.random.default_rng(1)
    latents = rng.standard_normal((2, 3, 4, 6, 5)).astype(np.float32)
    ours, theirs = tct.cosmos3_patchify(t(latents)), jct.cosmos3_patchify(jnp.asarray(latents))
    assert ours.shape == (2, 18, 20) and np.array_equal(ours.numpy(), np.asarray(theirs))
    back = tct.cosmos3_unpatchify(ours, 3, 4, 6)
    assert np.array_equal(back.numpy(), latents)
    assert np.array_equal(back.numpy(), np.asarray(jct.cosmos3_unpatchify(theirs, 3, 4, 6)))
    for grid in ((7, 2, 4, 6), (0, 1, 2, 2), (64, 5, 44, 80)):
        assert np.array_equal(tct.cosmos3_position_ids(Cosmos3Config(), *grid),
                              jct.cosmos3_position_ids(jct.Cosmos3Config(), *grid))


def test_mot_layer_matches_jax():
    """One MoT layer (f32, rank-4 adapters on both pathways) on seeded
    streams: the und and gen outputs within ``F32_REL`` of the JAX layer."""
    cfg = Cosmos3Config.tiny()
    rng = np.random.default_rng(2)
    und, gen = (rng.standard_normal((2, n, cfg.hidden_size)).astype(np.float32) for n in (5, 12))
    ids = np.stack([jct.cosmos3_position_ids(jct.Cosmos3Config.tiny(), 5, 3, 4, 4)] * 2)
    jcos, jsin = jax.jit(jct.cosmos3_mrope, static_argnums=0)(jct.Cosmos3Config.tiny(), jnp.asarray(ids))
    rope_u, rope_g = (jcos[:, :5], jsin[:, :5]), (jcos[:, 5:], jsin[:, 5:])
    jlayer = jct.Cosmos3MoTLayer(jct.Cosmos3Config.tiny(), dtype=jnp.float32, lora_rank=4)
    variables = numpy_variables(jlayer, jnp.asarray(und), jnp.asarray(gen), rope_u, rope_g, seed=3)
    ref_u, ref_g = jax.jit(jlayer.apply)(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(und),
                                         jnp.asarray(gen), rope_u, rope_g)
    port = bridge(variables, tct.Cosmos3MoTLayer(cfg, torch.float32, lora_rank=4))
    with torch.no_grad():
        out_u, out_g = port(t(und), t(gen), *(t(np.asarray(a)) for a in rope_u + rope_g))
    assert rel(out_u.numpy(), ref_u) < F32_REL and rel(out_g.numpy(), ref_g) < F32_REL


@pytest.mark.parametrize("variant", ["plain", "noisy_mask", "remat"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny MoT (f32, rank-4 adapters everywhere) on the family's inputs
    with tokenwise sigmas: the vision prediction and the logits within
    ``F32_REL``; the LoRA gradients of a seeded projection of both against
    ``jax.grad`` within ``GRAD_REL``, per adapter (the time MLP and
    ``lm_head`` have none in either package)."""
    jmodel, model = _pair(_tiny_values())
    remat, mask = variant == "remat", variant == "noisy_mask"
    inputs = _inputs(jmodel, seed=4, noisy_mask=mask)
    jmodule = jct.Cosmos3OmniTransformer(config=jct.Cosmos3Config.tiny(), dtype=jnp.float32, lora_rank=4, remat=remat)
    variables = _variables(jmodule, jmodel, seed=5, noisy_mask=mask)
    port = bridge(variables, Cosmos3OmniTransformer(model.arch, dtype=torch.float32, lora_rank=4, remat=remat))
    rng = np.random.default_rng(6)
    w_pred = rng.standard_normal(inputs["vision_tokens"].shape).astype(np.float32)
    w_logits = rng.standard_normal(inputs["text_ids"].shape + (model.arch.vocab_size,)).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jargs = {k: jnp.asarray(v) for k, v in inputs.items()}

    def jax_loss(lora):
        pred, logits = jmodule.apply({"params": params, "lora": lora}, **jargs)
        return jnp.sum(pred * w_pred) + jnp.sum(logits * w_logits), (pred, logits)

    (_, (ref_pred, ref_logits)), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["lora"]))
    adapters = tl.freeze_base(port)
    pred, logits = port(**{k: t(v) for k, v in inputs.items()})
    assert rel(pred.detach().numpy(), ref_pred) < F32_REL and rel(logits.detach().numpy(), ref_logits) < F32_REL
    ((pred * t(w_pred)).sum() + (logits * t(w_logits)).sum()).backward()
    flat = _flat(grads)
    assert sorted(flat) == sorted(adapters) and "layer_1/mlp_moe_gen/down_proj/lora_B" in flat
    assert not any(k.startswith(("time_in", "lm_head")) for k in flat)
    for path, param in adapters.items():
        assert rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


@pytest.mark.parametrize("noisy_mask", [False, True])
def test_transformer_bf16_matches_jax(noisy_mask):
    """The tiny MoT in bf16 (f32 adapters, norms and table) against the JAX
    module in bf16: the vision prediction and the logits within ``BF16_REL``."""
    jmodel, model = _pair(_tiny_values())
    inputs = _inputs(jmodel, seed=7, noisy_mask=noisy_mask)
    jmodule = jct.Cosmos3OmniTransformer(config=jct.Cosmos3Config.tiny(), dtype=jnp.bfloat16, lora_rank=4)
    variables = _variables(jmodule, jmodel, seed=8, noisy_mask=noisy_mask)
    port = bridge(variables, Cosmos3OmniTransformer(model.arch, dtype=torch.bfloat16, lora_rank=4))
    ref_pred, ref_logits = jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                  **{k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        pred, logits = port(**{k: t(v) for k, v in inputs.items()})
    assert pred.dtype == logits.dtype == torch.float32
    assert rel(pred.numpy(), ref_pred) < BF16_REL and rel(logits.numpy(), ref_logits) < BF16_REL


def _write_tokenizer(root, vocab_size):
    """A word-level tokenizer at the model dir's root (where the family reads it)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ["<pad>", "<unk>"] + [f"w{i}" for i in range(vocab_size - 2)]
    tokenizer = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tokenizer.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    root.mkdir(parents=True)
    tokenizer.save(str(root / "tokenizer.json"))
    (root / "tokenizer_config.json").write_text(json.dumps(
        {"model_max_length": 512, "unk_token": "<unk>", "pad_token": "<pad>",
         "tokenizer_class": "PreTrainedTokenizerFast"}))


def test_family_inputs_prediction_and_text_match_jax(tmp_path):
    """``get_model_inputs`` (the ids, the patchified latents, the (B, 3, S)
    ids, sigma x 1000 on every generation token) equal to the JAX family's;
    the unpatchified prediction within ``F32_REL``; ``encode_text`` at 64
    ids with the JAX payload (its mask all ones: the pads are counted), from
    the salted ``hash`` of each word (equal within one process) and from a
    seeded word-level tokenizer in a local model dir; the collate keeps only
    ``text_ids``; ``inference_conditioning`` the ids."""
    jmodel, model = _pair(_tiny_values())
    prepared = _prepared(model.arch, seed=9)
    ours = model.get_model_inputs({k: t(v) for k, v in prepared.items()})
    theirs = jmodel.get_model_inputs({k: jnp.asarray(v) for k, v in prepared.items()})
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    assert float(ours["timesteps"][0, 0]) == pytest.approx(1000.0 * float(prepared["timesteps"][0]))
    variables = _variables(jmodel.create_module(), jmodel, seed=10)
    module = bridge(variables, model.create_module())
    with torch.no_grad():
        out = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).numpy()
    ref = np.asarray(jax.jit(jmodel.model_predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                                   jax.tree_util.tree_map(jnp.asarray, prepared)))
    assert out.shape == ref.shape == (2, 2, 4, 6, 2) and rel(out, ref) < F32_REL
    prompts = ["w3 w40 w5 " + " ".join(f"w{i}" for i in range(70)), "w1 w2", ""]
    for directory in (None, tmp_path / "cosmos3"):
        values = _tiny_values()
        if directory is not None:
            _write_tokenizer(directory, 62)
            values["pretrained_model_name_or_path"] = str(directory)
        jm, m = _pair(values)
        mine, jax_payloads = m.encode_text(prompts), jm.encode_text(prompts)
        assert (m._tokenizer is None) == (directory is None)
        for a, b in zip(mine, jax_payloads):
            assert sorted(a) == sorted(b) == ["attention_mask", "text_ids"]
            assert a["text_ids"].shape == (64,) and a["text_ids"].dtype == np.int32
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert mine[2]["attention_mask"].sum() == 64 and not mine[2]["text_ids"].any()
        collated, jcollated = m.collate_text_embeds(mine), jm.collate_text_embeds(jax_payloads)
        assert sorted(collated) == sorted(jcollated) == ["text_ids"]
        np.testing.assert_array_equal(collated["text_ids"], jcollated["text_ids"])
    assert mine[1]["text_ids"][:3].tolist() == [3, 4, 0]  # the tokenizer's ids of "w1 w2", then the pads
    assert sorted(model.inference_conditioning(prepared)) == sorted(jmodel.inference_conditioning(prepared)) == \
        ["text_ids"]


# ---- LoRA on the default targets and the train step ----------------------------------------------

STEPS = 3


def _train_values(**extra):
    return _tiny_values(lora_target_modules=list(Cosmos3.DEFAULT_LORA_TARGET), optimizer="adamw",
                        learning_rate=1e-3, adam_weight_decay=0.01, max_grad_norm=1.0, lr_scheduler="constant",
                        max_train_steps=STEPS, **extra)


def _batches(cfg, seed=11):
    rng = np.random.default_rng(seed)
    base = {"latents": rng.standard_normal((2, 2, 4, 6, cfg.latent_channel)).astype(np.float32),
            "text_ids": rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)}
    return [{**base, "override_noise": rng.standard_normal(base["latents"].shape).astype(np.float32),
             "override_sigmas": rng.uniform(0.05, 0.95, 2).astype(np.float32)} for _ in range(STEPS)]


def test_default_target_grads_and_adamw_steps_match_jax():
    """With ``lora_target_modules`` the family's ``DEFAULT_LORA_TARGET``
    (``attn_gen_q/k/v/out``; read by no code in either package, so a run
    names them): both packages adapt the same 8 modules; ``loss_fn``'s LoRA
    gradients against ``jax.grad`` within ``GRAD_REL``; 3 AdamW steps through
    ``build_train_step`` against the JAX step (loss and grad norm within
    ``GRAD_REL`` each step, the adapters after them within ``GRAD_REL``)."""
    values = _train_values()
    jmodel, model = _pair(values)
    batches = _batches(model.arch)
    plain = {k: v for k, v in batches[0].items()}
    variables = fill_numpy(jax.eval_shape(lambda: jmodel.init_params(
        jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, plain))), seed=12)
    module = bridge(variables, model.create_module())
    adapters = tl.freeze_base(module)
    assert sorted(adapters) == sorted(_flat(variables["lora"]))
    assert sorted({p.rsplit("/", 1)[0] for p in adapters}) == sorted(
        f"layer_{i}/attn_gen_{n}" for i in range(2) for n in ("q", "k", "v", "out"))

    def jax_loss(lora):
        return jmodel.loss_fn({"params": variables["params"], "lora": lora}, jax.random.PRNGKey(0),
                              jax.tree_util.tree_map(jnp.asarray, plain))[0]

    jgrads = _flat(jax.jit(jax.grad(jax_loss))(jax.tree_util.tree_map(jnp.asarray, variables["lora"])))
    loss, _ = model.loss_fn(module, torch.Generator(), {k: t(v) for k, v in plain.items()})
    loss.backward()
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
        for key in ("loss", "grad_norm"):
            assert abs(float(m_t[key]) - float(m_j[key])) <= GRAD_REL * abs(float(m_j[key])), (i, key)
        assert float(m_t["skipped_nonfinite"]) == 0.0
    final_j, final_t = _flat(state_j.trainable["lora"]), _flat(lora_to_flax(state_t.module))
    assert sorted(final_j) == sorted(final_t)
    for key in final_j:
        assert rel(final_t[key], final_j[key]) < GRAD_REL, key


def test_trainer_and_render_stop_at_the_video_vae_in_both_packages(tmp_path):
    """Quirk kept (ROADMAP Queue 3): cosmos3 is a video family without a
    ``video_vae_config`` in the JAX package (neither package has a 48-channel
    video VAE), so both ``Trainer.run()`` stop in ``init_preprocessing_models``
    at ``_init_vae`` (JAX: AttributeError; the port names the reason) and
    both validation renders at the latent shape."""
    import traceback

    from simpletuner_tpu.training.trainer import Trainer as JaxTrainer
    from simpletuner_tpu.training.validation import Validation as JaxValidation

    from simpletuner_tpu_torch.training.trainer import Trainer
    from simpletuner_tpu_torch.training.validation import Validation

    from test_torch_trainer import _values, _write_images

    _write_images(tmp_path / "data")
    values = lambda out: _values(tmp_path, out, model_family="cosmos3", max_train_steps=2)  # noqa: E731
    jax_trainer = JaxTrainer(config=JaxTrainingConfig(values("jax")))
    with pytest.raises(AttributeError, match="video_vae_config") as jax_error:
        jax_trainer.run()
    port_trainer = Trainer(config=values("port"), device="cpu")
    with pytest.raises(NotImplementedError, match="48 latent channels") as port_error:
        port_trainer.run()
    for error in (jax_error, port_error):
        frames = [frame.name for frame in traceback.extract_tb(error.value.__traceback__)]
        assert frames[frames.index("init_preprocessing_models") + 1] == "_init_vae", frames
    assert not hasattr(jax_trainer, "vae_params") or jax_trainer.vae_params is None
    assert port_trainer.stage_report == {} or "init_preprocessing_models" not in port_trainer.stage_report
    render = _tiny_values(validation_prompt="w1 w2", validation_num_inference_steps=2)
    jmodel, model = _pair(render)
    with pytest.raises(AttributeError, match="video_vae_config"):
        JaxValidation(jmodel, JaxTrainingConfig(render))._latent_shape(1)
    with pytest.raises(NotImplementedError, match="48 latent channels"):
        Validation(model, config_namespace(render), device="cpu")._latent_shape(1)


# ---- import, key map, adapter files -------------------------------------------------------------


def _jax_params(jmodel, seed):
    example = {k: jnp.asarray(v) for k, v in _inputs(jmodel).items()}
    shapes = jax.eval_shape(lambda: jmodel.create_module().init(jax.random.PRNGKey(0), **example))
    return fill_numpy(shapes, seed)["params"]


def test_import_matches_jax_bitwise(tmp_path):
    """The JAX exporter's file of a seeded tiny MoT (two shards): its names
    and shapes are the port's layout, the port's tree bitwise the JAX
    ``load_cosmos3_params`` tree, the imported module bitwise the bridged
    JAX tree."""
    jmodel, model = _pair(_tiny_values())
    weights = export_cosmos3_to_checkpoint(_jax_params(jmodel, 13), jmodel.arch)
    assert {k: tuple(v.shape) for k, v in weights.items()} == cosmos3_checkpoint_shapes(model.arch)
    root = tmp_path / "cosmos3" / "transformer"
    root.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: np.ascontiguousarray(weights[k]) for k in part},
                     str(root / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    theirs = jax_load_params(jmodel, str(tmp_path / "cosmos3"))
    _assert_trees_bitwise(load_cosmos3_params(model, str(tmp_path / "cosmos3")), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), str(tmp_path / "cosmos3"))
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name


def test_key_map_and_adapter_file_match_jax(tmp_path):
    """``cosmos3_key_map`` equals the JAX map (both pathways, ``proj_in`` and
    ``proj_out`` under their own names); an adapter file written by the port
    round-trips bitwise and loads into the JAX template bitwise."""
    from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora

    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    from test_torch_chroma_trainer import _seeded_adapters

    jmodel, model = _pair(_tiny_values())
    assert _key_map_for(model) == JAX_KEY_MAPS["cosmos3"](jmodel) == cosmos3_key_map(model.arch)
    assert _key_map_for(model)["layer_1/mlp_moe_gen/up_proj"] == "layers.1.mlp_moe_gen.up_proj"
    source = _seeded_adapters(model, 4, scale=0.05)
    path = str(tmp_path / "adapter.safetensors")
    save_lora_safetensors(model, source, path)
    target = model.create_module()
    assert load_lora_safetensors(model, path, target) == []
    for (name, a), b in zip(tl.lora_parameters(target).items(), tl.lora_parameters(source).values()):
        assert torch.equal(a, b), name
    template = _variables(jmodel.create_module(), jmodel, seed=1)["lora"]
    loaded = jax_load_lora(jmodel, path, template)
    loaded = loaded[0] if isinstance(loaded, tuple) else loaded
    for name, param in tl.lora_parameters(source).items():
        node = loaded
        for part in name.split("/"):
            node = node[part]
        assert np.array_equal(np.asarray(node), param.detach().numpy().T), name
