"""The torch port's Cosmos3 frozen reasoner and the generator-only replay
against the JAX package, on the CPU.

The config and its MoT counterpart; a reasoner layer (the hidden state and
the (roped k, raw v) pair) and the whole stack's memory in f32 and bf16;
the importer (from a component file and from the MoT file, whose
understanding pathway has the same names) bitwise the JAX one; the replay
of a fixed memory against the JAX replay; the replay identity (the
reasoner's memory from the MoT's own weights and ids, replayed, equals the
full MoT forward at every layer: first in the JAX package, then in the
port) and the replay's refusals.  Every tolerance is stated where it is
checked.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.cosmos3 import reasoner as jcr
from simpletuner_tpu.models.cosmos3 import transformer as jct
from simpletuner_tpu.models.weight_export import export_cosmos3_to_checkpoint

from simpletuner_tpu_torch.models.cosmos3 import reasoner as tcr
from simpletuner_tpu_torch.models.cosmos3 import transformer as tct

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums differs
F32_REL = 1e-5
# bf16 on both sides: each rounds its own intermediates
BF16_REL = 2e-2

UND, FRAMES, HEIGHT, WIDTH = 6, 2, 4, 6


@pytest.fixture(autouse=True)
def _restore_jax_globals():
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jl.set_lora_target(None)
    yield
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])


def _grid(seed=0, batch=2):
    """Seeded ids, patchified latents, the (B, 3, S) ids and tokenwise sigma x 1000."""
    cfg = jct.Cosmos3Config.tiny()
    rng = np.random.default_rng(seed)
    gen = FRAMES * (HEIGHT // 2) * (WIDTH // 2)
    pos = jct.cosmos3_position_ids(cfg, UND, FRAMES, HEIGHT, WIDTH).astype(np.int32)
    return {"text_ids": rng.integers(0, cfg.vocab_size, (batch, UND)).astype(np.int32),
            "vision_tokens": rng.standard_normal((batch, gen, cfg.patch_latent_dim)).astype(np.float32),
            "position_ids": np.ascontiguousarray(np.broadcast_to(pos[None], (batch, 3, pos.shape[1]))),
            "timesteps": rng.uniform(0.0, 1000.0, (batch, gen)).astype(np.float32)}


@pytest.fixture(scope="module")
def mot():
    """The JAX tiny MoT's seeded f32 params (shared by the tests)."""
    inputs = {k: jnp.asarray(v) for k, v in _grid().items()}
    module = jct.Cosmos3OmniTransformer(config=jct.Cosmos3Config.tiny(), dtype=jnp.float32)
    return fill_numpy(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), **inputs)), seed=1)["params"]


def _reasoner_tree(params):
    """The MoT's understanding pathway under the reasoner's names."""
    tree = {"embed_tokens": params["embed_tokens"]}
    for i in range(jct.Cosmos3Config.tiny().num_layers):
        layer = params[f"layer_{i}"]
        tree[f"layer_{i}"] = {
            "to_q": layer["attn_und_q"], "to_k": layer["attn_und_k"], "to_v": layer["attn_und_v"],
            "to_out": layer["attn_und_out"], "norm_q": layer["norm_q"], "norm_k": layer["norm_k"],
            "input_layernorm": layer["input_layernorm"], "post_attention_layernorm": layer["post_attention_layernorm"],
            **layer["mlp"]}
    return tree


def test_config_matches_jax():
    """Both presets and ``as_transformer_config`` equal the JAX ones."""
    for ours, theirs in ((tcr.Cosmos3ReasonerConfig.tiny(), jcr.Cosmos3ReasonerConfig.tiny()),
                         (tcr.Cosmos3ReasonerConfig(), jcr.Cosmos3ReasonerConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert dataclasses.asdict(ours.as_transformer_config()) == dataclasses.asdict(theirs.as_transformer_config())


def test_layer_matches_jax():
    """A reasoner layer (f32): the hidden state and the roped k / raw v
    within ``F32_REL`` of the JAX layer's."""
    cfg = jcr.Cosmos3ReasonerConfig.tiny()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, UND, cfg.hidden_size)).astype(np.float32)
    ids = _grid()["position_ids"][:, :, :UND]
    jcos, jsin = jax.jit(jct.cosmos3_mrope, static_argnums=0)(cfg.as_transformer_config(), jnp.asarray(ids))
    jlayer = jcr.Cosmos3ReasonerLayer(cfg, dtype=jnp.float32)
    variables = numpy_variables(jlayer, jnp.asarray(x), jcos, jsin, seed=3)
    ref_x, (ref_k, ref_v) = jax.jit(jlayer.apply)(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x),
                                                  jcos, jsin)
    port = bridge(variables, tcr.Cosmos3ReasonerLayer(tcr.Cosmos3ReasonerConfig.tiny(), torch.float32))
    with torch.no_grad():
        out_x, (k, v) = port(t(x), t(np.asarray(jcos)), t(np.asarray(jsin)))
    for a, b in ((out_x, ref_x), (k, ref_k), (v, ref_v)):
        assert a.shape == b.shape and rel(a.numpy(), b) < F32_REL


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_memory_matches_jax(mot, dtype):
    """The stack over seeded ids: one (k, v) pair per layer, k roped (B, S,
    kv, D), within ``F32_REL`` (f32) or ``BF16_REL`` (bf16) of the JAX
    memory."""
    jdtype, tdtype, tol = (jnp.float32, torch.float32, F32_REL) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16, BF16_REL)
    grid = _grid(seed=4)
    ids, pos = grid["text_ids"], grid["position_ids"][:, :, :UND]
    tree = {"params": _reasoner_tree(mot)}
    jmodule = jcr.Cosmos3Reasoner(jcr.Cosmos3ReasonerConfig.tiny(), dtype=jdtype)
    ref = jax.jit(jmodule.apply)(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(ids), jnp.asarray(pos))
    port = bridge(tree, tcr.Cosmos3Reasoner(tcr.Cosmos3ReasonerConfig.tiny(), tdtype))
    with torch.no_grad():
        memory = port(t(ids), t(pos))
    assert len(memory) == len(ref) == 2
    for (k, v), (rk, rv) in zip(memory, ref):
        assert k.shape == (2, UND, 1, 16) and v.shape == rv.shape
        assert rel(k.float().numpy(), rk) < tol and rel(v.float().numpy(), rv) < tol


def test_import_matches_jax_bitwise_from_both_files(tmp_path, mot):
    """A reasoner component file (``layers.N.self_attn.to_q``, ``mlp.*``)
    and the MoT file written by the JAX exporter: the port's
    ``load_cosmos3_reasoner`` tree bitwise the JAX one from each, and the
    MoT file's tree bitwise the component file's."""
    cfg = jcr.Cosmos3ReasonerConfig.tiny()
    weights = export_cosmos3_to_checkpoint(mot, jct.Cosmos3Config.tiny())
    mot_path, part_path = str(tmp_path / "mot.safetensors"), str(tmp_path / "reasoner.safetensors")
    np_save_file({k: np.ascontiguousarray(v) for k, v in weights.items()}, mot_path)
    component = {k: v for k, v in weights.items()
                 if k == "embed_tokens.weight" or (k.startswith("layers.") and ".add_" not in k
                                                   and "moe_gen" not in k and "norm_added" not in k
                                                   and "to_add_out" not in k)}
    np_save_file({k: np.ascontiguousarray(v) for k, v in component.items()}, part_path)
    trees = []
    for path in (part_path, mot_path):
        ours = tcr.load_cosmos3_reasoner(tcr.Cosmos3ReasonerConfig.tiny(), path)
        _assert_trees_bitwise(ours, jcr.load_cosmos3_reasoner(cfg, path))
        trees.append(ours)
    _assert_trees_bitwise(trees[1], trees[0])
    module = tcr.Cosmos3Reasoner(tcr.Cosmos3ReasonerConfig.tiny(), torch.float32)
    from simpletuner_tpu_torch.models.weight_bridge import load_flax_params

    load_flax_params(module, trees[1]["params"])
    assert torch.equal(module.layer_1.to_q.weight, torch.from_numpy(weights["layers.1.self_attn.to_q.weight"]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_replay_of_a_fixed_memory_matches_jax(mot, dtype):
    """``reasoner_kv`` of seeded (k, v) pairs (the JAX test's oracle case):
    the und pathway skipped, no logits, ``text_ids`` None; the vision
    prediction within ``F32_REL`` / ``BF16_REL`` of the JAX replay."""
    jdtype, tdtype, tol = (jnp.float32, torch.float32, F32_REL) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16, BF16_REL)
    grid = _grid(seed=5)
    rng = np.random.default_rng(6)
    memory = tuple((rng.standard_normal((2, UND, 1, 16)).astype(np.float32),
                    rng.standard_normal((2, UND, 1, 16)).astype(np.float32)) for _ in range(2))
    args = {k: grid[k] for k in ("vision_tokens", "position_ids", "timesteps")}
    jmodule = jct.Cosmos3OmniTransformer(config=jct.Cosmos3Config.tiny(), dtype=jdtype)
    ref, ref_logits = jax.jit(lambda p, kv, **a: jmodule.apply(p, None, reasoner_kv=kv, **a))(
        {"params": jax.tree_util.tree_map(jnp.asarray, mot)}, jax.tree_util.tree_map(jnp.asarray, memory),
        **{k: jnp.asarray(v) for k, v in args.items()})
    port = bridge({"params": mot}, tct.Cosmos3OmniTransformer(tct.Cosmos3Config.tiny(), dtype=tdtype))
    with torch.no_grad():
        pred, logits = port(None, reasoner_kv=[(t(k), t(v)) for k, v in memory], **{k: t(v) for k, v in args.items()})
    assert logits is None and ref_logits is None and rel(pred.numpy(), ref) < tol


def test_replay_identity_holds_in_jax_and_in_the_port(mot):
    """The reasoner's memory over the MoT's own ids and understanding
    weights, replayed, equals the full MoT forward at every layer (2 here):
    in the JAX package bitwise (its test's docstring says only layer 0
    holds; it holds at every layer), and in the port bitwise (f32); the
    port's full forward within ``F32_REL`` of the JAX one."""
    grid = _grid(seed=7)
    args = {k: grid[k] for k in ("vision_tokens", "position_ids", "timesteps")}
    params = jax.tree_util.tree_map(jnp.asarray, {"params": mot})
    jmodule = jct.Cosmos3OmniTransformer(config=jct.Cosmos3Config.tiny(), dtype=jnp.float32)
    jreasoner = jcr.Cosmos3Reasoner(jcr.Cosmos3ReasonerConfig.tiny(), dtype=jnp.float32)
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    full, _ = jax.jit(jmodule.apply)(params, jnp.asarray(grid["text_ids"]), **jargs)
    jmemory = jax.jit(jreasoner.apply)({"params": jax.tree_util.tree_map(jnp.asarray, _reasoner_tree(mot))},
                                       jnp.asarray(grid["text_ids"]), jnp.asarray(grid["position_ids"][:, :, :UND]))
    replay, _ = jax.jit(lambda p, kv, **a: jmodule.apply(p, None, reasoner_kv=kv, **a))(params, jmemory, **jargs)
    assert np.array_equal(np.asarray(replay), np.asarray(full))

    port = bridge({"params": mot}, tct.Cosmos3OmniTransformer(tct.Cosmos3Config.tiny(), dtype=torch.float32))
    reasoner = bridge({"params": _reasoner_tree(mot)},
                      tcr.Cosmos3Reasoner(tcr.Cosmos3ReasonerConfig.tiny(), torch.float32))
    targs = {k: t(v) for k, v in args.items()}
    with torch.no_grad():
        ours_full, _ = port(t(grid["text_ids"]), **targs)
        memory = reasoner(t(grid["text_ids"]), targs["position_ids"][:, :, :UND])
        ours_replay, _ = port(None, reasoner_kv=memory, **targs)
    assert torch.equal(ours_replay, ours_full) and rel(ours_full.numpy(), full) < F32_REL


def test_replay_refusals_match_jax(mot):
    """A wrong count of (k, v) pairs and ``text_ids`` None without a replay
    are refused with the JAX messages."""
    grid = _grid(seed=8)
    args = {k: t(grid[k]) for k in ("vision_tokens", "position_ids", "timesteps")}
    port = bridge({"params": mot}, tct.Cosmos3OmniTransformer(tct.Cosmos3Config.tiny(), dtype=torch.float32))
    pair = (torch.zeros(2, UND, 1, 16), torch.zeros(2, UND, 1, 16))
    with pytest.raises(ValueError, match="reasoner replay needs 2"):
        port(None, reasoner_kv=[pair], **args)
    with pytest.raises(ValueError, match="text_ids required"):
        port(None, **args)
    jmodule = jct.Cosmos3OmniTransformer(config=jct.Cosmos3Config.tiny(), dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, {"params": mot})
    jargs = {k: jnp.asarray(grid[k]) for k in ("vision_tokens", "position_ids", "timesteps")}
    with pytest.raises(ValueError, match="reasoner replay needs 2"):
        jmodule.apply(params, None, reasoner_kv=(tuple(jnp.zeros((2, UND, 1, 16)) for _ in range(2)),), **jargs)
    with pytest.raises(ValueError, match="text_ids required"):
        jmodule.apply(params, None, **jargs)
