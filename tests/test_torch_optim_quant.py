"""The torch port's low-memory optimizers against the JAX package, on the CPU.

``quantize_blockwise`` / ``dequantize_blockwise`` code for code, then 20 steps
of ``adamw_bf16`` (Kahan-compensated AdamW), the 8-bit, 4-bit and fp8 AdamW
states and the 8-bit Lion state against the JAX optimizer of the same name,
and the registry (``bnb-adam8bit`` resolves to plain Adam, as in the JAX
registry, where its second registration wins).  The port's 2-D tensors are
the transposes of the Flax leaves, as LoRA adapters are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpletuner_tpu.training import optim_quant as jo
from simpletuner_tpu.training.optimizers import KahanAdamWState
from simpletuner_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from simpletuner_tpu.training.schedules import get_lr_schedule as jax_get_lr_schedule

from simpletuner_tpu_torch.training import optim_quant as to
from simpletuner_tpu_torch.training.optimizers import AdamW, KahanAdamW, OPTIMIZERS, get_optimizer
from simpletuner_tpu_torch.training.schedules import get_lr_schedule

from torch_parity import rel

# f32 log/exp/pow differ by a few ulps between XLA and torch, so a value that
# lands on a code boundary may take the neighbouring code: codes agree on at
# least 99.9% of entries and differ by one step elsewhere
CODE_AGREEMENT = 0.999

STATES = {
    "int8": (torch.int8, jnp.int8, False),
    "int4": (to.INT4_PACKED, jo.INT4_PACKED, False),
    "uint4": (to.INT4_PACKED, jo.INT4_PACKED, True),
    "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn, False),
}


def _codes(q, dtype):
    """Comparable integer codes: int8 as they are, 4-bit nibbles unpacked in
    element order, fp8 bytes as signed magnitudes (neighbours differ by 1)."""
    q = np.asarray(q.view(torch.uint8) if isinstance(q, torch.Tensor) and q.dtype == torch.float8_e4m3fn
                   else q)
    if isinstance(q, np.ndarray) and q.dtype.name == "float8_e4m3fn":
        q = q.view(np.uint8)
    if dtype == "fp8":
        q = q.astype(np.int32)
        return np.where(q & 0x80, -(q & 0x7F), q & 0x7F)
    if dtype in ("int4", "uint4"):
        q = q.astype(np.int32)
        return np.stack([q >> 4, q & 0xF], axis=-1).reshape(q.shape[0], -1)
    return q.astype(np.int32)


def _assert_codes_agree(got, ref, dtype, what=""):
    got, ref = _codes(got, dtype), _codes(ref, dtype)
    assert got.shape == ref.shape, what
    diff = np.abs(got - ref)
    assert (diff == 0).mean() >= CODE_AGREEMENT, (what, (diff == 0).mean())
    assert diff.max() <= 1, (what, diff.max())


def _values(rng, n, unsigned):
    """Magnitudes over ten decades, an all-zero block and a ragged tail."""
    x = rng.standard_normal(n).astype(np.float32) * np.exp(rng.uniform(-14, 3, n)).astype(np.float32)
    x[256:512] = 0.0
    return np.square(x) if unsigned else x


@pytest.mark.parametrize("state", list(STATES))
def test_blockwise_codes_match_jax(state):
    dtype_t, dtype_j, unsigned = STATES[state]
    x = _values(np.random.default_rng(0), 64 * 256 + 37, unsigned)
    q_j, s_j = jo.quantize_blockwise(jnp.asarray(x), dtype_j, unsigned=unsigned)
    q_t, s_t = to.quantize_blockwise(torch.from_numpy(x), dtype_t, unsigned=unsigned)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))  # absmax (fp8: absmax / 240)
    _assert_codes_agree(q_t, q_j, state)
    # the same codes decode to the same values (exp in f32: a few ulps)
    back_j = np.asarray(jo.dequantize_blockwise(q_j, s_j, x.shape, dtype=dtype_j, unsigned=unsigned))
    back_t = to.dequantize_blockwise(q_t, s_t, x.shape, unsigned=unsigned).numpy()
    back_tj = to.dequantize_blockwise(_to_torch_state(q_j), torch.from_numpy(np.asarray(s_j)), x.shape,
                                      unsigned=unsigned).numpy()
    np.testing.assert_allclose(back_tj, back_j, rtol=1e-6, atol=0)
    assert back_t.shape == x.shape and back_t.dtype == np.float32
    # the 4-bit state packs even/odd elements: element 0 is the first byte's high nibble
    if state in ("int4", "uint4"):
        nib = _codes(q_t, state)
        assert np.array_equal((nib[:, 0::2] << 4) | nib[:, 1::2], q_t.numpy().astype(np.int32))


def _to_torch_state(q):
    q = np.asarray(q)
    if q.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(q.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(q.copy())


# ---- 20 steps against the JAX optimizers --------------------------------------------------------------

# Flax leaf shapes; the port holds the transposes.  Two leaves are large
# enough for quantized moments (>= 4096 elements), one keeps f32 moments.
LEAVES = {"a/lora_A": (300, 16), "a/lora_B": (16, 320), "b/lora_A": (12, 8)}


def _tree(rng, scale):
    return {k: (scale * rng.standard_normal(shape)).astype(np.float32) for k, shape in LEAVES.items()}


def _run(name, steps=20, param_dtype=np.float32, **extra):
    config = {"optimizer": name, "learning_rate": 3e-3, "max_grad_norm": 1.0, "adam_weight_decay": 0.05,
              "lr_scheduler": "linear", "lr_warmup_steps": 3, **extra}
    rng = np.random.default_rng(5)
    params = _tree(rng, 0.1)
    jdt, tdt = {np.float32: (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[param_dtype]
    tx_j = jax_get_optimizer(config, jax_get_lr_schedule(config, steps))
    tx_t = get_optimizer(config, get_lr_schedule(config, steps))
    p_j = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    p_t = {k: torch.from_numpy(np.asarray(p_j[k].astype(jnp.float32)).T.copy()).to(tdt) for k in params}
    s_j, s_t = tx_j.init(p_j), tx_t.init(p_t)
    for step in range(steps):
        grads = _tree(rng, [0.02, 2.0][step % 3 == 2])  # the clip triggers every third step
        u_j, s_j = tx_j.update({k: jnp.asarray(v, jdt) for k, v in grads.items()}, s_j, p_j)
        u_t, s_t = tx_t.update({k: torch.from_numpy(v.T.copy()).to(tdt) for k, v in grads.items()}, s_t, p_t)
        p_j = {k: (p_j[k] + u_j[k]).astype(jdt) for k in p_j}
        p_t = {k: (p_t[k] + u_t[k]).to(tdt) for k in p_t}
    moved = {k: np.asarray(p_j[k].astype(jnp.float32)) - params[k] for k in params}
    return p_t, p_j, s_t, s_j, moved, tx_t


def _state(s_j, cls):
    return next(x for x in jax.tree_util.tree_leaves(s_j, is_leaf=lambda x: isinstance(x, cls)) if isinstance(x, cls))


def _assert_params(p_t, p_j, moved, bound):
    for k in p_j:
        got = p_t[k].float().numpy().T
        ref = np.asarray(p_j[k].astype(jnp.float32))
        assert np.abs(moved[k]).max() > 0, k
        # the difference measured against how far the parameters moved
        assert rel(got - (ref - moved[k]), moved[k]) < bound, (k, rel(got - (ref - moved[k]), moved[k]))


@pytest.mark.parametrize("param_dtype", [np.float32, "bf16"])
def test_adamw_bf16_matches_kahan_adamw(param_dtype):
    # bf16 parameters run without the clip: optax clips bf16 gradients in
    # bf16, the port in f32 (its adapters, and so their gradients, are f32)
    clip = {"max_grad_norm": 0.0} if param_dtype == "bf16" else {}
    p_t, p_j, s_t, s_j, moved, tx = _run("adamw_bf16", param_dtype=param_dtype, **clip)
    assert isinstance(tx, KahanAdamW) and s_t.count == 20
    kahan = _state(s_j, KahanAdamWState)
    if param_dtype == "bf16":
        # bf16 parameters step by bf16 roundings, the compensation carries
        # what they lose: both equal to the JAX state's (measured: on every
        # entry; an f32 step on a bf16 tie could round the other way)
        for k in p_j:
            same = (p_t[k].float().numpy().T == np.asarray(p_j[k].astype(jnp.float32))).mean()
            assert same >= CODE_AGREEMENT, (k, same)
            comp_j = np.asarray(kahan.compensation[k].astype(jnp.float32))
            assert (s_t.compensation[k].float().numpy().T == comp_j).mean() >= CODE_AGREEMENT, k
            assert np.abs(comp_j).max() > 0
    else:
        _assert_params(p_t, p_j, moved, 1e-5)
        for k in p_j:
            np.testing.assert_allclose(s_t.mu[k].numpy().T, np.asarray(kahan.mu[k]), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("name,state", [("ao-adamw8bit", "int8"), ("bnb-adamw8bit-paged", "int8"),
                                        ("ao-adamw4bit", "int4"), ("ao-adamfp8", "fp8"), ("ao-adamwfp8", "fp8")])
def test_quantized_adamw_matches_jax(name, state):
    p_t, p_j, s_t, s_j, moved, tx = _run(name)
    assert isinstance(tx, to.AdamWQuantized) and s_t.count == 20
    adam = _state(s_j, jo.QuantizedAdamState)
    for k, shape in LEAVES.items():
        if np.prod(shape) < 4096:  # f32 moments
            assert s_t.mu_q[k].dtype == torch.float32
            np.testing.assert_allclose(s_t.mu_q[k].numpy().T, np.asarray(adam.mu_q[k]), rtol=1e-4, atol=1e-9)
            continue
        _assert_codes_agree(s_t.mu_q[k], adam.mu_q[k], state, k)
        _assert_codes_agree(s_t.nu_q[k], adam.nu_q[k], "uint4" if state == "int4" else state, k)
        np.testing.assert_allclose(s_t.mu_scale[k].numpy(), np.asarray(adam.mu_scale[k]), rtol=1e-3)
    # a moment entry one code apart (4-9% of the entry) moves its parameter's
    # later steps a little: measured 1e-4 of the distance the parameters moved
    _assert_params(p_t, p_j, moved, 5e-3)


def test_lion_8bit_matches_jax():
    p_t, p_j, s_t, s_j, moved, tx = _run("bnb-lion8bit", optimizer_config="b1=0.95,b2=0.98")
    assert isinstance(tx, to.LionQuantized) and (tx.b1, tx.b2) == (0.95, 0.98)
    lion = _state(s_j, jo.QuantizedLionState)
    for k, shape in LEAVES.items():
        if np.prod(shape) >= 4096:
            _assert_codes_agree(s_t.mu_q[k], lion.mu_q[k], "int8", k)
    # Lion steps by the sign of its momentum mix: equal unless the mix is
    # within rounding of 0
    _assert_params(p_t, p_j, moved, 5e-3)


def test_bnb_adam8bit_is_plain_adam_as_in_the_jax_registry():
    # JAX registers "bnb-adam8bit" twice (optimizers.py:169 with 8-bit state,
    # :195 as optax.adam); the later registration wins, and the port mirrors it
    p_t, p_j, s_t, s_j, moved, tx = _run("bnb-adam8bit")
    assert isinstance(tx, AdamW) and tx.weight_decay == 0.0
    assert not any(isinstance(x, jo.QuantizedAdamState)
                   for x in jax.tree_util.tree_leaves(s_j, is_leaf=lambda x: isinstance(x, jo.QuantizedAdamState)))
    _assert_params(p_t, p_j, moved, 1e-5)
    for k in p_j:
        assert s_t.mu[k].dtype == torch.float32
    # the adam_weight_decay of the config is not applied, as optax.adam applies none
    p_w, p_wj, *_ = _run("bnb-adam8bit", adam_weight_decay=0.5)
    for k in p_j:
        assert torch.equal(p_w[k], p_t[k])


def test_registry_names_resolve():
    names = ("adamw", "adam", "adamw_bf16", "ao-adamw8bit", "bnb-adamw8bit", "bnb-adamw8bit-paged", "ao-adamw4bit",
             "ao-adamfp8", "ao-adamwfp8", "bnb-lion8bit", "bnb-lion8bit-paged", "bnb-adam8bit")
    assert set(names) <= set(OPTIMIZERS)
    for name in names:
        tx = get_optimizer({"optimizer": name.upper() if name == "adamw" else name}, 1e-4)
        assert tx.max_norm == 1.0
        state = tx.init({"w": torch.zeros(80, 64)})
        updates, _ = tx.update({"w": torch.ones(80, 64)}, state, {"w": torch.zeros(80, 64)})
        assert torch.isfinite(updates["w"]).all() and (updates["w"] < 0).all(), name
    for name in ("prodigy", "lion", "muon"):
        with pytest.raises(NotImplementedError):
            get_optimizer({"optimizer": name}, 1e-4)
