"""The torch port's flash attention against the JAX package, on the CPU.

The same numpy inputs go through the JAX Pallas kernel (interpret mode, as the
JAX package's own tests run it) or ``mha_reference``, and through the port's
``flash_attention`` / ``mha_reference``, which on CPU tensors run the plain
PyTorch version of the Hopper kernel.  Everything is f32 here; the kernel's
bf16 arithmetic is checked on the card by test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from simpletuner_tpu.ops import dot_product_attention as jax_dpa
from simpletuner_tpu.ops import mha_reference as jax_mha_reference
from simpletuner_tpu.ops.flash_attention import _flash_forward
from simpletuner_tpu.ops.flash_attention import flash_attention as jax_flash

from simpletuner_tpu_torch.ops import (
    SEGMENT_PAD_ID,
    dot_product_attention,
    flash_attention,
    flash_fwd_kernel,
    mha_reference,
    mha_reference_lse,
    set_context_parallel,
)
from simpletuner_tpu_torch.ops.flash_attention import _kernel_head_dim, _pad_head_dim

# f32 on both sides; the Pallas kernel and the port differ only in the order
# of f32 sums (online softmax over 128-key blocks vs one softmax) -- the same
# bound test_ops_attention.py holds the Pallas kernel to
TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _fresh_reference():
    """The references compiled in this module, from nothing, with nothing set
    by an earlier file of the same worker.

    The persistent compile cache that tests/conftest.py keeps is shared by
    every worker and every run; XLA:CPU loads each of its entries with a
    warning that the entry's target features (+prefer-no-scatter,
    +prefer-no-gather) do not match the host's, the mode in which conftest's
    own comment records entries computing wrong math.  Eager ops here (the
    JAX ``mha_reference``) compile op by op, and under a loaded run each took
    long enough to be written there.  So this module clears the in-memory
    executables, turns the persistent cache off while it runs, and starts
    from the default attention state of both packages."""
    from jax._src import compilation_cache

    from simpletuner_tpu.ops.attention import set_attention_backend as jax_set_attention_backend
    from simpletuner_tpu.ops.attention import set_context_parallel as jax_set_context_parallel
    from simpletuner_tpu_torch.ops import set_attention_backend

    previous = jax.config.jax_enable_compilation_cache
    jax.clear_caches()
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    for reset_backend, reset_cp in ((set_attention_backend, set_context_parallel),
                                    (jax_set_attention_backend, jax_set_context_parallel)):
        reset_backend("auto")
        reset_cp(None)
    yield
    jax.config.update("jax_enable_compilation_cache", previous)
    compilation_cache.reset_cache()


def _qkv(seed, batch=1, heads=2, sq=256, sk=256, dim=32):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal(shape, dtype=np.float32)
        for shape in ((batch, heads, sq, dim), (batch, heads, sk, dim), (batch, heads, sk, dim))
    ]


def _jax_flash(q, k, v, seg=None):
    seg_j = None if seg is None else jnp.asarray(seg)
    return np.asarray(
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg_j, seg_j,
                  interpret=True, block_q=128, block_kv=128)
    )


def _port(fn, *arrays, **kwargs):
    return fn(*[None if a is None else torch.from_numpy(a) for a in arrays], **kwargs)


@pytest.mark.parametrize("sq,sk", [(256, 256), (384, 256), (200, 200)])
def test_flash_matches_jax(sq, sk):
    q, k, v = _qkv(0, sq=sq, sk=sk)
    out = _port(flash_attention, q, k, v).numpy()
    np.testing.assert_allclose(out, _jax_flash(q, k, v), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        out, np.asarray(jax_mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))), atol=TOL, rtol=TOL
    )


def test_flash_segment_mask():
    q, k, v = _qkv(1)
    seg = np.concatenate([np.zeros((1, 128), np.int32), np.ones((1, 128), np.int32)], axis=1)
    out = _port(flash_attention, q, k, v, seg, seg).numpy()
    np.testing.assert_allclose(out, _jax_flash(q, k, v, seg), atol=TOL, rtol=TOL)
    # each segment matches standalone attention over just its tokens
    solo = _port(mha_reference, q[:, :, :128], k[:, :, :128], v[:, :, :128]).numpy()
    np.testing.assert_allclose(out[:, :, :128], solo, atol=TOL, rtol=TOL)


def test_flash_padding_ignored():
    q, k, v = _qkv(2, heads=1, sq=100, sk=100)
    np.testing.assert_allclose(_port(flash_attention, q, k, v).numpy(), _jax_flash(q, k, v), atol=TOL, rtol=TOL)


def test_fully_masked_rows_are_zero():
    q, k, v = _qkv(3, heads=2, sq=192, sk=192)
    seg = np.zeros((1, 192), np.int32)
    seg[:, 40:77] = SEGMENT_PAD_ID  # padded text tokens, as in Flux masked training
    out, lse = _port(flash_attention, q, k, v, seg, seg, return_lse=True)
    assert (out[:, :, 40:77] == 0).all()
    assert (lse[:, :, 40:77] == -1e30).all()
    np.testing.assert_allclose(out.numpy(), _jax_flash(q, k, v, seg), atol=TOL, rtol=TOL)
    ref = np.asarray(jax_mha_reference(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(seg), jnp.asarray(seg)))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_lse_matches_pallas_forward(masked):
    q, k, v = _qkv(4, heads=2, sq=256, sk=256)
    seg = None
    if masked:
        seg = np.zeros((1, 256), np.int32)
        seg[:, 100:130] = SEGMENT_PAD_ID
        seg[:, 200:] = 1
    seg_j = None if seg is None else jnp.asarray(seg)
    _, lse_lanes = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg_j, seg_j, 32 ** -0.5, 128, 128, True
    )
    jax_lse = np.asarray(lse_lanes)[:, :, 0].reshape(1, 2, 256)  # lane-replicated -> compact
    _, lse = _port(flash_attention, q, k, v, seg, seg, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), jax_lse, atol=TOL, rtol=TOL)


def test_dispatcher_layout_and_auto_on_cpu():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, 4, 32), dtype=np.float32)  # (B, S, H, D)
    seg = np.zeros((2, 64), np.int32)
    seg[1, 50:] = SEGMENT_PAD_ID
    before = flash_fwd_kernel.launches
    for backend in (None, "auto", "pallas_flash", "xla", "sdpa", "flash_attn"):
        out = _port(dot_product_attention, x, x, x, seg, seg, backend=backend).numpy()
        ref = np.asarray(jax_dpa(*(jnp.asarray(x),) * 3, jnp.asarray(seg), jnp.asarray(seg), backend="xla"))
        assert out.shape == x.shape
        np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    # CPU tensors never reach the CUDA kernel
    assert flash_fwd_kernel.launches == before


def test_unported_backends_raise():
    x = torch.zeros((1, 8, 2, 32))
    with pytest.raises(NotImplementedError):
        dot_product_attention(x, x, x, backend="sla")
    with pytest.raises(ValueError):
        dot_product_attention(x, x, x, backend="no-such-backend")
    set_context_parallel(object())
    try:
        with pytest.raises(NotImplementedError):
            dot_product_attention(x, x, x)
    finally:
        set_context_parallel(None)


def test_backend_is_not_read_from_the_environment(monkeypatch):
    # on the card every non-flash backend is the f32 plain version, so an
    # exported JAX-side setting must not move the port off its kernel
    import importlib

    from simpletuner_tpu_torch.ops import attention

    monkeypatch.setenv("SIMPLETUNER_ATTENTION_BACKEND", "xla")
    importlib.reload(attention)
    assert attention.get_attention_backend() == "auto"


# ---- head dims the kernels reach zero-padded --------------------------------------------------------


@pytest.mark.parametrize("dim,width", [(1, 64), (32, 64), (48, 64), (64, 64), (72, 128), (80, 128), (96, 128),
                                       (112, 128), (128, 128), (129, 256), (192, 256), (256, 256)])
def test_kernel_head_dim_pads_to_the_next_kernel_width(dim, width):
    assert _kernel_head_dim(dim) == width
    x = torch.ones((1, 1, 4, dim))
    padded = _pad_head_dim(x)
    assert padded.shape[-1] == width and (padded[..., dim:] == 0).all() and torch.equal(padded[..., :dim], x)
    assert (padded is x) == (dim == width)


@pytest.mark.parametrize("dim", [129, 160, 256])
def test_kernel_head_dim_refuses_above_128(dim):
    """The head dim 128 kernels take no wider head: these reach the head dim
    256 instances (zero-padded below 256), and a head wider than 256 is
    refused by name."""
    assert _kernel_head_dim(dim) == 256
    with pytest.raises(NotImplementedError, match="256"):
        _kernel_head_dim(dim + 128)


@pytest.mark.parametrize("dim", [257, 320, 512])
def test_kernel_head_dim_refuses_above_256(dim):
    with pytest.raises(NotImplementedError, match="head_dim <= 256"):
        _kernel_head_dim(dim)


@pytest.mark.parametrize("seq,masked", [(256, False), (192, False), (256, True), (192, True)])
def test_head_dim_256_matches_jax(seq, masked):
    """AuraFlow's head dim: the port's op (the plain versions of the head dim
    256 kernels on the CPU) against the JAX ``flash_attention`` (the Pallas
    kernels in interpret mode) on the same inputs, forward and the
    gradients of a seeded projection, within ``TOL``; 192 is a ragged S."""
    q, k, v = _qkv(7 + seq, heads=2, sq=seq, sk=seq, dim=256)
    do = np.random.default_rng(seq).standard_normal(q.shape, dtype=np.float32)
    seg = None
    if masked:  # two packed samples and padding
        seg = np.zeros((1, seq), np.int32)
        seg[:, 100:] = 1
        seg[:, seq - 30:] = SEGMENT_PAD_ID
    seg_j = None if seg is None else jnp.asarray(seg)

    def loss(q, k, v):
        out = jax_flash(q, k, v, seg_j, seg_j, interpret=True, block_q=128, block_kv=128)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, ref), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    seg_t = None if seg is None else torch.from_numpy(seg)
    out = flash_attention(*leaves, seg_t, seg_t)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    (out * torch.from_numpy(do)).sum().backward()
    for leaf, grad in zip(leaves, grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(grad), atol=TOL, rtol=TOL)
    if masked:
        assert (out[:, :, seq - 30:] == 0).all() and all((x.grad[:, :, seq - 30:] == 0).all() for x in leaves)


@pytest.mark.parametrize("dim", [72, 96, 112])  # pixart, lumina2, sana
def test_narrow_head_dims_keep_their_own_scale(dim):
    q, k, v = _qkv(6, heads=2, sq=200, sk=200, dim=dim)
    seg = np.zeros((1, 200), np.int32)
    seg[:, 30:77] = SEGMENT_PAD_ID
    ref = _jax_flash(q, k, v, seg)  # sm_scale = dim ** -0.5 in the Pallas wrapper
    np.testing.assert_allclose(_port(flash_attention, q, k, v, seg, seg).numpy(), ref, atol=TOL, rtol=TOL)
    # what the kernel wrappers compute: operands zero-padded to the kernel's
    # head dim, scaled by the unpadded dim; the padded columns come out 0
    padded = [_pad_head_dim(torch.from_numpy(x)) for x in (q, k, v)]
    seg_t = torch.from_numpy(seg)
    out, _ = mha_reference_lse(*padded, seg_t, seg_t, sm_scale=dim ** -0.5)
    np.testing.assert_allclose(out[..., :dim].numpy(), ref, atol=TOL, rtol=TOL)
    assert (out[..., dim:] == 0).all()
    # the padded width's own scale would change every row that attends
    wrong, _ = mha_reference_lse(*padded, seg_t, seg_t)
    assert np.abs(wrong[..., :dim].numpy() - ref).max() > 100 * TOL
