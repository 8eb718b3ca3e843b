"""The torch port's flash-attention backward against the JAX package, on the CPU.

The same numpy inputs go through the JAX Pallas backward kernels (interpret
mode, as the JAX package's own tests run them) and through the port's
``mha_backward_reference``, the plain version of the Hopper dq/dkv kernels;
and ``jax.grad`` through the JAX ``flash_attention`` goes against autograd
through the port's ``flash_attention`` (which on CPU tensors runs the plain
forward and backward).  Everything is f32 here; the kernels' bf16 arithmetic
is checked on the card by test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpletuner_tpu.ops.flash_attention import _flash_backward, _flash_forward
from simpletuner_tpu.ops.flash_attention import flash_attention as jax_flash

from simpletuner_tpu_torch.ops import (
    SEGMENT_PAD_ID,
    dot_product_attention,
    flash_attention,
    flash_backward,
    flash_bwd_dkv_kernel,
    flash_bwd_dq_kernel,
    mha_backward_reference,
    mha_reference,
)
from simpletuner_tpu_torch.ops.flash_attention import _pad_head_dim

# f32 on both sides; only the order of f32 sums differs (the Pallas kernels
# accumulate over 128-row blocks, the plain version in one einsum)
TOL = 1e-5


def _inputs(seed, batch=1, heads=2, sq=256, sk=256, dim=32):
    rng = np.random.default_rng(seed)
    shapes = [(batch, heads, sq, dim), (batch, heads, sk, dim), (batch, heads, sk, dim), (batch, heads, sq, dim)]
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _segments(kind, batch, seq):
    """Segment ids of each masked case; None for the unmasked one."""
    if kind == "unmasked":
        return None
    seg = np.zeros((batch, seq), np.int32)
    if kind == "segments":
        seg[:, seq // 2:] = 1
    elif kind == "t5_padding":  # Flux masked training: padded text tokens first, then image
        seg[:, 40:128] = SEGMENT_PAD_ID
    elif kind == "fully_masked_rows":
        seg[:, seq - 64:] = SEGMENT_PAD_ID
        seg[-1, :] = SEGMENT_PAD_ID  # one sample sees nothing at all
    return seg


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _close(port, ref, tol=TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    np.testing.assert_allclose(port, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dim", [32, 64])
@pytest.mark.parametrize("kind", ["unmasked", "segments", "t5_padding", "fully_masked_rows"])
def test_backward_reference_matches_pallas_kernels(kind, dim):
    batch, heads, seq = 2, 2, 256
    q, k, v, do = _inputs(0, batch, heads, seq, seq, dim)
    seg = _segments(kind, batch, seq)
    seg_j = None if seg is None else jnp.asarray(seg)
    scale = dim ** -0.5
    out, lse_lanes = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg_j, seg_j, scale, 128, 128, True
    )
    dq_j, dk_j, dv_j = _flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg_j, seg_j, out, lse_lanes, jnp.asarray(do),
        scale, block_q=128, block_kv=128, interpret=True,
    )
    lse = np.asarray(lse_lanes)[:, :, 0].reshape(batch, heads, seq)  # lane-replicated -> compact
    dq, dk, dv = mha_backward_reference(
        _t(q), _t(k), _t(v), _t(seg), _t(seg), _t(out), _t(lse), _t(do), scale
    )
    for port, ref in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert port.dtype == torch.float32
        _close(port.numpy(), ref)
    if kind != "unmasked":
        pad = seg == SEGMENT_PAD_ID
        # padded rows see no key and padded keys are seen by nobody: exactly 0
        assert (dq.permute(0, 2, 1, 3)[torch.from_numpy(pad)] == 0).all()
        assert (dk.permute(0, 2, 1, 3)[torch.from_numpy(pad)] == 0).all()
        assert (dv.permute(0, 2, 1, 3)[torch.from_numpy(pad)] == 0).all()


@pytest.mark.parametrize(
    "kind,seq,dim",
    [("unmasked", 256, 32), ("unmasked", 200, 64), ("segments", 256, 64), ("t5_padding", 192, 32),
     ("fully_masked_rows", 200, 32)],  # 200/192: ragged S, padded to the block inside the JAX wrapper
)
def test_autograd_matches_jax_grad(kind, seq, dim):
    batch, heads = 2, 2
    q, k, v, do = _inputs(1, batch, heads, seq, seq, dim)
    seg = _segments(kind, batch, seq)
    seg_j = None if seg is None else jnp.asarray(seg)

    def loss(q, k, v):
        out = jax_flash(q, k, v, seg_j, seg_j, interpret=True, block_q=128, block_kv=128)
        return jnp.sum(out * jnp.asarray(do))

    grads_j = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, _t(seg), _t(seg))
    (out * _t(do)).sum().backward()
    for port, ref in zip((qt.grad, kt.grad, vt.grad), grads_j):
        _close(port.numpy(), ref)


def test_dispatcher_layout_gradients_match_plain_autograd():
    # (B, S, H, D) views through both dispatcher backends: the flash op's
    # backward against autograd through the plain version
    rng = np.random.default_rng(2)
    x = [rng.standard_normal((2, 96, 3, 32), dtype=np.float32) for _ in range(4)]
    seg = np.zeros((2, 96), np.int32)
    seg[1, 70:] = SEGMENT_PAD_ID
    grads = {}
    for backend in ("pallas_flash", "xla"):
        q, k, v = (_t(a).requires_grad_() for a in x[:3])
        out = dot_product_attention(q, k, v, _t(seg), _t(seg), backend=backend)
        (out * _t(x[3])).sum().backward()
        grads[backend] = [g.grad.numpy() for g in (q, k, v)]
    for port, ref in zip(grads["pallas_flash"], grads["xla"]):
        _close(port, ref)


def test_plain_backward_keeps_the_kernels_rounding_sites():
    # in bf16 the plain backward rounds dS and P before their products: its
    # gradients differ from exact f32 autograd by about a bf16 rounding, and
    # its delta and lse stay f32
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(3, 1, 2, 128, 128, 64))
    out, lse = flash_attention(q, k, v, return_lse=True)
    dq, dk, dv = mha_backward_reference(q, k, v, None, None, out, lse, do, 64 ** -0.5)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
    (mha_reference(qf, kf, vf) * do.float()).sum().backward()
    for port, exact in ((dq, qf.grad), (dk, kf.grad), (dv, vf.grad)):
        err = float((port.float() - exact).norm() / exact.norm())
        assert 1e-4 < err < 2e-2


def test_cpu_backward_never_reaches_the_kernels():
    q, k, v, do = (_t(a) for a in _inputs(4, 1, 1, 64, 64, 32))
    before = (flash_bwd_dq_kernel.launches, flash_bwd_dkv_kernel.launches)
    out, lse = flash_attention(q, k, v, return_lse=True)
    dq, dk, dv = flash_backward(q, k, v, None, None, out, lse, do, 32 ** -0.5)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert (flash_bwd_dq_kernel.launches, flash_bwd_dkv_kernel.launches) == before
    assert flash_bwd_dq_kernel.name == "flash_bwd_dq" and flash_bwd_dkv_kernel.name == "flash_bwd_dkv"


@pytest.mark.parametrize("dim", [72, 96, 112])  # pixart, lumina2, sana
def test_padded_head_dim_backward_matches_pallas_kernels(dim):
    # the kernel wrappers zero-pad q, k, v and dO to the kernel's head dim and
    # slice the gradients back; the padded columns' gradients are exactly 0
    # and the result is the Pallas backward of the unpadded inputs
    batch, heads, seq = 1, 2, 256
    q, k, v, do = _inputs(5, batch, heads, seq, seq, dim)
    seg = _segments("t5_padding", batch, seq)
    seg_j = jnp.asarray(seg)
    scale = dim ** -0.5
    out, lse_lanes = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg_j, seg_j, scale, 128, 128, True
    )
    grads_j = _flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg_j, seg_j, out, lse_lanes, jnp.asarray(do),
        scale, block_q=128, block_kv=128, interpret=True,
    )
    lse = _t(np.asarray(lse_lanes)[:, :, 0].reshape(batch, heads, seq))
    padded = [_pad_head_dim(_t(x)) for x in (q, k, v, np.asarray(out), do)]
    assert padded[0].shape[-1] == 128
    grads = mha_backward_reference(*padded[:3], _t(seg), _t(seg), padded[3], lse, padded[4], scale)
    for port, ref in zip(grads, grads_j):
        assert (port[..., dim:] == 0).all()
        _close(port[..., :dim].numpy(), ref)
