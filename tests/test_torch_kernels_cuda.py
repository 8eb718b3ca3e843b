"""The Hopper flash-attention kernels against their plain PyTorch versions, on the card.

Skipped without CUDA: a CUDA kernel has no CPU mode.  Run on a machine with an
H100 (the JAX test bootstrap in conftest.py is not needed there):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from simpletuner_tpu_torch.ops import (
    SEGMENT_PAD_ID,
    flash_attention,
    flash_backward,
    flash_bwd_dkv_kernel,
    flash_bwd_dq_kernel,
    mha_backward_reference,
    mha_reference,
    mha_reference_lse,
)
from simpletuner_tpu_torch.ops.attention import dot_product_attention

pytestmark = pytest.mark.gpu

# bf16 out, bounds relative to the plain version's output: softmax averages V,
# so |out| sits far below |v| (max |out| ~ 0.17 at S=4608 for N(0, 1) inputs)
# and an absolute bound would hide faults of a few tens of percent.  Both sides
# round out to bf16 and the kernel also rounds P to bf16 before P.V (about
# 2e-3 of |out| in relative L2).  The largest elementwise gap is one bf16 ulp,
# at most 2^-7 of a value; the bound is two ulps of the largest output.
OUT_REL_MAX = 2.0 ** -6
# relative L2 over the whole output: about 2.5e-3 from the P rounding
# (a CPU emulation of the kernel's rounding sites); a 1% fault anywhere fails
OUT_REL_L2 = 8e-3
# lse is f32 on both sides from the same bf16 inputs; only the summation order
# of the f32 dot products differs
LSE_ATOL = 1e-3
# backward, kernel vs mha_backward_reference on the same out/lse/dO: both round
# P and dS to bf16 at the same sites and dq/dk/dv to bf16 at the end, so they
# differ where an f32 sum order (or exp2 vs exp) flips a rounding; each
# gradient within two bf16 ulps of its largest plain value and 1e-2 in
# relative L2
GRAD_REL_MAX, GRAD_REL_L2 = 2.0 ** -6, 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper flash kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, batch, heads, sq, sk, dim, device):
    rng = np.random.default_rng(seed)
    shapes = ((batch, heads, sq, dim), (batch, heads, sk, dim), (batch, heads, sk, dim))
    return [
        torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device, torch.bfloat16)
        for s in shapes
    ]


def _check(q, k, v, q_seg=None, kv_seg=None):
    out, lse = flash_attention(q, k, v, q_seg, kv_seg, return_lse=True)
    ref_out, ref_lse = mha_reference_lse(q, k, v, q_seg, kv_seg)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    _assert_out_close(out, ref_out)
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL
    return out, lse


def _assert_out_close(out, ref):
    out, ref = out.float(), ref.float()
    assert (out - ref).abs().max().item() <= OUT_REL_MAX * ref.abs().max().item()
    assert ((out - ref).norm() / ref.norm()).item() <= OUT_REL_L2


def _flux_text_pad_segments(batch, txt_len, valid, img_len, device):
    """Flux masked training: padded T5 tokens get SEGMENT_PAD_ID, text first."""
    seg = torch.zeros((batch, txt_len + img_len), dtype=torch.int32, device=device)
    seg[:, valid:txt_len] = SEGMENT_PAD_ID
    return seg


@pytest.mark.parametrize(
    "batch,heads,sq,sk,dim",
    [(1, 24, 4608, 4608, 128), (1, 4, 1000, 1000, 64), (2, 3, 256, 256, 32), (1, 2, 384, 200, 64),
     (1, 2, 100, 128, 64)],  # the last: ragged queries on the unmasked path
)
def test_kernel_matches_plain(cuda, batch, heads, sq, sk, dim):
    q, k, v = _qkv(0, batch, heads, sq, sk, dim, cuda)
    _check(q, k, v)


def test_kernel_flux_text_padding(cuda):
    q, k, v = _qkv(1, 1, 24, 4608, 4608, 128, cuda)
    seg = _flux_text_pad_segments(1, 512, 77, 4096, cuda)
    out, lse = _check(q, k, v, seg, seg)
    # padded text rows see no key: exactly zero, lse at the mask value
    assert (out[:, :, 77:512] == 0).all()
    assert (lse[:, :, 77:512] == -1e30).all()


def test_kernel_flux_text_padding_ragged_s(cuda):
    # Flux padding at S = 4173 (not a multiple of the 128-row tiles): pad
    # query tiles write 0 / -1e30 without loading K/V, pad key tiles are
    # skipped, tile 0 is mixed, the ragged last tile is masked as pad
    q, k, v = _qkv(11, 1, 24, 4173, 4173, 128, cuda)
    seg = _flux_text_pad_segments(1, 512, 77, 4173 - 512, cuda)
    out, lse = _check(q, k, v, seg, seg)
    assert (out[:, :, 77:512] == 0).all()
    assert (lse[:, :, 77:512] == -1e30).all()


def test_kernel_cross_attention_pad_key_tiles(cuda):
    # queries of one segment against keys whose second and fourth 128-key
    # tiles are all pad: those tiles are skipped; no row is fully masked
    q, k, v = _qkv(12, 2, 3, 200, 512, 64, cuda)
    q_seg = torch.zeros((2, 200), dtype=torch.int32, device=cuda)
    kv_seg = torch.zeros((2, 512), dtype=torch.int32, device=cuda)
    kv_seg[:, 128:256] = SEGMENT_PAD_ID
    kv_seg[:, 384:] = SEGMENT_PAD_ID
    _check(q, k, v, q_seg, kv_seg)


def test_kernel_packed_segments_ragged(cuda):
    q, k, v = _qkv(2, 2, 2, 300, 300, 32, cuda)
    seg = torch.zeros((2, 300), dtype=torch.int32, device=cuda)
    seg[:, 130:] = 1
    seg[1, 280:] = SEGMENT_PAD_ID
    out, _ = _check(q, k, v, seg, seg)
    assert (out[1, :, 280:] == 0).all()


def test_kernel_strided_dispatcher_layout(cuda):
    # (B, S, H, D) views go to the kernel without a transposing copy
    q, k, v = _qkv(3, 1, 8, 640, 640, 64, cuda)
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = dot_product_attention(qs, ks, vs)
    ref, _ = mha_reference_lse(q, k, v)
    _assert_out_close(out.transpose(1, 2), ref)


def test_kernel_rejects_unsupported(cuda):
    q, k, v = _qkv(4, 1, 2, 128, 128, 64, cuda)
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), v.float())
    # every head dim up to 128 is taken (zero-padded); 256 is still to port
    q256 = torch.zeros((1, 2, 128, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError, match="256"):
        flash_attention(q256, q256, q256)


def _check_backward(q, k, v, seg=None, seed=0, kv_seg=None):
    """Kernel dq/dk/dv against the plain backward on the kernel's own out and
    lse; ``seg`` holds the ids of both sides unless ``kv_seg`` is given."""
    kv_seg = seg if kv_seg is None else kv_seg
    out, lse = flash_attention(q, k, v, seg, kv_seg, return_lse=True)
    rng = np.random.default_rng(seed)
    do = torch.from_numpy(rng.standard_normal(tuple(q.shape), dtype=np.float32)).to(q.device, torch.bfloat16)
    before = (flash_bwd_dq_kernel.launches, flash_bwd_dkv_kernel.launches)
    grads = flash_backward(q, k, v, seg, kv_seg, out, lse, do, q.shape[-1] ** -0.5)
    assert (flash_bwd_dq_kernel.launches, flash_bwd_dkv_kernel.launches) == (before[0] + 1, before[1] + 1)
    refs = mha_backward_reference(q, k, v, seg, kv_seg, out, lse, do, q.shape[-1] ** -0.5)
    torch.cuda.synchronize()
    for grad, ref in zip(grads, refs):
        assert grad.shape == ref.shape and grad.dtype == torch.bfloat16
        assert torch.isfinite(grad.float()).all()
        g, r = grad.float(), ref.float()
        assert r.norm() > 0
        assert (g - r).abs().max().item() <= GRAD_REL_MAX * r.abs().max().item()
        assert ((g - r).norm() / r.norm()).item() <= GRAD_REL_L2
    return grads


@pytest.mark.parametrize(
    "batch,heads,seq,dim",
    [(1, 24, 4608, 128), (1, 4, 1000, 64), (2, 3, 256, 32), (1, 2, 100, 64)],
)
def test_backward_kernels_match_plain(cuda, batch, heads, seq, dim):
    q, k, v = _qkv(5, batch, heads, seq, seq, dim, cuda)
    _check_backward(q, k, v)


def test_backward_kernels_flux_text_padding(cuda):
    q, k, v = _qkv(6, 1, 24, 4608, 4608, 128, cuda)
    seg = _flux_text_pad_segments(1, 512, 77, 4096, cuda)
    dq, dk, dv = _check_backward(q, k, v, seg)
    # padded text rows see no key, and no row sees a padded key: exactly zero
    for grad in (dq, dk, dv):
        assert (grad[:, :, 77:512] == 0).all()


def test_backward_kernels_flux_text_padding_ragged_s(cuda):
    q, k, v = _qkv(13, 1, 24, 4173, 4173, 128, cuda)
    seg = _flux_text_pad_segments(1, 512, 77, 4173 - 512, cuda)
    dq, dk, dv = _check_backward(q, k, v, seg)
    # a whole key tile of pad (keys 128-255) and the pad queries: exact zeros
    for grad in (dq, dk, dv):
        assert (grad[:, :, 77:512] == 0).all()


def test_backward_kernels_packed_segments_ragged(cuda):
    q, k, v = _qkv(7, 2, 2, 300, 300, 32, cuda)
    seg = torch.zeros((2, 300), dtype=torch.int32, device=cuda)
    seg[:, 130:] = 1
    seg[1, 280:] = SEGMENT_PAD_ID
    dq, dk, dv = _check_backward(q, k, v, seg)
    for grad in (dq, dk, dv):
        assert (grad[1, :, 280:] == 0).all()


def test_backward_kernels_cross_attention_pad_key_tiles(cuda):
    # 200 queries of one segment against 512 keys whose second and fourth
    # 128-key blocks are pad: the dq kernel skips those 64-key tiles, the
    # ragged query tile is mixed; pad keys get exactly zero dk and dv
    q, k, v = _qkv(14, 2, 3, 200, 512, 64, cuda)
    q_seg = torch.zeros((2, 200), dtype=torch.int32, device=cuda)
    kv_seg = torch.zeros((2, 512), dtype=torch.int32, device=cuda)
    kv_seg[:, 128:256] = SEGMENT_PAD_ID
    kv_seg[:, 384:] = SEGMENT_PAD_ID
    _, dk, dv = _check_backward(q, k, v, q_seg, kv_seg=kv_seg)
    for grad in (dk, dv):
        assert (grad[:, :, 128:256] == 0).all() and (grad[:, :, 384:] == 0).all()


def test_backward_dq_is_deterministic(cuda):
    # no atomics: two launches on the same inputs give the same bits
    q, k, v = _qkv(15, 1, 24, 4608, 4608, 128, cuda)
    seg = _flux_text_pad_segments(1, 512, 77, 4096, cuda)
    do = torch.randn(q.shape, device=cuda, dtype=torch.bfloat16, generator=torch.Generator(cuda).manual_seed(1))
    out, lse = flash_attention(q, k, v, seg, seg, return_lse=True)
    delta = (out.float() * do.float()).sum(dim=-1)
    first = flash_bwd_dq_kernel(q, k, v, seg, seg, lse, delta, do, 128 ** -0.5)
    second = flash_bwd_dq_kernel(q, k, v, seg, seg, lse, delta, do, 128 ** -0.5)
    assert torch.equal(first, second)


def test_backward_through_the_strided_dispatcher(cuda):
    # autograd through the (B, S, H, D) dispatcher: the kernels read q/k/v/dO
    # through their strides and write gradients in the views' layout; held
    # against autograd through the plain version
    q, k, v = (x.transpose(1, 2).contiguous() for x in _qkv(8, 1, 8, 640, 640, 64, cuda))  # (B, S, H, D)
    do = torch.randn(q.shape, device=cuda, dtype=torch.bfloat16, generator=torch.Generator(cuda).manual_seed(0))
    grads = {}
    for backend in ("pallas_flash", "xla"):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        (dot_product_attention(*leaves, backend=backend).float() * do.float()).sum().backward()
        grads[backend] = [x.grad for x in leaves]
    for grad, ref in zip(grads["pallas_flash"], grads["xla"]):
        assert grad.stride() == q.stride()
        g, r = grad.float(), ref.float()
        assert ((g - r).norm() / r.norm()).item() <= GRAD_REL_L2


@pytest.mark.parametrize("dim", [72, 96, 112])  # pixart, lumina2, sana: zero-padded to 128
@pytest.mark.parametrize("masked", [False, True])
def test_padded_head_dims_match_plain(cuda, dim, masked):
    q, k, v = _qkv(16 + dim, 1, 8, 1000, 1000, dim, cuda)
    seg = _flux_text_pad_segments(1, 512, 77, 1000 - 512, cuda) if masked else None
    out, _ = _check(q, k, v, seg, seg)
    assert out.shape == q.shape
    dq, dk, dv = _check_backward(q, k, v, seg, seed=dim)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    if masked:
        for x in (out, dq, dk, dv):
            assert (x[:, :, 77:512] == 0).all()


def test_graph_replays_are_bitwise_the_eager_steps(cuda):
    # the int8 flagship step at full width, depth cut to 2 + 4 blocks: four
    # eager steps, then four replays of the captured step from the same
    # state and generator state give the same losses, norms and adapters
    import dataclasses

    from simpletuner_tpu_torch.bench import build_run, flagship_config, profile_step
    from simpletuner_tpu_torch.models.flux import FluxConfig
    from simpletuner_tpu_torch.training.quantization import int8_matmul
    from simpletuner_tpu_torch.training.train_state import jit_train_step, state_tensors

    arch = dataclasses.replace(FluxConfig(), depth_double=2, depth_single=4)
    run = build_run(flagship_config("attn", "int8", "full"), arch, seed=3)
    with torch.no_grad():
        saved = [x.clone() for x in state_tensors(run.state)]
    rng = run.generator.get_state()

    def trajectory(step):
        state, out = run.state, []
        for _ in range(4):
            state, metrics = step(state, run.batch, run.generator)
            out += [metrics["loss"], metrics["grad_norm"]]
        return torch.stack(out), torch.cat([p.detach().flatten() for p in state.trainable.values()]).clone()

    eager = trajectory(run.step_fn)
    with torch.no_grad():
        for x, value in zip(state_tensors(run.state), saved):
            x.copy_(value)
    run.generator.set_state(rng)
    graphed = jit_train_step(run.step_fn, run.state, run.batch, run.generator)
    captured = {counter.name: count for counter, count in graphed.captured_launches.items()}
    assert captured == {"flash_fwd": 6 + 2, "flash_bwd_dq": 6, "flash_bwd_dkv": 6, "int_mm": captured["int_mm"]}
    assert captured["int_mm"] > 0
    before = int8_matmul.launches
    replayed = trajectory(graphed)
    assert int8_matmul.launches == before  # a replay runs no wrapper
    assert torch.isfinite(replayed[0]).all()
    assert torch.equal(replayed[0], eager[0]) and torch.equal(replayed[1], eager[1])
    # what a replay launches on the card, as the profiler records it
    recorded = profile_step(lambda: graphed(run.state, run.batch, run.generator))["bucket_launches"]
    assert {name: recorded[name] for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")} == {
        name: count for name, count in captured.items() if name != "int_mm"}
    assert recorded["int8_gemm"] == captured["int_mm"]
    with pytest.raises(ValueError):
        graphed(run.state, run.batch, torch.Generator(device=cuda))


# ---- the quantized base's int8 products (torch._int_mm, not a hand-written kernel) ----------------


@pytest.mark.parametrize("rows", [1, 16, 17, 300])
def test_int8_products_are_exact_on_the_card(cuda, rows):
    from simpletuner_tpu_torch.training.quantization import int8_dynamic_dot, int8_matmul, quantize_weight

    gen = torch.Generator(device=cuda).manual_seed(rows)
    a = torch.randint(-127, 128, (rows, 256), dtype=torch.int8, device=cuda, generator=gen)
    w = torch.randint(-127, 128, (96, 256), dtype=torch.int8, device=cuda, generator=gen)  # stored (out, in)
    assert torch.equal(int8_matmul(a, w.t()).double(), a.double() @ w.double().t())
    with pytest.raises(ValueError, match="K-major"):
        int8_matmul(a[:, :96].contiguous(), w)  # a row-major (k, n) operand
    stored = quantize_weight(torch.randn(96, 256, device=cuda, generator=gen), "int8")
    x = torch.randn(rows, 256, device=cuda, generator=gen).bfloat16().requires_grad_(True)
    y = int8_dynamic_dot(x, stored["weight"], stored["weight_scale"], True)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert y.shape == (rows, 96) and dx.shape == x.shape and torch.isfinite(dx.float()).all()


@pytest.mark.parametrize("precision", ["int8-quanto", "int4-quanto", "fp8-quanto"])
def test_quantized_base_train_step_on_the_card(cuda, precision):
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.flux import Flux
    from simpletuner_tpu_torch.models.layers import LoRADense, init_parameters
    from simpletuner_tpu_torch.training.optimizers import get_optimizer
    from simpletuner_tpu_torch.training.train_state import build_train_step, create_train_state

    config = config_namespace({"model_family": "flux", "model_type": "lora", "lora_rank": 4,
                               "model_arch_preset": "tiny", "mixed_precision": "bf16", "optimizer": "ao-adamw8bit",
                               "learning_rate": 1e-3, "base_model_precision": precision,
                               "gradient_checkpointing": True, "gradient_checkpointing_policy": "dots"})
    model = Flux(config)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.device(cuda):
        module = init_parameters(model.create_module(), gen)
    tx = get_optimizer(config, 1e-3)
    state = create_train_state(model, module, tx, quantize_mode=model.base_precision)
    assert all(m.quant == model.base_precision for m in module.modules() if isinstance(m, LoRADense))
    step = build_train_step(model, tx)
    batch = {"latents": torch.randn(2, 8, 8, 4, device=cuda, generator=gen),
             "t5_embeds": torch.randn(2, 12, 32, device=cuda, generator=gen),
             "pooled_embeds": torch.randn(2, 32, device=cuda, generator=gen)}
    for _ in range(3):
        state, metrics = step(state, batch, gen)
        assert torch.isfinite(metrics["loss"]) and float(metrics["skipped_nonfinite"]) == 0.0
