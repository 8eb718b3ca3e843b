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
    # every head dim up to 256 is taken (zero-padded); above it is refused
    q257 = torch.zeros((1, 2, 128, 257), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError, match="256"):
        flash_attention(q257, q257, q257)


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


# AuraFlow at 1024 px: 12 heads of 256 over 8 register + 256 T5 + 4096 image
# tokens; 4360 is no multiple of the head dim 256 tiles (64 keys forward, 32
# keys dq, 32 queries / 64 keys dkv), so the kernels run their masked mode with
# no caller mask.  The others: unmasked, a cross case against pad key tiles,
# and ragged queries below one tile.
HEAD_DIM_256 = [(1, 12, 4360, 4360), (1, 12, 4096, 4096), (2, 3, 200, 512), (1, 2, 100, 64)]


@pytest.mark.parametrize("batch,heads,sq,sk", HEAD_DIM_256, ids=["auraflow", "unmasked", "cross", "short"])
def test_head_dim_256_kernels_match_plain(cuda, batch, heads, sq, sk):
    q, k, v = _qkv(40 + sq, batch, heads, sq, sk, 256, cuda)
    out, lse = _check(q, k, v)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    dq, dk, dv = _check_backward(q, k, v, seed=sq)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


def test_head_dim_256_packed_segments_and_pad_keys(cuda):
    # two packed samples and a padded tail: pad rows and keys exactly 0
    q, k, v = _qkv(41, 2, 2, 600, 600, 256, cuda)
    seg = torch.zeros((2, 600), dtype=torch.int32, device=cuda)
    seg[:, 260:] = 1
    seg[1, 520:] = SEGMENT_PAD_ID
    out, lse = _check(q, k, v, seg, seg)
    assert (out[1, :, 520:] == 0).all() and (lse[1, :, 520:] == -1e30).all()
    for grad in _check_backward(q, k, v, seg, seed=41):
        assert (grad[1, :, 520:] == 0).all()
    # queries of one segment against keys whose 64-key tiles 2-3 and 6- are pad
    q, k, v = _qkv(42, 2, 3, 200, 512, 256, cuda)
    q_seg = torch.zeros((2, 200), dtype=torch.int32, device=cuda)
    kv_seg = torch.zeros((2, 512), dtype=torch.int32, device=cuda)
    kv_seg[:, 128:256] = SEGMENT_PAD_ID
    kv_seg[:, 384:] = SEGMENT_PAD_ID
    _check(q, k, v, q_seg, kv_seg)
    _, dk, dv = _check_backward(q, k, v, q_seg, kv_seg=kv_seg, seed=42)
    for grad in (dk, dv):
        assert (grad[:, :, 128:256] == 0).all() and (grad[:, :, 384:] == 0).all()


def test_head_dim_256_dq_is_deterministic(cuda):
    q, k, v = _qkv(43, 1, 12, 4360, 4360, 256, cuda)
    do = torch.randn(q.shape, device=cuda, dtype=torch.bfloat16, generator=torch.Generator(cuda).manual_seed(2))
    out, lse = flash_attention(q, k, v, return_lse=True)
    delta = (out.float() * do.float()).sum(dim=-1)
    first = flash_bwd_dq_kernel(q, k, v, None, None, lse, delta, do, 256 ** -0.5)
    second = flash_bwd_dq_kernel(q, k, v, None, None, lse, delta, do, 256 ** -0.5)
    assert torch.equal(first, second)


@pytest.mark.parametrize("dim", [160, 192])  # zero-padded to 256
def test_head_dims_padded_to_256_match_plain(cuda, dim):
    q, k, v = _qkv(44 + dim, 1, 4, 1000, 1000, dim, cuda)
    seg = _flux_text_pad_segments(1, 512, 77, 1000 - 512, cuda)
    out, _ = _check(q, k, v, seg, seg)
    dq, dk, dv = _check_backward(q, k, v, seg, seed=dim)
    assert out.shape == dq.shape == q.shape and dk.shape == dv.shape == k.shape
    for x in (out, dq, dk, dv):
        assert (x[:, :, 77:512] == 0).all()


# SD3.5 Large at 1024 px: 38 heads of 64 over 77 CLIP + 256 T5 + 4096 image
# tokens.  4429 is no multiple of the 128-row tiles, so the kernels run their
# masked mode with no mask from the caller (the ragged tail)
SD35_LARGE = (1, 38, 4429, 64)


def test_kernel_at_the_sd35_large_shape(cuda):
    batch, heads, seq, dim = SD35_LARGE
    q, k, v = _qkv(18, batch, heads, seq, seq, dim, cuda)
    out, lse = _check(q, k, v)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    # the dispatcher's (B, S, H, D) layout, as the SD3 blocks call it
    strided = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
    through = dot_product_attention(*strided, backend="pallas_flash")
    _assert_out_close(through.transpose(1, 2), out)


def test_backward_kernels_at_the_sd35_large_shape(cuda):
    batch, heads, seq, dim = SD35_LARGE
    q, k, v = _qkv(19, batch, heads, seq, seq, dim, cuda)
    dq, dk, dv = _check_backward(q, k, v, seed=19)
    assert dq.shape == dk.shape == dv.shape == q.shape


# SDXL at 1024 px (the JAX preset: attention at all three levels): self-
# attention at (1, 5, 16384, 64), (1, 10, 4096, 64) and (1, 20, 1024, 64), and
# cross-attention of the same queries against 77 CLIP tokens, below one
# 128-key tile: the kernels run their masked mode with no caller mask
SDXL_SELF = [(1, 5, 16384, 64), (1, 10, 4096, 64), (1, 20, 1024, 64)]
SDXL_TEXT = 77


@pytest.mark.parametrize("batch,heads,seq,dim", SDXL_SELF, ids=["level0", "level1", "level2"])
def test_kernels_at_the_sdxl_self_attention_shapes(cuda, batch, heads, seq, dim):
    q, k, v = _qkv(20 + heads, batch, heads, seq, seq, dim, cuda)
    out, lse = _check(q, k, v)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    _check_backward(q, k, v, seed=heads)


@pytest.mark.parametrize("batch,heads,seq,dim", SDXL_SELF, ids=["level0", "level1", "level2"])
def test_kernels_at_the_sdxl_cross_attention_shapes(cuda, batch, heads, seq, dim):
    """Sq queries against 77 keys, through the dispatcher's (B, S, H, D)
    layout as the UNet calls it, forward and backward."""
    q, k, v = _qkv(30 + heads, batch, heads, seq, SDXL_TEXT, dim, cuda)
    _check(q, k, v)
    dq, dk, dv = _check_backward(q, k, v, seed=30 + heads)
    assert dk.shape == dv.shape == k.shape
    strided = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
    _assert_out_close(dot_product_attention(*strided, backend="pallas_flash").transpose(1, 2),
                      mha_reference_lse(q, k, v)[0])


def test_short_keys_never_read_past_their_head(cuda):
    """77 keys per head in a buffer of 128 rows per head whose rows 77-127 hold
    NaN: the 128-key tile runs past each head's keys, and those rows must come
    back as zeros or be masked, never as values (0 x NaN is NaN)."""
    q, k, v = _qkv(40, 2, 10, 1024, SDXL_TEXT, 64, cuda)
    k_buf, v_buf = (torch.full((2, 10, 128, 64), float("nan"), dtype=torch.bfloat16, device=cuda) for _ in range(2))
    k_buf[:, :, :SDXL_TEXT], v_buf[:, :, :SDXL_TEXT] = k, v
    k_view, v_view = k_buf[:, :, :SDXL_TEXT], v_buf[:, :, :SDXL_TEXT]
    out, lse = _check(q, k_view, v_view)
    ref, _ = _check(q, k, v)
    assert torch.equal(out, ref)
    dq, dk, dv = _check_backward(q, k_view, v_view, seed=40)
    assert all(torch.isfinite(g.float()).all() for g in (dq, dk, dv))


def test_tiny_sdxl_unet_on_the_card_matches_its_cpu_run(cuda):
    """The tiny_xl UNet (head dim 16, padded to the kernels' 64) in bf16
    through the kernels on the card against the same weights in f32 on the
    CPU (the plain attention): prediction and LoRA gradients of a linear loss
    within 5e-2 relative L2, the full-width parity bound of chip_smoke.py
    (bf16 rounds every product and the residual stream, 2^-8 per rounding)."""
    from simpletuner_tpu_torch.models.layers import freeze_base, init_parameters
    from simpletuner_tpu_torch.models.unet import UNet2DCondition, UNetConfig

    cfg = UNetConfig.tiny_xl()
    cpu = init_parameters(UNet2DCondition(cfg, dtype=torch.float32, lora_rank=4), torch.Generator().manual_seed(0))
    with torch.no_grad():  # LoRA B starts at zero: give it a draw so the adapters reach the output
        for name, param in cpu.named_parameters():
            if name.endswith("lora_B"):
                param.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    with torch.device(cuda):
        card = UNet2DCondition(cfg, dtype=torch.bfloat16, lora_rank=4)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(2)
    inputs = [torch.randn((2, 32, 32, 4), generator=gen), torch.tensor([999, 250]),
              torch.randn((2, 77, 96), generator=gen), torch.randn((2, 112), generator=gen)]
    weight = torch.randn((2, 32, 32, 4), generator=gen)
    results = []
    for module, device in ((cpu, "cpu"), (card, cuda)):
        params = freeze_base(module)
        out = module(*[x.to(device) for x in inputs])
        grads = torch.autograd.grad((out * weight.to(device)).sum(), list(params.values()))
        results.append((out.float().cpu(), torch.cat([g.float().flatten().cpu() for g in grads])))
    (out_cpu, grad_cpu), (out_card, grad_card) = results
    assert torch.isfinite(out_card).all() and torch.isfinite(grad_card).all()
    assert ((out_card - out_cpu).norm() / out_cpu.norm()).item() <= 5e-2
    assert ((grad_card - grad_cpu).norm() / grad_cpu.norm()).item() <= 5e-2


# SD 1.5, SD 2.1 and PixArt-Sigma at their published sizes: PixArt's 1024 px
# self-attention at D = 72 (zero-padded to 128, scaled by 72^-0.5) and its
# cross-attention against 300 T5 keys with no caller mask (the last key tile
# ragged); SD 2.1's 768 px level 2 (576 tokens, 4.5 key tiles: both Sq and
# Sk ragged) and level 0 (9216 tokens); SD 1.5's 512 px level 2 (256 tokens)
DDPM_FAMILY_CASES = [("pixart_self", 1, 16, 4096, 4096, 72), ("pixart_cross_t5_300", 1, 16, 4096, 300, 72),
                     ("sd21_level2_576", 1, 20, 576, 576, 64), ("sd21_level0_9216", 1, 5, 9216, 9216, 64),
                     ("sd15_level2_256", 1, 20, 256, 256, 64)]


@pytest.mark.parametrize("name,batch,heads,sq,sk,dim", DDPM_FAMILY_CASES, ids=[c[0] for c in DDPM_FAMILY_CASES])
def test_kernels_at_the_sd15_sd21_pixart_shapes(cuda, name, batch, heads, sq, sk, dim):
    """Forward and both backward kernels against the plain versions, in the
    dispatcher's (B, S, H, D) layout as the UNet and the DiT call them; the
    padded head dims never reach the output (its last dim is the caller's)."""
    q, k, v = _qkv(50 + heads + sk % 7, batch, heads, sq, sk, dim, cuda)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    out, lse = _check(*strided)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    dq, dk, dv = _check_backward(*strided, seed=50 + heads)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    _assert_out_close(dot_product_attention(*(x.transpose(1, 2) for x in strided),
                                            backend="pallas_flash").transpose(1, 2), mha_reference_lse(q, k, v)[0])


def _card_against_cpu(cpu, card, inputs, weight, device, allow_unused=False):
    """Prediction and LoRA gradients of a linear loss: the bf16 module through
    the kernels on the card against the f32 module on the CPU (plain
    attention), within 5e-2 relative L2, the full-width parity bound of
    chip_smoke.py (bf16 rounds every product and the residual stream).
    ``allow_unused``: adapters no output reads count as zero gradients."""
    from simpletuner_tpu_torch.models.layers import freeze_base

    with torch.no_grad():  # LoRA B starts at zero: give it a draw so the adapters reach the output
        for name, param in cpu.named_parameters():
            if name.endswith("lora_B"):
                param.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    card.load_state_dict(cpu.state_dict())
    results = []
    for module, where in ((cpu, "cpu"), (card, device)):
        params = freeze_base(module)
        out = module(*[x if x is None else x.to(where) for x in inputs])
        grads = torch.autograd.grad((out * weight.to(where)).sum(), list(params.values()), allow_unused=allow_unused)
        results.append((out.float().cpu(), torch.cat([(torch.zeros_like(p) if g is None else g).float().flatten().cpu()
                                                      for g, p in zip(grads, params.values())])))
    (out_cpu, grad_cpu), (out_card, grad_card) = results
    assert torch.isfinite(out_card).all() and torch.isfinite(grad_card).all()
    assert ((out_card - out_cpu).norm() / out_cpu.norm()).item() <= 5e-2
    assert ((grad_card - grad_cpu).norm() / grad_cpu.norm()).item() <= 5e-2


def test_tiny_sd2x_unet_on_the_card_matches_its_cpu_run(cuda):
    """The tiny UNet of the sd2x family (head dim 16, padded) with remat, on
    a 40 x 40 latent (1600 and 400 ragged tokens) against its CPU run."""
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.sd1x import SD2x

    model = SD2x(config_namespace({"model_family": "sd2x", "model_arch_preset": "tiny", "model_type": "lora",
                                   "lora_rank": 4, "gradient_checkpointing": True, "mixed_precision": "no"}))
    cpu = init_parameters(model.create_module(), torch.Generator().manual_seed(0))
    model.config.mixed_precision = "bf16"
    with torch.device(cuda):
        card = model.create_module()
    gen = torch.Generator().manual_seed(2)
    inputs = [torch.randn((2, 40, 40, 4), generator=gen), torch.tensor([999, 250]),
              torch.randn((2, 77, 32), generator=gen)]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 40, 40, 4), generator=gen), cuda)


def test_tiny_pixart_on_the_card_matches_its_cpu_run(cuda):
    """A tiny PixArt DiT at head dim 72 (padded to 128) with the learned-range
    head, remat, 900 ragged image tokens and 300 unmasked caption tokens,
    against its CPU run."""
    import dataclasses

    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.pixart import PixartConfig, PixartTransformer

    cfg = dataclasses.replace(PixartConfig.tiny(), num_heads=2, head_dim=72, hidden_size=144, out_channels=8)
    cpu = init_parameters(PixartTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=True),
                          torch.Generator().manual_seed(0))
    with torch.device(cuda):
        card = PixartTransformer(cfg, dtype=torch.bfloat16, lora_rank=4, remat=True)
    gen = torch.Generator().manual_seed(3)
    inputs = [torch.randn((2, 60, 60, 4), generator=gen), torch.tensor([999, 250]),
              torch.randn((2, 300, cfg.text_dim), generator=gen)]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 60, 60, 4), generator=gen), cuda)


def test_tiny_auraflow_at_head_dim_256_on_the_card_matches_its_cpu_run(cuda):
    """An AuraFlow DiT two heads of 256 wide (the head dim 256 kernels), one
    joint and two single blocks, remat, a non-square bucket of 960 image
    tokens behind 8 register and 100 caption tokens, against its CPU run;
    the zero-initialised modulations get a draw, so that attention reaches
    the output."""
    from simpletuner_tpu_torch.models.auraflow import AuraFlowConfig, AuraFlowTransformer
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg = AuraFlowConfig(hidden_size=512, depth_double=1, depth_single=2, num_heads=2, text_dim=64)
    cpu = init_parameters(AuraFlowTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=True),
                          torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, param in cpu.named_parameters():
            if "norm1" in name:
                param.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(2))
    with torch.device(cuda):
        card = AuraFlowTransformer(cfg, dtype=torch.bfloat16, lora_rank=4, remat=True)
    gen = torch.Generator().manual_seed(3)
    inputs = [torch.randn((2, 48, 80, 4), generator=gen), torch.tensor([0.9, 0.25]),
              torch.randn((2, 100, cfg.text_dim), generator=gen)]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 48, 80, 4), generator=gen), cuda)



# Wan 2.1 at 832 x 480 x 81 (21 x 30 x 52 = 32,760 tokens after the (1, 2, 2)
# patchify, 255 full 128-row tiles and a ragged tail of 120): the
# self-attention, and the same queries against 512 umT5 keys; two heads, since
# the heads are independent and the plain version's 32,760^2 scores must fit
WAN_TOKENS, WAN_TEXT = 21 * 30 * 52, 512
WAN_CASES = [("wan_self_s32760", 1, 2, WAN_TOKENS, WAN_TOKENS, 128),
             ("wan_cross_t5_512", 1, 2, WAN_TOKENS, WAN_TEXT, 128)]


@pytest.mark.parametrize("name,batch,heads,sq,sk,dim", WAN_CASES, ids=[c[0] for c in WAN_CASES])
def test_kernels_at_the_wan_shapes(cuda, name, batch, heads, sq, sk, dim):
    """Forward and both backward kernels at Wan's shapes against the plain
    versions, in the dispatcher's (B, S, H, D) layout as the DiT calls them
    (the 14B's 40 heads are these heads, 20 times over)."""
    q, k, v = _qkv(60 + sk % 11, batch, heads, sq, sk, dim, cuda)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    out, lse = _check(*strided)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    del out, lse
    dq, dk, dv = _check_backward(*strided, seed=61)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


def test_tiny_wan_on_the_card_matches_its_cpu_run(cuda):
    """A Wan DiT two heads of 128 wide (the head dim 128 kernels, Wan's RoPE
    axes 44 / 42 / 42), two blocks, remat, 5 x 8 x 14 latents (140 ragged
    tokens) and 40 text tokens, against its CPU run."""
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.wan import WanConfig, WanTransformer

    cfg = WanConfig(in_channels=4, hidden_size=256, depth=2, num_heads=2, head_dim=128, text_dim=64)
    cpu = init_parameters(WanTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=True),
                          torch.Generator().manual_seed(0))
    with torch.device(cuda):
        card = WanTransformer(cfg, dtype=torch.bfloat16, lora_rank=4, remat=True)
    gen = torch.Generator().manual_seed(3)
    inputs = [torch.randn((2, 5, 8, 14, 4), generator=gen), torch.tensor([0.9, 0.25]),
              torch.randn((2, 40, cfg.text_dim), generator=gen)]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 5, 8, 14, 4), generator=gen), cuda)


# LTX-Video at 768 x 512 x 121 (16 x 16 x 24 = 6,144 latent tokens, 48 full
# 128-row tiles): the 2B's self-attention at head dim 64, the same queries
# against 128 T5 keys (exactly one key tile), and the 13B's self-attention at
# head dim 128; two heads (the heads are independent)
LTX_TOKENS, LTX_TEXT = 16 * 16 * 24, 128
LTX_CASES = [("ltx_self_s6144_d64", 1, 2, LTX_TOKENS, LTX_TOKENS, 64),
             ("ltx_cross_t5_128_d64", 1, 2, LTX_TOKENS, LTX_TEXT, 64),
             ("ltx13b_self_s6144_d128", 1, 2, LTX_TOKENS, LTX_TOKENS, 128)]


@pytest.mark.parametrize("name,batch,heads,sq,sk,dim", LTX_CASES, ids=[c[0] for c in LTX_CASES])
def test_kernels_at_the_ltx_shapes(cuda, name, batch, heads, sq, sk, dim):
    """Forward and both backward kernels at LTX-Video's shapes against the
    plain versions, in the dispatcher's (B, S, H, D) layout as the DiT calls
    them (the published 32 heads are these heads, 16 times over)."""
    q, k, v = _qkv(70 + sk % 11 + dim, batch, heads, sq, sk, dim, cuda)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    out, lse = _check(*strided)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    del out, lse
    dq, dk, dv = _check_backward(*strided, seed=71)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


def test_tiny_ltx_on_the_card_matches_its_cpu_run(cuda):
    """An LTX DiT two heads of 64 wide (the head dim 64 kernels; inner 128,
    so the RoPE tables pad 2 entries), two blocks, remat, per-frame
    timesteps, 3 x 8 x 12 latents (288 ragged tokens) and 40 text tokens,
    against its CPU run."""
    import dataclasses

    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.ltxvideo import LTXConfig, LTXTransformer

    cfg = dataclasses.replace(LTXConfig.tiny(), hidden_size=128, num_heads=2, head_dim=64, text_dim=64)
    cpu = init_parameters(LTXTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=True),
                          torch.Generator().manual_seed(0))
    with torch.device(cuda):
        card = LTXTransformer(cfg, dtype=torch.bfloat16, lora_rank=4, remat=True)
    gen = torch.Generator().manual_seed(3)
    inputs = [torch.randn((2, 3, 8, 12, 8), generator=gen), torch.tensor([[0.0, 0.9, 0.9], [0.02, 0.25, 0.25]]),
              torch.randn((2, 40, cfg.text_dim), generator=gen)]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 3, 8, 12, 8), generator=gen), cuda)


# Lumina-Image 2.0 at 1024 px: 24 query heads of 96 (zero-padded to 128 by
# the wrappers, scaled by 96^-0.5) over the joint [256 caption, 4096 image]
# tokens with a caption-mask segment plane (180 valid caption tokens and the
# image at 1, the 76 pads at 0, not -1: the JAX module's ids), the noise
# refiners' 4096 image tokens unmasked and the context refiners' 256 caption
# tokens masked; two heads (the heads are independent)
LUMINA_CASES = [("lumina_joint_s4352_d96", 4352, 180), ("lumina_noise_refiner_s4096_d96", 4096, None),
                ("lumina_context_refiner_s256_d96", 256, 180)]


@pytest.mark.parametrize("name,seq,valid", LUMINA_CASES, ids=[c[0] for c in LUMINA_CASES])
def test_kernels_at_the_lumina2_shapes(cuda, name, seq, valid):
    """Forward and both backward kernels at Lumina2's D = 96 shapes against
    the plain versions, in the dispatcher's (B, S, H, D) layout; a pad
    token's gradients are not zero here (pads attend to each other)."""
    q, k, v = _qkv(80 + seq % 13, 1, 2, seq, seq, 96, cuda)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    seg = None
    if valid is not None:
        seg = torch.ones((1, seq), dtype=torch.int32, device=cuda)
        seg[:, valid:256] = 0
    out, lse = _check(*strided, seg, seg)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    del out, lse
    dq, dk, dv = _check_backward(*strided, seg, seed=81)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    if valid is not None:
        assert dq[0, :, valid:256].abs().max() > 0


def test_tiny_chroma_on_the_card_matches_its_cpu_run(cuda):
    """A Chroma DiT two heads of 128 wide (the head dim 128 kernels), one
    double and two single blocks, remat, 6 x 8 latents and 20 T5 tokens with
    the padding masked (segment id -1), against its CPU run."""
    import dataclasses

    from simpletuner_tpu_torch.models.chroma import ChromaConfig, ChromaTransformer
    from simpletuner_tpu_torch.models.flux import make_img_ids, make_txt_ids
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg = dataclasses.replace(ChromaConfig.tiny(), hidden_size=256, num_heads=2, head_dim=128, depth_double=1,
                              axes_dim=(16, 56, 56))
    cpu = init_parameters(ChromaTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=True),
                          torch.Generator().manual_seed(0))
    with torch.device(cuda):
        card = ChromaTransformer(cfg, dtype=torch.bfloat16, lora_rank=4, remat=True)
    gen = torch.Generator().manual_seed(3)
    seg = torch.cat([torch.where(torch.arange(20) < 9, 0, -1)[None].expand(2, 20),
                     torch.zeros((2, 12), dtype=torch.int64)], dim=1).to(torch.int32)
    inputs = [torch.randn((2, 12, 16), generator=gen), make_img_ids(2, 6, 8), torch.randn((2, 20, 32), generator=gen),
              make_txt_ids(2, 20), torch.tensor([0.3, 0.8]), torch.zeros(2, 768), torch.zeros(2), seg]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 12, 16), generator=gen), cuda)


def test_tiny_lumina2_on_the_card_matches_its_cpu_run(cuda):
    """A Lumina2 DiT with 4 query and 2 kv heads of 96 (the padded D = 96
    path, GQA repeated before the op), one refiner of each kind and two joint
    blocks, remat, 8 x 6 latents and 24 caption tokens with 10 and 24 valid
    (pads at segment id 0), against its CPU run."""
    import dataclasses

    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.lumina2 import Lumina2Config, Lumina2Transformer

    cfg = dataclasses.replace(Lumina2Config.tiny(), hidden_size=384, num_heads=4, num_kv_heads=2,
                              axes_dim=(32, 32, 32), multiple_of=64)
    cpu = init_parameters(Lumina2Transformer(cfg, dtype=torch.float32, lora_rank=4, remat=True),
                          torch.Generator().manual_seed(0))
    with torch.device(cuda):
        card = Lumina2Transformer(cfg, dtype=torch.bfloat16, lora_rank=4, remat=True)
    gen = torch.Generator().manual_seed(3)
    mask = (torch.arange(24)[None] < torch.tensor([[10], [24]])).to(torch.int32)
    inputs = [torch.randn((2, 8, 6, 4), generator=gen), torch.tensor([0.3, 0.8]),
              torch.randn((2, 24, cfg.cap_feat_dim), generator=gen), mask]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 8, 6, 4), generator=gen), cuda)


# Kandinsky 5.0 Lite at 768 x 512 x 61 frames (16 x 32 x 48 = 24,576 visual
# tokens after the (1, 2, 2) patchify, 192 full 128-row tiles): the video
# self-attention at head dim 64, unmasked, and the same queries against the
# 512 Qwen2.5-VL keys (unmasked: the JAX family drops the mask); HunyuanVideo
# 1.5 at 848 x 480 x 17 frames: the joint attention over 31,800 video tokens
# then 256 Qwen and 77 ByT5 tokens (32,133) at head dim 128 with a segment
# plane (180 and 40 valid, the pads at -1), and the token refiner's 256 Qwen
# tokens (180 valid); two heads (the heads are independent)
K5_TOKENS, K5_TEXT = 16 * 32 * 48, 512
HY_VIDEO, HY_QWEN, HY_BYT5 = 5 * 60 * 106, 256, 77
QWEN_CASES = [("k5_self_s24576_d64", K5_TOKENS, K5_TOKENS, 64, None),
              ("k5_cross_512_d64", K5_TOKENS, K5_TEXT, 64, None),
              ("hy_joint_s32133_d128", HY_VIDEO + HY_QWEN + HY_BYT5, HY_VIDEO + HY_QWEN + HY_BYT5, 128, "joint"),
              ("hy_refiner_s256_d128", HY_QWEN, HY_QWEN, 128, "refiner")]


def _hunyuan_segments(kind, device):
    """The joint plane (video at 0, then the valid Qwen and ByT5 tokens at 0
    and their pads at -1) or the refiner's (180 of 256 Qwen tokens valid)."""
    qwen = torch.where(torch.arange(HY_QWEN) < 180, 0, -1)
    if kind == "refiner":
        return qwen[None].to(device, torch.int32)
    byt5 = torch.where(torch.arange(HY_BYT5) < 40, 0, -1)
    return torch.cat([torch.zeros(HY_VIDEO, dtype=torch.int64), qwen, byt5])[None].to(device, torch.int32)


@pytest.mark.parametrize("name,sq,sk,dim,segments", QWEN_CASES, ids=[c[0] for c in QWEN_CASES])
def test_kernels_at_the_kandinsky5_and_hunyuanvideo_shapes(cuda, name, sq, sk, dim, segments):
    """Forward and both backward kernels at Kandinsky 5.0's and HunyuanVideo
    1.5's shapes against the plain versions, in the dispatcher's (B, S, H, D)
    layout; a pad's rows come out 0 and its gradients 0."""
    q, k, v = _qkv(90 + sk % 13 + dim, 1, 2, sq, sk, dim, cuda)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    seg = None if segments is None else _hunyuan_segments(segments, cuda)
    out, lse = _check(*strided, seg, seg)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    if seg is not None:
        assert out[0, :, (seg[0] < 0)].abs().max() == 0
    del out, lse
    dq, dk, dv = _check_backward(*strided, seg, seed=91)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    if seg is not None:
        pads = seg[0] < 0
        assert dq[0, :, pads].abs().max() == dk[0, :, pads].abs().max() == dv[0, :, pads].abs().max() == 0


def test_tiny_kandinsky5_on_the_card_matches_its_cpu_run(cuda):
    """A Kandinsky 5.0 DiT two heads of 64 wide (the head dim 64 kernels, the
    published rope axes 16 / 24 / 24), one text and two visual blocks, remat,
    tokenwise timesteps over 3 x 8 x 12 latents (72 ragged tokens) and 40
    text tokens, its zero-initialised modulation heads given a draw, against
    its CPU run."""
    import dataclasses

    from simpletuner_tpu_torch.models.kandinsky5 import Kandinsky5Config, Kandinsky5Transformer
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg = dataclasses.replace(Kandinsky5Config.tiny(), model_dim=128, ff_dim=256, axes_dims=(16, 24, 24))
    cpu = init_parameters(Kandinsky5Transformer(cfg, dtype=torch.float32, lora_rank=4, remat=True),
                          torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, param in cpu.named_parameters():
            if "modulation.out_layer.weight" in name:
                param.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(2))
    with torch.device(cuda):
        card = Kandinsky5Transformer(cfg, dtype=torch.bfloat16, lora_rank=4, remat=True)
    gen = torch.Generator().manual_seed(3)
    inputs = [torch.randn((2, 3, 8, 12, 4), generator=gen), torch.randn((2, 40, cfg.in_text_dim), generator=gen),
              torch.randn((2, cfg.in_text_dim2), generator=gen), torch.rand((2, 72), generator=gen) * 1000]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 3, 8, 12, 4), generator=gen), cuda)


def test_tiny_hunyuanvideo_on_the_card_matches_its_cpu_run(cuda):
    """A HunyuanVideo DiT two heads of 128 wide (the head dim 128 kernels,
    the published rope axes 16 / 56 / 56), one refiner and two dual-stream
    blocks, remat, 2 x 6 x 10 latents, 24 Qwen tokens (9 and 24 valid) and
    8 ByT5 tokens (3 and 8 valid), pads at -1, against its CPU run (the
    last block's text-stream adapters, which no gradient reaches, removed)."""
    import dataclasses

    from simpletuner_tpu_torch.models.hunyuanvideo import HunyuanVideo15Config, HunyuanVideo15Transformer
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg = dataclasses.replace(HunyuanVideo15Config.tiny(), num_heads=2, head_dim=128, axes_dim=(16, 56, 56))
    cpu = init_parameters(HunyuanVideo15Transformer(cfg, dtype=torch.float32, lora_rank=4, remat=True),
                          torch.Generator().manual_seed(0))
    with torch.device(cuda):
        card = HunyuanVideo15Transformer(cfg, dtype=torch.bfloat16, lora_rank=4, remat=True)
    for module in (cpu, card):  # the last block's text-stream output is never read: no gradient reaches these
        for name in ("txt_attn_proj", "txt_mlp_in", "txt_mlp_out"):
            getattr(getattr(module, f"block_{cfg.depth - 1}"), name).remove_adapter()
    gen = torch.Generator().manual_seed(3)
    inputs = [torch.randn((2, 2, 6, 10, cfg.in_channels), generator=gen), torch.tensor([0.3, 0.8]),
              torch.randn((2, 24, cfg.text_dim), generator=gen),
              (torch.arange(24)[None] < torch.tensor([[9], [24]])).to(torch.int32),
              torch.randn((2, 8, cfg.text2_dim), generator=gen),
              (torch.arange(8)[None] < torch.tensor([[3], [8]])).to(torch.int32)]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 2, 6, 10, cfg.out_channels), generator=gen), cuda)


# Qwen-Image at 1024 x 1024 (64 x 64 = 4,096 packed tokens) after its 1,024
# unmasked Qwen tokens (5,120); Z-Image with 4,096 text tokens (8,192);
# HiDream-I1 at 1024 x 1024: 4,096 image tokens, 128 T5, 128 Llama[last] and
# the block's 128 Llama tokens (4,480), all unmasked at head dim 128; two
# heads (the heads are independent)
QWEN_IMAGE_CASES = [("qwen_image_joint_s5120", 4096 + 1024), ("z_image_joint_s8192", 4096 + 4096),
                    ("hidream_joint_s4480", 4096 + 3 * 128)]


@pytest.mark.parametrize("name,seq", QWEN_IMAGE_CASES, ids=[c[0] for c in QWEN_IMAGE_CASES])
def test_kernels_at_the_qwen_image_and_hidream_shapes(cuda, name, seq):
    """Forward and both backward kernels at Qwen-Image's, Z-Image's and
    HiDream's joint attention against the plain versions, in the
    dispatcher's (B, S, H, D) layout, unmasked."""
    q, k, v = _qkv(70 + seq % 17, 1, 2, seq, seq, 128, cuda)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    out, lse = _check(*strided)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    del out, lse
    dq, dk, dv = _check_backward(*strided, seed=71)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


class _OnGrid(torch.nn.Module):
    """The Qwen-Image DiT with its token grid fixed, so its inputs are tensors."""

    def __init__(self, inner, grid):
        super().__init__()
        self.inner, self.grid = inner, grid

    def forward(self, img, txt, timesteps):
        return self.inner(img, self.grid, txt, timesteps)


@pytest.mark.parametrize("txt_rope", [True, False])
def test_tiny_qwen_image_on_the_card_matches_its_cpu_run(cuda, txt_rope):
    """A Qwen-Image DiT two heads of 128 wide (the head dim 128 kernels, the
    published rope axes 16 / 56 / 56), two blocks, remat, a 6 x 10 token
    grid and 24 unmasked text tokens, with text rope (Qwen-Image) and
    without (Z-Image, MageFlow), against its CPU run (the last block's
    text-stream adapters, which no gradient reaches, removed)."""
    import dataclasses

    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.qwen_image import QwenImageConfig, QwenImageTransformer

    cfg = dataclasses.replace(QwenImageConfig.tiny(), hidden_size=256, num_heads=2, head_dim=128,
                              axes_dim=(16, 56, 56), txt_rope=txt_rope)
    cpu = _OnGrid(init_parameters(QwenImageTransformer(cfg, dtype=torch.float32, lora_rank=4, remat=True),
                                  torch.Generator().manual_seed(0)), (6, 10))
    with torch.device(cuda):
        card = _OnGrid(QwenImageTransformer(cfg, dtype=torch.bfloat16, lora_rank=4, remat=True), (6, 10))
    for module in (cpu, card):  # the last block's text-stream output is never read: no gradient reaches these
        for name in ("txt_attn_q", "txt_attn_proj", "txt_mlp_in", "txt_mlp_out"):
            getattr(getattr(module.inner, f"block_{cfg.depth - 1}"), name).remove_adapter()
    gen = torch.Generator().manual_seed(3)
    inputs = [torch.randn((2, 60, cfg.in_channels), generator=gen), torch.randn((2, 24, cfg.txt_in_features),
                                                                                   generator=gen),
              torch.tensor([0.3, 0.8])]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 60, cfg.in_channels), generator=gen), cuda)


def _tiny_hidream(dtype, device, remat=True):
    """A HiDream DiT two heads of 128 wide (the head dim 128 kernels, the
    published rope axes 64 / 32 / 32), one double and two single blocks,
    four experts top-2."""
    import dataclasses

    from simpletuner_tpu_torch.models.hidream import HiDreamConfig, HiDreamTransformer

    cfg = dataclasses.replace(HiDreamConfig.tiny(), num_heads=2, head_dim=128, axes_dim=(64, 32, 32), num_experts=4,
                              top_k=2)
    with torch.device(device):
        return cfg, HiDreamTransformer(cfg, dtype=dtype, lora_rank=4, remat=remat)


def test_tiny_hidream_on_the_card_matches_its_cpu_run(cuda):
    """The tiny HiDream DiT (``_tiny_hidream``), remat, 12 x 20 latents, 8 T5
    and two layers of 6 Llama tokens, its zero-initialised adaLN given a
    draw, against its CPU run."""
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg, cpu = _tiny_hidream(torch.float32, "cpu")
    init_parameters(cpu, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, param in cpu.named_parameters():
            if name.endswith(("ada.weight", "final_mod.weight")):
                param.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(2))
    _, card = _tiny_hidream(torch.bfloat16, cuda)
    gen = torch.Generator().manual_seed(3)
    inputs = [torch.randn((2, 12, 20, cfg.in_channels), generator=gen), torch.tensor([0.3, 0.8]),
              torch.randn((2, 8, cfg.t5_dim), generator=gen), torch.randn((2, 2, 6, cfg.llama_dim), generator=gen),
              torch.randn((2, cfg.pooled_dim), generator=gen)]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 12, 20, cfg.in_channels), generator=gen), cuda)


def test_graphed_hidream_step_carries_moe_gate_loss_bitwise(cuda):
    """The aux repair on the card: the tiny HiDream LoRA step with the
    load-balancing loss, three eager steps and then three replays of the
    captured step from the same state and generator state give the same
    losses, grad norms and ``moe_gate_loss`` bitwise (the metric a static
    buffer the graph writes)."""
    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.hidream import HiDream
    from simpletuner_tpu_torch.models.layers import init_parameters, lecun_normal_
    from simpletuner_tpu_torch.training.optimizers import get_optimizer
    from simpletuner_tpu_torch.training.train_state import (build_train_step, create_train_state, jit_train_step,
                                                            state_tensors)

    config = TrainingConfig({"model_family": "hidream", "model_arch_preset": "tiny", "model_type": "lora",
                             "lora_rank": 4, "learning_rate": 1e-3, "optimizer": "adamw",
                             "hidream_use_load_balancing_loss": True, "gradient_checkpointing": True})
    model = HiDream(config)
    model.arch, module = _tiny_hidream(torch.bfloat16, cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    init_parameters(module, gen)
    with torch.no_grad():  # AdaLN-Zero: zero gates close every block to the adapters
        for name, param in module.named_parameters():
            if name.endswith(("ada.weight", "final_mod.weight")):
                lecun_normal_(param, param.shape[1], gen)
    tx = get_optimizer(config, 1e-3)
    state = create_train_state(model, module, tx)
    step_fn = build_train_step(model, tx)
    batch = {"latents": torch.randn((1, 12, 20, 4), generator=gen, device=cuda),
             "t5_embeds": torch.randn((1, 8, 32), generator=gen, device=cuda),
             "llama_embeds": torch.randn((1, 1, 6, 32), generator=gen, device=cuda),
             "pooled_embeds": torch.randn((1, 32), generator=gen, device=cuda)}
    with torch.no_grad():
        saved = [x.clone() for x in state_tensors(state)]
    rng = torch.Generator(device=cuda)
    rng.manual_seed(5)
    start = rng.get_state()

    def trajectory(step):
        current, out = state, []
        for _ in range(3):
            current, metrics = step(current, batch, rng)
            out += [metrics["loss"], metrics["grad_norm"], metrics["moe_gate_loss"]]
        return torch.stack(out)

    eager = trajectory(step_fn)
    with torch.no_grad():
        for x, value in zip(state_tensors(state), saved):
            x.copy_(value)
    rng.set_state(start)
    state.step = 0
    graphed = jit_train_step(step_fn, state, batch, rng)
    replayed = trajectory(graphed)
    assert torch.isfinite(eager).all() and (eager[2::3] > 0).all()
    assert torch.equal(replayed, eager)


# FLUX.2 at 1024 x 1024: 4,096 image tokens after 512 Mistral tokens (4,608
# joint, unmasked, head dim 128; 48 heads at dev, 24 at klein); Kolors's
# cross-attention at SDXL's three levels against 256 unmasked ChatGLM keys
# (head dim 64; its self-attention shapes are SDXL's); two heads (the heads
# are independent)
FLUX2_KOLORS_CASES = [("flux2_joint_s4608", 4608, 4608, 128), ("kolors_l0_cross_k256", 16384, 256, 64),
                      ("kolors_l1_cross_k256", 4096, 256, 64), ("kolors_l2_cross_k256", 1024, 256, 64)]


@pytest.mark.parametrize("name,sq,sk,dim", FLUX2_KOLORS_CASES, ids=[c[0] for c in FLUX2_KOLORS_CASES])
def test_kernels_at_the_flux2_and_kolors_shapes(cuda, name, sq, sk, dim):
    """Forward and both backward kernels at FLUX.2's joint attention and
    Kolors's cross-attention against the plain versions, in the
    dispatcher's (B, S, H, D) layout, unmasked."""
    q, k, v = _qkv(80 + sq % 19, 1, 2, sq, sk, dim, cuda)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    out, lse = _check(*strided)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    del out, lse
    dq, dk, dv = _check_backward(*strided, seed=81)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


def _tiny_flux2(dtype, device, guidance_embed=True):
    """A FLUX.2 DiT two heads of 128 wide (the head dim 128 kernels, the
    published four rope axes of 32), 1 + 1 blocks, remat, rank-4 adapters."""
    import dataclasses

    from simpletuner_tpu_torch.models.flux2 import Flux2Config, Flux2Transformer

    cfg = dataclasses.replace(Flux2Config.tiny(), num_heads=2, head_dim=128, depth_single=1,
                              axes_dim=(32, 32, 32, 32), guidance_embed=guidance_embed)
    with torch.device(device):
        return cfg, Flux2Transformer(cfg, dtype=dtype, lora_rank=4, remat=True)


@pytest.mark.parametrize("guidance_embed", [True, False], ids=["dev", "klein"])
def test_tiny_flux2_on_the_card_matches_its_cpu_run(cuda, guidance_embed):
    """The tiny FLUX.2 DiT (``_tiny_flux2``), with the guidance embedding
    (dev) and without (klein), 12 x 20 latents (60 image tokens) after 24
    unmasked text tokens, against its CPU run."""
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg, cpu = _tiny_flux2(torch.float32, "cpu", guidance_embed)
    init_parameters(cpu, torch.Generator().manual_seed(0))
    _, card = _tiny_flux2(torch.bfloat16, cuda, guidance_embed)
    gen = torch.Generator().manual_seed(3)
    inputs = [torch.randn((2, 12, 20, cfg.in_channels), generator=gen), torch.tensor([0.3, 0.8]),
              torch.randn((2, 24, cfg.txt_in_features), generator=gen)]
    if guidance_embed:
        inputs.append(torch.tensor([3.5, 4.0]))
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 12, 20, cfg.in_channels), generator=gen), cuda)


def _tiny_kolors(dtype, device):
    """The Kolors UNet at head dim 64 (the kernels' 64 instance): two levels
    of 64 and 128 channels, the cross-attention over 32-wide ChatGLM states
    and the 32-wide pooled vector, remat, rank-4 adapters."""
    import dataclasses

    from simpletuner_tpu_torch.models.unet import UNet2DCondition, UNetConfig

    cfg = dataclasses.replace(UNetConfig.tiny_xl(), block_out_channels=(64, 128), attention_head_dim=64,
                              cross_attention_dim=32, addition_embed_dim=6 * 8 + 32)
    with torch.device(device):
        return cfg, UNet2DCondition(cfg, dtype=dtype, lora_rank=4, remat=True)


def test_tiny_kolors_unet_on_the_card_matches_its_cpu_run(cuda):
    """The tiny Kolors UNet (``_tiny_kolors``) on a 32 x 32 latent (1,024 and
    256 tokens) with 40 unmasked ChatGLM states, against its CPU run."""
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.unet import make_sdxl_added_cond

    cfg, cpu = _tiny_kolors(torch.float32, "cpu")
    init_parameters(cpu, torch.Generator().manual_seed(0))
    _, card = _tiny_kolors(torch.bfloat16, cuda)
    gen = torch.Generator().manual_seed(2)
    added = make_sdxl_added_cond(torch.tensor([[256.0, 256.0, 0.0, 0.0, 256.0, 256.0]] * 2),
                                 torch.randn((2, 32), generator=gen), cfg.addition_time_embed_dim)
    inputs = [torch.randn((2, 32, 32, 4), generator=gen), torch.tensor([999, 250]),
              torch.randn((2, 40, 32), generator=gen), added]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 32, 32, 4), generator=gen), cuda)


@pytest.mark.parametrize("family", ["flux2", "kolors"])
def test_graphed_flux2_and_kolors_steps_match_eager_bitwise(cuda, family):
    """The tiny FLUX.2 (head dim 128) and Kolors (head dim 64, min-SNR) LoRA
    steps on the card: three eager steps and then three replays of the
    captured step from the same state and generator state give the same
    losses and grad norms bitwise."""
    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.flux2 import Flux2
    from simpletuner_tpu_torch.models.kolors import Kolors
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.training.optimizers import get_optimizer
    from simpletuner_tpu_torch.training.train_state import (build_train_step, create_train_state, jit_train_step,
                                                            state_tensors)

    config = TrainingConfig({"model_family": family, "model_arch_preset": "tiny", "model_type": "lora",
                             "lora_rank": 4, "learning_rate": 1e-3, "optimizer": "adamw",
                             "gradient_checkpointing": True, "snr_gamma": 5.0})
    gen = torch.Generator(device=cuda).manual_seed(8)
    if family == "flux2":
        model = Flux2(config)
        model.arch, module = _tiny_flux2(torch.bfloat16, cuda)
        batch = {"latents": torch.randn((1, 12, 20, 4), generator=gen, device=cuda),
                 "text_embeds": torch.randn((1, 24, 32), generator=gen, device=cuda)}
    else:
        model = Kolors(config)
        model.arch, module = _tiny_kolors(torch.bfloat16, cuda)
        # the collate's size arrays, as every trainer batch carries them (without them the
        # step would make its default time ids from a host list, which a capture cannot copy)
        batch = {"latents": torch.randn((1, 32, 32, 4), generator=gen, device=cuda),
                 "text_embeds": torch.randn((1, 40, 32), generator=gen, device=cuda),
                 "pooled_embeds": torch.randn((1, 32), generator=gen, device=cuda),
                 "original_sizes": torch.tensor([[256, 256]], dtype=torch.int32, device=cuda),
                 "crop_coordinates": torch.tensor([[0, 0]], dtype=torch.int32, device=cuda),
                 "target_sizes": torch.tensor([[256, 256]], dtype=torch.int32, device=cuda)}
    init_parameters(module, gen)
    tx = get_optimizer(config, 1e-3)
    state = create_train_state(model, module, tx)
    step_fn = build_train_step(model, tx)
    with torch.no_grad():
        saved = [x.clone() for x in state_tensors(state)]
    rng = torch.Generator(device=cuda)
    rng.manual_seed(5)
    start = rng.get_state()

    def trajectory(step):
        current, out = state, []
        for _ in range(3):
            current, metrics = step(current, batch, rng)
            out += [metrics["loss"], metrics["grad_norm"]]
        return torch.stack(out)

    eager = trajectory(step_fn)
    with torch.no_grad():
        for x, value in zip(state_tensors(state), saved):
            x.copy_(value)
    rng.set_state(start)
    state.step = 0
    graphed = jit_train_step(step_fn, state, batch, rng)
    replayed = trajectory(graphed)
    assert torch.isfinite(eager).all() and (eager[1::2] > 0).all()
    assert torch.equal(replayed, eager)


def test_video_vae_on_the_card(cuda, monkeypatch):
    """The causal video VAE on the card in f32 against the CPU (sum order
    only), with its norms and convolutions split into runs of frames as at
    81 x 480 x 832, and bf16 (the trainer's) against f32."""
    from simpletuner_tpu_torch.models import video_vae
    from simpletuner_tpu_torch.models.layers import init_parameters

    config = video_vae.VideoVAEConfig(base_channels=32)
    vae = init_parameters(video_vae.VideoAutoencoderKL(config, torch.float32), torch.Generator().manual_seed(1))
    clip = torch.rand((1, 9, 64, 48, 3), generator=torch.Generator().manual_seed(2)) * 2 - 1
    with torch.no_grad():
        ref = vae.encode(clip)
        frames = vae.decode(ref)
        card = vae.to(cuda)
        monkeypatch.setattr(video_vae, "CONV_CHUNK_ELEMENTS", 2 ** 18)
        monkeypatch.setattr(video_vae, "NORM_CHUNK_ELEMENTS", 2 ** 16)
        split = card.encode(clip.to(cuda))
        split_frames = card.decode(split)
        half = video_vae.VideoAutoencoderKL(config).to(cuda)
        half.load_state_dict(vae.state_dict())
        low = half.encode(clip.to(cuda)).float()
    assert split.shape == ref.shape == (1, 3, 8, 6, 16) and split_frames.shape == frames.shape
    assert float((split.cpu() - ref).norm() / ref.norm()) < 1e-5
    assert float((split_frames.cpu() - frames).norm() / frames.norm()) < 1e-5
    assert float((low.cpu() - ref).norm() / ref.norm()) < 5e-2

def test_sd3_blocks_on_the_card_match_the_plain_attention(cuda):
    """Two SD3.5 Large blocks at full width, 512 px (333 text + 1024 image
    tokens): velocity and LoRA gradients through the kernels against the
    plain attention under autograd, within the full-width parity bound of
    chip_smoke.py (5e-2 relative L2: each attention output and gradient
    differs by about one bf16 rounding)."""
    import dataclasses

    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.layers import freeze_base, init_parameters
    from simpletuner_tpu_torch.models.sd3 import SD3, SD3Config
    from simpletuner_tpu_torch.ops import set_attention_backend

    arch = dataclasses.replace(SD3Config.large(), depth=2)
    model = SD3(config_namespace({"model_family": "sd3", "model_type": "lora", "lora_rank": 4}), arch=arch)
    gen = torch.Generator(cuda).manual_seed(3)
    with torch.device(cuda):
        module = init_parameters(model.create_module(), gen)
    with torch.no_grad():  # AdaLN-Zero and LoRA B start at zero: give them a draw
        for name, param in module.named_parameters():
            if name.endswith(("lin.weight", "lora_B")):
                param.normal_(0.0, 0.02, generator=gen)
    params = freeze_base(module)
    batch = {"latents": torch.randn((1, 64, 64, 16), generator=gen, device=cuda),
             "text_embeds": torch.randn((1, 333, 4096), generator=gen, device=cuda),
             "pooled_embeds": torch.randn((1, 2048), generator=gen, device=cuda),
             "override_noise": torch.randn((1, 64, 64, 16), generator=gen, device=cuda),
             "override_sigmas": torch.full((1,), 0.6, device=cuda)}

    def grads():
        loss, _ = model.loss_fn(module, gen, batch)
        return torch.cat([g.flatten() for g in torch.autograd.grad(loss, list(params.values()))])

    kernel = grads()
    set_attention_backend("xla")
    try:
        plain = grads()
    finally:
        set_attention_backend("auto")
    assert torch.isfinite(kernel).all() and plain.norm() > 0
    assert ((kernel - plain).norm() / plain.norm()).item() <= 5e-2


def test_graph_replays_are_bitwise_the_eager_steps(cuda):
    # the int8 flagship step at full width, depth cut to 2 + 4 blocks: four
    # eager steps, then four replays of the captured step from the same
    # state and generator state give the same losses, norms and adapters
    import dataclasses

    from simpletuner_tpu_torch.bench import build_run, flagship_config, replay_launches
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
    # what a replay launches on the card, as the profiler's trace records it
    # (profiled again where the record falls short, bench.replay_launches)
    checked = replay_launches(lambda: graphed(run.state, run.batch, run.generator), captured,
                              {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd_dq",
                               "flash_bwd_dkv": "flash_bwd_dkv", "int_mm": "int8_gemm"})
    assert checked["launch_attempts"][-1] == captured
    with pytest.raises(ValueError):
        graphed(run.state, run.batch, torch.Generator(device=cuda))


def _tiny_trainer_run(device):
    """Tiny Flux (bf16, masked attention, EMA) as the trainer builds it: the
    state, the step, and batches of two aspect buckets."""
    from simpletuner_tpu_torch.bench import perturb_adaln
    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.flux import Flux
    from simpletuner_tpu_torch.models.layers import init_parameters, lora_parameters
    from simpletuner_tpu_torch.training.ema import EMAConfig
    from simpletuner_tpu_torch.training.optimizers import get_optimizer
    from simpletuner_tpu_torch.training.schedules import get_lr_schedule
    from simpletuner_tpu_torch.training.train_state import build_train_step, create_train_state

    config = TrainingConfig({"model_family": "flux", "model_arch_preset": "tiny", "model_type": "lora",
                             "lora_rank": 4, "learning_rate": 1e-3, "optimizer": "adamw",
                             "flux_attention_masked_training": True, "base_model_precision": "int8-quanto"})
    model = Flux(config)
    gen = torch.Generator(device=device).manual_seed(8)
    with torch.device(device):
        module = init_parameters(model.create_module(), gen)
    perturb_adaln(module, gen)
    with torch.no_grad():
        for name, param in lora_parameters(module).items():
            if name.endswith("lora_B"):
                param.normal_(0.0, 0.02, generator=gen)
    schedule = get_lr_schedule(config, 10)
    tx = get_optimizer(config, schedule)
    ema = EMAConfig(decay=0.99)
    state = create_train_state(model, module, tx, ema, quantize_mode=model.base_precision)
    step_fn = build_train_step(model, tx, schedule, ema)
    batches = []
    for height, width in ((8, 8), (8, 12)):  # latent sizes of two buckets
        masks = torch.zeros((1, 16), dtype=torch.int64, device=device)
        masks[:, :5] = 1
        batches.append({"latents": torch.randn((1, height, width, 4), generator=gen, device=device),
                        "t5_embeds": torch.randn((1, 16, 32), generator=gen, device=device),
                        "pooled_embeds": torch.randn((1, 32), generator=gen, device=device), "t5_masks": masks})
    return state, step_fn, batches, torch.Generator(device=device)


def test_two_shapes_share_one_pool_and_match_eager_steps(cuda):
    # the trainer's graphs: one per batch shape, over one state, one memory
    # pool and one capture stream, the generator seeded per step; replays in
    # the order A, B, B, A equal the eager steps bitwise
    from simpletuner_tpu_torch.training.train_state import jit_train_step, state_tensors
    from simpletuner_tpu_torch.training.trainer import step_seed

    state, step_fn, batches, gen = _tiny_trainer_run(cuda)
    order = (0, 1, 1, 0)
    with torch.no_grad():
        saved = [x.clone() for x in state_tensors(state)]

    def trajectory(steps):
        current, out = state, []
        for n, which in enumerate(order):
            gen.manual_seed(step_seed(42, n))
            current, metrics = steps[which](current, batches[which], gen)
            out += [metrics["loss"], metrics["grad_norm"]]
        with torch.no_grad():  # a clone in grad mode keeps the adapters' accumulators (and their stream) alive
            return torch.stack(out), [x.clone() for x in state_tensors(current)]

    eager = trajectory((step_fn, step_fn))
    with torch.no_grad():
        for x, value in zip(state_tensors(state), saved):
            x.copy_(value)
    state.step = 0
    pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(cuda)
    graphs = [jit_train_step(step_fn, state, batch, gen, pool=pool, stream=stream) for batch in batches]
    replayed = trajectory(graphs)
    assert torch.isfinite(eager[0]).all() and (eager[0][1::2] > 0).all()
    assert torch.equal(replayed[0], eager[0])
    assert all(torch.equal(a, b) for a, b in zip(replayed[1], eager[1]))


def test_restore_into_a_captured_state_then_replay(cuda, tmp_path):
    # a checkpoint restored into the graph's own state: the same tensors
    # (addresses), and the replays after it repeat the steps after the save
    from simpletuner_tpu_torch.training.checkpoints import CheckpointManager, flatten_state
    from simpletuner_tpu_torch.training.train_state import jit_train_step
    from simpletuner_tpu_torch.training.trainer import step_seed

    state, step_fn, batches, gen = _tiny_trainer_run(cuda)
    graphed = jit_train_step(step_fn, state, batches[1], gen, pool=torch.cuda.graph_pool_handle())

    def steps(first, count):
        out = []
        for n in range(first, first + count):
            gen.manual_seed(step_seed(7, n))
            _, metrics = graphed(state, batches[1], gen)
            out += [metrics["loss"], metrics["grad_norm"]]
        return torch.stack(out)

    steps(0, 2)
    manager = CheckpointManager(str(tmp_path))
    path = manager.save(2, state, {"global_step": 2})
    pointers = {k: t.data_ptr() for k, t in flatten_state(state)[0].items()}
    after = steps(2, 3)
    manager.restore(path, state)
    assert {k: t.data_ptr() for k, t in flatten_state(state)[0].items()} == pointers and state.step == 2
    assert torch.equal(steps(2, 3), after)


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


@pytest.mark.parametrize("k,n", [(68, 2048), (256, 2044), (68, 2044)])
def test_int8_products_pad_k_and_n_on_the_card(cuda, k, n):
    """A contraction or output width off a multiple of 8 (Cosmos's patch
    embed takes 17 channels x 4 = 68 features) is zero-padded for cuBLASLt:
    the product exact and one launch, forward and the int8 backward."""
    from simpletuner_tpu_torch.training.quantization import int8_dynamic_dot, int8_matmul, quantize_weight

    gen = torch.Generator(device=cuda).manual_seed(k + n)
    a = torch.randint(-127, 128, (40, k), dtype=torch.int8, device=cuda, generator=gen)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=cuda, generator=gen)
    before = int8_matmul.launches
    out = int8_matmul(a, w.t())
    assert int8_matmul.launches == before + 1 and out.shape == (40, n)
    assert torch.equal(out.double(), a.double() @ w.double().t())
    stored = quantize_weight(torch.randn(n, k, device=cuda, generator=gen), "int8")
    x = torch.randn(40, k, device=cuda, generator=gen).bfloat16().requires_grad_(True)
    y = int8_dynamic_dot(x, stored["weight"], stored["weight_scale"], True)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert y.shape == (40, n) and dx.shape == x.shape and torch.isfinite(dx.float()).all()


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


# ---- the preprocessing path on the card (no hand-written kernel: library products) ----------


def test_weight_import_onto_the_card(cuda, tmp_path):
    """A tiny Flux checkpoint imports onto the card bitwise as onto the CPU, and an adapter round-trips."""
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.flux import Flux
    from simpletuner_tpu_torch.models.layers import init_adapters, lora_parameters
    from simpletuner_tpu_torch.models.checkpoint_layouts import flux_bfl_from_diffusers, flux_checkpoint_shapes
    from simpletuner_tpu_torch.models.weight_import import load_transformer_params, save_safetensors
    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    model = Flux(config_namespace({"model_family": "flux", "model_arch_preset": "tiny", "model_type": "lora",
                                   "lora_rank": 4}))
    gen = torch.Generator().manual_seed(0)
    weights = {k: torch.randn(v, generator=gen).to(torch.bfloat16) for k, v in flux_checkpoint_shapes(model.arch).items()}
    path = str(tmp_path / "flux.safetensors")
    save_safetensors(flux_bfl_from_diffusers(weights), path)
    on_cpu = load_transformer_params(model, init_adapters(model.create_module(), gen), path)
    with torch.device(cuda):
        on_card = load_transformer_params(model, init_adapters(model.create_module()), path)
    cpu_state, card_state = on_cpu.state_dict(), on_card.state_dict()
    base = [k for k in cpu_state if not k.endswith(("lora_A", "lora_B"))]
    assert all(card_state[k].is_cuda and torch.equal(card_state[k].cpu(), cpu_state[k]) for k in base)
    save_lora_safetensors(model, on_cpu, str(tmp_path / "lora.safetensors"))
    assert load_lora_safetensors(model, str(tmp_path / "lora.safetensors"), on_card) == []
    card_lora = lora_parameters(on_card)
    assert all(torch.equal(card_lora[k].cpu(), v) for k, v in lora_parameters(on_cpu).items())


def test_vae_encode_on_the_card(cuda):
    """The VAE encoder on the card in f32 against the CPU, and bf16 against f32, at a small size."""
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    config = VAEConfig(base_channels=32, channel_multipliers=(1, 2, 4, 4), layers_per_block=1, latent_channels=16)
    vae = init_parameters(AutoencoderKL(config), torch.Generator().manual_seed(1)).eval()
    image = torch.rand((2, 128, 96, 3), generator=torch.Generator().manual_seed(2)) * 2 - 1
    with torch.no_grad():
        ref = vae.encode(image)
        card = vae.to(cuda).encode(image.to(cuda))
        half = AutoencoderKL(config, torch.bfloat16).to(cuda)
        half.load_state_dict(vae.state_dict())
        low = half.encode(image.to(cuda)).float()
    # f32 convolutions on both (no TF32): cuDNN and the CPU sum in other orders
    assert float((card.cpu() - ref).norm() / ref.norm()) < 1e-5
    # bf16 compute, f32 statistics: a few bf16 roundings deep
    assert float((low.cpu() - ref).norm() / ref.norm()) < 3e-2


def test_text_encoders_on_the_card(cuda):
    """The tiny CLIP and T5 encoders on the card against the same modules on
    the CPU (f32, no TF32: sum order only), through Flux.encode_text."""
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.flux import Flux
    from simpletuner_tpu_torch.models.text_encoders import load_text_encoders

    model = Flux(config_namespace({"model_family": "flux", "model_arch_preset": "tiny"}))
    prompts = ["a lighthouse on a basalt cliff", "portrait", ""]
    model.attach_text_encoders(load_text_encoders(model.TEXT_ENCODER_CONFIGURATION, tiny=True, device="cpu"))
    ref = model.encode_text(prompts)
    for encoder in model.text_encoders:
        encoder.model.to(cuda)
    out = model.encode_text(prompts)
    for a, b in zip(out, ref):
        assert np.array_equal(a["attention_mask"], b["attention_mask"])
        for key in ("t5_embeds", "pooled_embeds"):
            assert np.linalg.norm(a[key] - b[key]) <= 1e-5 * np.linalg.norm(b[key]), key


def _tiny_longcat(dtype, device):
    """LongCat-Image's Flux DiT two heads of 128 wide (the published rope
    axes, no pooled or guidance embedder), 1 + 1 blocks, remat, rank-4 adapters."""
    import dataclasses

    from simpletuner_tpu_torch.models.flux.transformer import FluxConfig, FluxTransformer

    cfg = dataclasses.replace(FluxConfig.tiny(), hidden_size=256, num_heads=2, head_dim=128, depth_double=1,
                              depth_single=1, axes_dim=(16, 56, 56), vector_embed=False, guidance_embed=False)
    with torch.device(device):
        return cfg, FluxTransformer(cfg, dtype=dtype, lora_rank=4, remat=True)


def test_tiny_longcat_tokenwise_on_the_card_matches_its_cpu_run(cuda):
    """The tiny LongCat DiT (``_tiny_longcat``) with tokenwise timesteps: 48
    scene tokens at the sample's t and 48 reference tokens at t = 0, after 20
    text tokens, against its CPU run."""
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg, cpu = _tiny_longcat(torch.float32, "cpu")
    init_parameters(cpu, torch.Generator().manual_seed(0))
    _, card = _tiny_longcat(torch.bfloat16, cuda)
    gen = torch.Generator().manual_seed(4)
    timesteps = torch.cat([torch.tensor([[0.3], [0.8]]).expand(2, 48), torch.zeros(2, 48)], dim=1)
    inputs = [torch.randn((2, 96, cfg.in_channels), generator=gen), torch.randint(0, 40, (2, 96, 3), generator=gen),
              torch.randn((2, 20, cfg.txt_in_features), generator=gen), torch.randint(0, 40, (2, 20, 3), generator=gen),
              timesteps, None]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 96, cfg.in_channels), generator=gen), cuda)


def _tiny_z_image_omni(dtype, device):
    """The Z-Image-Omni DiT two heads of 128 wide (the published rope axes),
    1 layer and 1 + 1 + 1 refiners, remat, rank-4 adapters."""
    import dataclasses

    from simpletuner_tpu_torch.models.z_image_omni import ZImageOmniConfig, ZImageOmniTransformer

    cfg = dataclasses.replace(ZImageOmniConfig.tiny(), hidden_size=256, num_heads=2, num_kv_heads=2, depth=1,
                              axes_dim=(32, 48, 48))
    with torch.device(device):
        return cfg, ZImageOmniTransformer(cfg, dtype=dtype, lora_rank=4, remat=True)


def test_tiny_z_image_omni_on_the_card_matches_its_cpu_run(cuda):
    """The tiny Z-Image-Omni DiT (``_tiny_z_image_omni``) with a clean
    reference image, a 3 x 4 SigLIP grid and a caption mask (20 and 9 of 20
    valid; segment ids all 1 in the joint layers), 12 x 16 latents, against
    its CPU run."""
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg, cpu = _tiny_z_image_omni(torch.float32, "cpu")
    init_parameters(cpu, torch.Generator().manual_seed(0))
    _, card = _tiny_z_image_omni(torch.bfloat16, cuda)
    gen = torch.Generator().manual_seed(5)
    mask = (torch.arange(20)[None] < torch.tensor([[20], [9]])).to(torch.int32)
    inputs = [torch.randn((2, 12, 16, cfg.in_channels), generator=gen), torch.tensor([0.3, 0.8]),
              torch.randn((2, 20, cfg.cap_feat_dim), generator=gen), mask,
              torch.randn((2, 3, 4, cfg.siglip_feat_dim), generator=gen),
              torch.randn((2, 12, 16, cfg.in_channels), generator=gen)]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 12, 16, cfg.in_channels), generator=gen), cuda)


def _tiny_zlab(dtype, device):
    """The Zlab-i1 U-ViT two heads of 72 wide (the published head dim,
    zero-padded to 128 by the wrappers), 3 blocks, remat, rank-4 adapters."""
    import dataclasses

    from simpletuner_tpu_torch.models.zlab_i1 import ZlabI1Config, ZlabI1Transformer

    cfg = dataclasses.replace(ZlabI1Config.tiny(), hidden_size=144, num_heads=2)
    with torch.device(device):
        return cfg, ZlabI1Transformer(cfg, dtype=dtype, lora_rank=4, remat=True)


def test_tiny_zlab_on_the_card_matches_its_cpu_run(cuda):
    """The tiny Zlab-i1 U-ViT (``_tiny_zlab``) on its native 16 x 16 latents
    with 12 text tokens (12 and 5 valid: the text mask as the key ids),
    against its CPU run (the last block's text-side adapters reach no output)."""
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg, cpu = _tiny_zlab(torch.float32, "cpu")
    init_parameters(cpu, torch.Generator().manual_seed(0))
    _, card = _tiny_zlab(torch.bfloat16, cuda)
    gen = torch.Generator().manual_seed(6)
    mask = (torch.arange(12)[None] < torch.tensor([[12], [5]])).to(torch.int32)
    inputs = [torch.randn((2, 16, 16, cfg.in_channels), generator=gen), torch.tensor([0.3, 0.8]),
              torch.randn((2, 12, cfg.text_embed_dim), generator=gen), mask]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 16, 16, cfg.in_channels), generator=gen), cuda,
                      allow_unused=True)


@pytest.mark.parametrize("family", ["longcat_image", "z_image_omni", "zlab_i1"])
def test_graphed_longcat_omni_zlab_steps_match_eager_bitwise(cuda, family):
    """The tiny LongCat-Image edit step (reference latents at t = 0,
    tokenwise), Z-Image-Omni step (a reference image and SigLIP features) and
    Zlab-i1 step (masked text): three eager steps and then three replays of
    the captured step from the same state and generator state give the same
    losses and grad norms bitwise."""
    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.training.optimizers import get_optimizer
    from simpletuner_tpu_torch.training.train_state import (build_train_step, create_train_state, jit_train_step,
                                                            state_tensors)

    config = TrainingConfig({"model_family": family, "model_arch_preset": "tiny", "model_type": "lora",
                             "lora_rank": 4, "learning_rate": 1e-3, "optimizer": "adamw",
                             "gradient_checkpointing": True, "model_flavour": "edit" if family == "longcat_image"
                             else None})
    gen = torch.Generator(device=cuda).manual_seed(9)
    model = ModelRegistry.create(family, config)
    with torch.device(cuda):
        module = init_parameters(model.create_module(), gen)
    with torch.no_grad():  # LongCat's AdaLN-Zero starts at zero: give it a draw so the blocks reach the loss
        for name, param in module.named_parameters():
            if name.endswith("lin.weight"):
                param.normal_(0.0, 0.05, generator=gen)
    channels = model.latent_channels
    batch = {"latents": torch.randn((1, 16, 16, channels), generator=gen, device=cuda)}
    if family == "longcat_image":
        batch.update({"t5_embeds": torch.randn((1, 16, 32), generator=gen, device=cuda),
                      "control_latents": torch.randn((1, 16, 16, channels), generator=gen, device=cuda)})
    else:
        batch.update({"text_embeds": torch.randn((1, 12, 32), generator=gen, device=cuda),
                      "text_attention_mask": (torch.arange(12, device=cuda) < 7).to(torch.int32)[None]})
    if family == "z_image_omni":
        batch.update({"control_latents": torch.randn((1, 16, 16, channels), generator=gen, device=cuda),
                      "siglip_embeds": torch.randn((1, 2, 2, 24), generator=gen, device=cuda)})
    tx = get_optimizer(config, 1e-3)
    state = create_train_state(model, module, tx)
    step_fn = build_train_step(model, tx)
    with torch.no_grad():
        saved = [x.clone() for x in state_tensors(state)]
    rng = torch.Generator(device=cuda)
    rng.manual_seed(5)
    start = rng.get_state()

    def trajectory(step):
        current, out = state, []
        for _ in range(3):
            current, metrics = step(current, batch, rng)
            out += [metrics["loss"], metrics["grad_norm"]]
        return torch.stack(out)

    eager = trajectory(step_fn)
    with torch.no_grad():
        for x, value in zip(state_tensors(state), saved):
            x.copy_(value)
    rng.set_state(start)
    state.step = 0
    graphed = jit_train_step(step_fn, state, batch, rng)
    replayed = trajectory(graphed)
    assert torch.isfinite(eager).all() and (eager[1::2] > 0).all()
    assert torch.equal(replayed, eager)


# Krea-2 at 1024 x 1024: 512 text tokens (300 valid) before 4,096 image tokens,
# and 8,192 with the edit's reference tokens; 48 query heads over 12 key/value
# heads repeated as jnp.repeat does (here 4 over 2: head h reads head h // 2),
# query ids all 1 and key ids the text mask (1, or SEGMENT_PAD_ID); the text
# refiner's 512 tokens with the same key ids; Cosmos's (and Anima's) 4,096-token
# self-attention and its cross-attention against 512 unmasked T5 keys; head dim
# 128 throughout
KREA2_COSMOS_CASES = [("krea2_joint_s4608", 512 + 4096, 512 + 4096, 300, 2),
                      ("krea2_edit_joint_s8704", 512 + 8192, 512 + 8192, 300, 2),
                      ("krea2_refiner_s512", 512, 512, 300, 1), ("cosmos_self_s4096", 4096, 4096, None, 1),
                      ("cosmos_cross_s4096_k512", 4096, 512, None, 1)]


@pytest.mark.parametrize("name,sq,sk,valid,rep", KREA2_COSMOS_CASES, ids=[c[0] for c in KREA2_COSMOS_CASES])
def test_kernels_at_the_krea2_and_cosmos_shapes(cuda, name, sq, sk, valid, rep):
    """Forward and both backward kernels at Krea-2's joint (K/V repeated
    from half the heads with ``repeat_interleave``, query ids 1 and key ids
    from the text mask), edit joint and masked refiner shapes, and Cosmos's
    self- and cross-attention (unmasked), against the plain versions; the
    repeated K/V reach the kernels as the module hands them over."""
    q, k, v = _qkv(90 + sq % 23, 1, 4, sq, sk, 128, cuda)
    k, v = (x[:, :4 // rep].repeat_interleave(rep, dim=1) for x in (k, v))
    q_seg = kv_seg = None
    if valid is not None:
        kv_seg = torch.ones((1, sk), dtype=torch.int32, device=cuda)
        kv_seg[:, valid:512] = SEGMENT_PAD_ID
        q_seg = torch.ones((1, sq), dtype=torch.int32, device=cuda)
    out, lse = _check(q, k, v, q_seg, kv_seg)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    del out, lse
    dq, dk, dv = _check_backward(q, k, v, q_seg, seed=91, kv_seg=kv_seg)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    if valid is not None:  # masked keys get no gradient
        assert not dk[:, :, valid:512].float().any() and not dv[:, :, valid:512].float().any()


# the forward-only attentions: Krea-2's layerwise fusion (each of 512 text
# tokens a sequence of its 12 taps, head dim 128) and Anima's LLM adapter
# (64 T5 tokens against themselves and against 256 Qwen states, head dim 64);
# two heads, unmasked
FUSION_ADAPTER_CASES = [("krea2_layerwise_b512", 512, 12, 12, 128), ("anima_adapter_self", 1, 64, 64, 64),
                        ("anima_adapter_cross", 1, 64, 256, 64)]


@pytest.mark.parametrize("name,batch,sq,sk,dim", FUSION_ADAPTER_CASES, ids=[c[0] for c in FUSION_ADAPTER_CASES])
def test_forward_kernel_at_the_fusion_and_adapter_shapes(cuda, name, batch, sq, sk, dim):
    """The forward kernel at the attentions no gradient reaches on the path
    (Krea-2's text fusion, Anima's adapter) against the plain version."""
    q, k, v = _qkv(100 + sk, batch, 2, sq, sk, dim, cuda)
    out, lse = _check(q, k, v)
    assert out.shape == q.shape and torch.isfinite(lse).all()


def _tiny_krea2(dtype, device):
    """A Krea-2 DiT of two query heads of 128 over one key/value head (GQA),
    the published rope axes, a 256-wide text stage of two heads of 128, 2
    blocks, remat, rank-4 adapters."""
    import dataclasses

    from simpletuner_tpu_torch.models.krea2 import Krea2Config, Krea2Transformer

    cfg = dataclasses.replace(Krea2Config.tiny(), attention_head_dim=128, num_attention_heads=2,
                              num_key_value_heads=1, text_hidden_dim=256, axes_dims_rope=(32, 48, 48))
    with torch.device(device):
        return cfg, Krea2Transformer(cfg, dtype=dtype, lora_rank=4, remat=True)


def test_tiny_krea2_on_the_card_matches_its_cpu_run(cuda):
    """The tiny Krea-2 DiT (``_tiny_krea2``; its zero-init tables and norms
    drawn) with a caption mask (20 and 9 of 20 valid), 48 image tokens and
    3 taps, against its CPU run."""
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg, cpu = _tiny_krea2(torch.float32, "cpu")
    init_parameters(cpu, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, param in cpu.named_parameters():
            if "lora" not in name and param.dim() <= 2 and not param.any():
                param.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(3))
    _, card = _tiny_krea2(torch.bfloat16, cuda)
    gen = torch.Generator().manual_seed(4)
    mask = (torch.arange(20)[None] < torch.tensor([[20], [9]])).to(torch.int32)
    grid = torch.stack(torch.meshgrid(torch.arange(6), torch.arange(8), indexing="ij"), -1).reshape(-1, 2)
    ids = torch.cat([torch.zeros((20, 3), dtype=torch.int32),
                     torch.cat([torch.zeros((48, 1), dtype=torch.int64), grid], 1).to(torch.int32)])
    inputs = [torch.randn((2, 48, cfg.in_channels), generator=gen),
              torch.randn((2, 20, cfg.num_text_layers, cfg.text_hidden_dim), generator=gen),
              torch.tensor([0.3, 0.8]), ids, mask]
    _card_against_cpu(cpu, card, inputs, torch.randn((2, 48, cfg.in_channels), generator=gen), cuda)


def _tiny_cosmos(dtype, device, anima=False):
    """The Cosmos core two heads of 128 wide (the published rope scale, no
    position embedding), 2 blocks, remat, rank-4 adapters; with ``anima``
    the Anima adapter before it (two heads of 64, the published head dim)."""
    import dataclasses

    from simpletuner_tpu_torch.models.anima import AnimaConfig, AnimaTransformer
    from simpletuner_tpu_torch.models.cosmos1 import Cosmos1Config, Cosmos1Transformer

    core = dataclasses.replace(Cosmos1Config.tiny(), num_heads=2, head_dim=128, learnable_pos_embed=False,
                               rope_scale=(1.0, 4.0, 4.0), adaln_lora_dim=64, text_embed_dim=128)
    with torch.device(device):
        if anima:
            cfg = dataclasses.replace(AnimaConfig.tiny(), core=core, adapter_dim=128, adapter_pad_length=32)
            return cfg, AnimaTransformer(cfg, dtype=dtype, lora_rank=4, remat=True)
        return core, Cosmos1Transformer(core, dtype=dtype, lora_rank=4, remat=True)


@pytest.mark.parametrize("anima", [False, True], ids=["cosmos", "anima"])
def test_tiny_cosmos_and_anima_on_the_card_match_their_cpu_runs(cuda, anima):
    """The tiny Cosmos core on 8 x 12 one-frame latents with 20 T5 states,
    and Anima's adapter (20 ids, 7 Qwen states) before it, against their CPU
    runs (the adapter's attentions run the plain version on both)."""
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg, cpu = _tiny_cosmos(torch.float32, "cpu", anima)
    init_parameters(cpu, torch.Generator().manual_seed(0))
    _, card = _tiny_cosmos(torch.bfloat16, cuda, anima)
    gen = torch.Generator().manual_seed(5)
    channels = (cfg.core if anima else cfg).in_channels
    latents = torch.randn((2, 1, 8, 12, channels), generator=gen)
    if anima:
        inputs = [latents, torch.tensor([0.3, 0.8]), torch.randn((2, 7, 128), generator=gen),
                  torch.randint(0, cfg.adapter_vocab_size, (2, 20), generator=gen)]
    else:
        inputs = [latents, torch.tensor([0.3, 0.8]), torch.randn((2, 20, 128), generator=gen)]
    _card_against_cpu(cpu, card, inputs, torch.randn(latents.shape, generator=gen), cuda)


@pytest.mark.parametrize("family", ["krea2", "cosmos", "anima"])
def test_graphed_krea2_cosmos_anima_steps_match_eager_bitwise(cuda, family):
    """The tiny Krea-2 step (masked taps), Cosmos step (the EDM sigma drawn
    through ``erfinv`` from the step's generator, the weighted x0 loss) and
    Anima step (T5 ids into the adapter): three eager steps and then three
    replays of the captured step from the same state and generator state
    give the same losses and grad norms bitwise."""
    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.training.optimizers import get_optimizer
    from simpletuner_tpu_torch.training.train_state import (build_train_step, create_train_state, jit_train_step,
                                                            state_tensors)

    config = TrainingConfig({"model_family": family, "model_arch_preset": "tiny", "model_type": "lora",
                             "lora_rank": 4, "learning_rate": 1e-3, "optimizer": "adamw",
                             "gradient_checkpointing": True})
    gen = torch.Generator(device=cuda).manual_seed(9)
    model = ModelRegistry.create(family, config)
    with torch.device(cuda):
        module = init_parameters(model.create_module(), gen)
    with torch.no_grad():  # Krea-2's tables and norms start at zero: give them a draw
        for name, param in module.named_parameters():
            if "lora" not in name and not param.any():
                param.normal_(0.0, 0.05, generator=gen)
    channels = model.latent_channels
    batch = {"latents": torch.randn((1, 16, 16, channels), generator=gen, device=cuda)}
    if family == "krea2":
        batch.update({"text_embeds": torch.randn((1, 12, 3, 32), generator=gen, device=cuda),
                      "text_attention_mask": (torch.arange(12, device=cuda) < 7).to(torch.int32)[None]})
    else:
        batch["text_embeds"] = torch.randn((1, 12, 32), generator=gen, device=cuda)
    if family == "anima":
        batch["t5_ids"] = torch.randint(1, 60, (1, 16), generator=gen, device=cuda).to(torch.int32)
    tx = get_optimizer(config, 1e-3)
    state = create_train_state(model, module, tx)
    step_fn = build_train_step(model, tx)
    with torch.no_grad():
        saved = [x.clone() for x in state_tensors(state)]
    rng = torch.Generator(device=cuda)
    rng.manual_seed(5)
    start = rng.get_state()

    def trajectory(step):
        current, out = state, []
        for _ in range(3):
            current, metrics = step(current, batch, rng)
            out += [metrics["loss"], metrics["grad_norm"]]
        return torch.stack(out)

    eager = trajectory(step_fn)
    with torch.no_grad():
        for x, value in zip(state_tensors(state), saved):
            x.copy_(value)
    rng.set_state(start)
    state.step = 0
    graphed = jit_train_step(step_fn, state, batch, rng)
    replayed = trajectory(graphed)
    assert torch.isfinite(eager).all() and (eager[1::2] > 0).all()
    assert torch.equal(replayed, eager)


# OmniGen at 1024 x 1024: the 4,096 image rows (query ids 1) against the whole
# sequence of 120 text tokens (77 valid; the pads at SEGMENT_PAD_ID), the time
# token and the 4,096 image tokens, 4,217 keys, head dim 96 (zero-padded to the
# kernels' 128); ERNIE-Image's joint [4,096 image | 512 text] with 300 valid
# text keys, head dim 128; Ideogram's joint [512 text | 4,096 image] with its
# segment ids passed through (text pads at 0 attend to each other only), head
# dim 256
OMNIGEN_ERNIE_IDEOGRAM_CASES = [("omnigen_image_rows_q4096_k4217", 4096, 4217, 96),
                                ("ernie_joint_s4608", 4608, 4608, 128), ("ideogram_joint_s4608", 4608, 4608, 256)]


def _omnigen_ernie_ideogram_segments(name, sq, sk, device):
    """The (query ids, key ids) each family's module hands the op."""
    if name.startswith("omnigen"):
        kv = torch.ones((1, sk), dtype=torch.int32, device=device)
        kv[:, 77:120] = SEGMENT_PAD_ID
        return torch.ones((1, sq), dtype=torch.int32, device=device), kv
    if name.startswith("ernie"):
        kv = torch.ones((1, sk), dtype=torch.int32, device=device)
        kv[:, 4096 + 300:] = SEGMENT_PAD_ID
        return torch.ones((1, sq), dtype=torch.int32, device=device), kv
    seg = torch.ones((1, sq), dtype=torch.int32, device=device)
    seg[:, 300:512] = 0
    return seg, seg


@pytest.mark.parametrize("name,sq,sk,dim", OMNIGEN_ERNIE_IDEOGRAM_CASES, ids=[c[0] for c in OMNIGEN_ERNIE_IDEOGRAM_CASES])
def test_kernels_at_the_omnigen_ernie_ideogram_shapes(cuda, name, sq, sk, dim):
    """Forward and both backward kernels at OmniGen's image-row call (the
    prefix rows stay plain), ERNIE's joint attention with key ids and
    Ideogram's joint attention at head dim 256 with segment ids 0 / 1,
    against the plain versions, two heads; pad keys get no gradient (OmniGen,
    ERNIE), and Ideogram's pad rows see only each other."""
    q, k, v = _qkv(110 + dim, 1, 2, sq, sk, dim, cuda)
    q_seg, kv_seg = _omnigen_ernie_ideogram_segments(name, sq, sk, cuda)
    out, lse = _check(q, k, v, q_seg, kv_seg)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    del out, lse
    dq, dk, dv = _check_backward(q, k, v, q_seg, seed=111, kv_seg=kv_seg)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    pads = (kv_seg[0] == SEGMENT_PAD_ID).nonzero()[:, 0]
    if len(pads):
        assert not dk[:, :, pads].float().any() and not dv[:, :, pads].float().any()


def _tiny_family_module(family, dtype, device):
    """The tiny DiT of ``family`` at the head dim its published arch runs
    (OmniGen 96 with GQA 2 over 1, ERNIE 128, Ideogram 256), 2 blocks, remat,
    rank-4 adapters."""
    import dataclasses

    from simpletuner_tpu_torch.models.ernie import ErnieConfig, ErnieTransformer
    from simpletuner_tpu_torch.models.ideogram import IdeogramConfig, IdeogramTransformer
    from simpletuner_tpu_torch.models.omnigen import OmniGenConfig, OmniGenTransformer

    if family == "omnigen":
        cfg, cls = dataclasses.replace(OmniGenConfig.tiny(), hidden_size=192, intermediate_size=256), \
            OmniGenTransformer
    elif family == "ernie":
        cfg, cls = dataclasses.replace(ErnieConfig.tiny(), hidden_size=256, rope_axes_dim=(32, 48, 48)), \
            ErnieTransformer
    else:
        cfg, cls = dataclasses.replace(IdeogramConfig.tiny(), emb_dim=512, mrope_section=(24, 20, 20)), \
            IdeogramTransformer
    with torch.device(device):
        return cfg, cls(cfg, dtype=dtype, lora_rank=4, remat=True)


def _tiny_family_inputs(family, cfg, gen):
    """Seeded inputs with padded text: OmniGen 16 ids (11 and 16 valid,
    right-padded) before 48 image tokens; ERNIE 20 states (20 and 9 valid)
    after 48; Ideogram's packed sequence through the family (20 text tokens,
    9 valid in the second sample)."""
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.ideogram import Ideogram

    if family == "omnigen":
        mask = (torch.arange(16)[None] < torch.tensor([[11], [16]])).float()
        return [torch.randn((2, 12, 16, 4), generator=gen), torch.tensor([0.3, 0.8]),
                torch.randint(0, cfg.vocab_size, (2, 16), generator=gen), mask], (2, 12, 16, 4)
    if family == "ernie":
        return [torch.randn((2, 6, 8, cfg.in_channels), generator=gen), torch.tensor([300.0, 800.0]),
                torch.randn((2, 20, cfg.text_in_dim), generator=gen), torch.tensor([20, 9])], (2, 6, 8, cfg.in_channels)
    model = Ideogram(config_namespace({"model_family": "ideogram", "model_arch_preset": "tiny"}), arch=cfg)
    prepared = {"noisy_latents": torch.randn((2, 12, 16, cfg.in_channels // 4), generator=gen),
                "timesteps": torch.tensor([0.3, 0.8]),
                "text_embeds": torch.randn((2, 20, cfg.llm_features_dim), generator=gen),
                "text_attention_mask": (torch.arange(20)[None] < torch.tensor([[20], [9]])).to(torch.int32)}
    inputs = model.get_model_inputs(prepared)
    order = ("llm_features", "x", "t", "position_ids", "segment_ids", "indicator")
    return [inputs[key] for key in order], tuple(inputs["x"].shape)


@pytest.mark.parametrize("family", ["omnigen", "ernie", "ideogram"])
def test_tiny_omnigen_ernie_ideogram_on_the_card_match_their_cpu_runs(cuda, family):
    """Each tiny DiT (``_tiny_family_module``; ERNIE's zero-init AdaLN and
    final linear drawn) with padded text against its CPU run: prediction and
    LoRA gradients within the card-against-CPU bound."""
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg, cpu = _tiny_family_module(family, torch.float32, "cpu")
    init_parameters(cpu, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, param in cpu.named_parameters():
            if "lora" not in name and not param.any():
                param.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(3))
    _, card = _tiny_family_module(family, torch.bfloat16, cuda)
    gen = torch.Generator().manual_seed(4)
    inputs, out_shape = _tiny_family_inputs(family, cfg, gen)
    _card_against_cpu(cpu, card, inputs, torch.randn(out_shape, generator=gen), cuda)


@pytest.mark.parametrize("family", ["omnigen", "ernie", "ideogram"])
def test_graphed_omnigen_ernie_ideogram_steps_match_eager_bitwise(cuda, family):
    """The tiny OmniGen step (int32 ids, a float mask), ERNIE step (the
    lengths from the mask) and Ideogram step (the packed sequence with text
    pads): three eager steps and then three replays of the captured step from
    the same state and generator state give the same losses and grad norms
    bitwise (every table the modules make on the host is made once per
    device in the eager steps, so the capture copies nothing)."""
    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.training.optimizers import get_optimizer
    from simpletuner_tpu_torch.training.train_state import (build_train_step, create_train_state, jit_train_step,
                                                            state_tensors)

    config = TrainingConfig({"model_family": family, "model_arch_preset": "tiny", "model_type": "lora",
                             "lora_rank": 4, "learning_rate": 1e-3, "optimizer": "adamw",
                             "gradient_checkpointing": True})
    gen = torch.Generator(device=cuda).manual_seed(9)
    model = ModelRegistry.create(family, config)
    with torch.device(cuda):
        module = init_parameters(model.create_module(), gen)
    with torch.no_grad():  # ERNIE's AdaLN and final linear start at zero: give them a draw
        for name, param in module.named_parameters():
            if "lora" not in name and not param.any():
                param.normal_(0.0, 0.05, generator=gen)
    batch = {"latents": torch.randn((1, 16, 16, model.latent_channels), generator=gen, device=cuda)}
    mask = (torch.arange(12, device=cuda) < 7)[None]
    if family == "omnigen":
        batch.update({"input_ids": torch.randint(3, 120, (1, 12), generator=gen, device=cuda).to(torch.int32),
                      "text_attention_mask": mask.float()})
    else:
        width = model.arch.llm_features_dim if family == "ideogram" else model.arch.text_in_dim
        batch.update({"text_embeds": torch.randn((1, 12, width), generator=gen, device=cuda),
                      "text_attention_mask": mask.to(torch.int32)})
    tx = get_optimizer(config, 1e-3)
    state = create_train_state(model, module, tx)
    step_fn = build_train_step(model, tx)
    with torch.no_grad():
        saved = [x.clone() for x in state_tensors(state)]
    rng = torch.Generator(device=cuda)
    rng.manual_seed(5)
    start = rng.get_state()

    def trajectory(step):
        current, out = state, []
        for _ in range(3):
            current, metrics = step(current, batch, rng)
            out += [metrics["loss"], metrics["grad_norm"]]
        return torch.stack(out)

    eager = trajectory(step_fn)
    with torch.no_grad():
        for x, value in zip(state_tensors(state), saved):
            x.copy_(value)
    rng.set_state(start)
    state.step = 0
    graphed = jit_train_step(step_fn, state, batch, rng)
    replayed = trajectory(graphed)
    assert torch.isfinite(eager).all() and (eager[1::2] > 0).all()
    assert torch.equal(replayed, eager)


# LongCat-Video, Sana and Sana-Video: LongCat-Video's self-attention over the
# 832 x 480 x 81 clip (32,760 tokens, 255 full 128-row tiles and a ragged tail
# of 120) and its cross-attention against 512 T5 keys with 300 valid (query
# ids 1, key ids 1 / -1); Sana's unmasked cross-attention at 1024 px (1,024
# queries against 300 Gemma keys, head dim 112 zero-padded to 128) and
# Sana-Video's over the clip (32,760 queries against 300 keys, 120 valid);
# two heads (the heads are independent)
LONGCAT_SANA_CASES = [("longcat_self_s32760", WAN_TOKENS, WAN_TOKENS, 128, None),
                      ("longcat_cross_t5_512", WAN_TOKENS, 512, 128, 300),
                      ("sana_cross_s1024_k300_d112", 1024, 300, 112, None),
                      ("sanavideo_cross_s32760_k300_d112", WAN_TOKENS, 300, 112, 120)]


@pytest.mark.parametrize("name,sq,sk,dim,valid", LONGCAT_SANA_CASES, ids=[c[0] for c in LONGCAT_SANA_CASES])
def test_kernels_at_the_longcat_video_and_sana_shapes(cuda, name, sq, sk, dim, valid):
    """Forward and both backward kernels at the slice's shapes against the
    plain versions, in the dispatcher's (B, S, H, D) layout as the DiTs call
    them; with a caption mask the pad keys get no weight (dk, dv 0 there)."""
    q, k, v = _qkv(120 + sk % 17 + dim, 1, 2, sq, sk, dim, cuda)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    q_seg = kv_seg = None
    if valid is not None:
        q_seg = torch.ones((1, sq), dtype=torch.int32, device=cuda)
        kv_seg = torch.where(torch.arange(sk, device=cuda) < valid, 1, SEGMENT_PAD_ID)[None].to(torch.int32)
    out, lse = _check(*strided, q_seg, kv_seg)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    del out, lse
    dq, dk, dv = _check_backward(*strided, q_seg, seed=121, kv_seg=kv_seg)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    if valid is not None:
        assert dk[0, :, valid:].abs().max() == dv[0, :, valid:].abs().max() == 0


def _tiny_video_family(family, dtype, device):
    """Each family's DiT at a width that runs the head dim 128 kernels
    (LongCat-Video) or the padded 112 (the Sanas: 2 cross heads of 112),
    two blocks, remat, rank-4 adapters."""
    import dataclasses

    from simpletuner_tpu_torch.models.longcat_video import LongCatVideoConfig, LongCatVideoTransformer
    from simpletuner_tpu_torch.models.sana import SanaConfig, SanaTransformer
    from simpletuner_tpu_torch.models.sanavideo import SanaVideoConfig, SanaVideoTransformer

    if family == "longcat_video":
        cfg = dataclasses.replace(LongCatVideoConfig.tiny(), hidden_size=256, num_heads=2, caption_channels=64)
        cls = LongCatVideoTransformer
    elif family == "sana":
        cfg = dataclasses.replace(SanaConfig.tiny(), hidden_size=224, self_heads=7, self_head_dim=32,
                                  cross_heads=2, cross_head_dim=112, text_dim=64)
        cls = SanaTransformer
    else:
        cfg = dataclasses.replace(SanaVideoConfig.tiny(), num_heads=2, head_dim=112, cross_heads=2,
                                  cross_head_dim=112, caption_channels=64)
        cls = SanaVideoTransformer
    with torch.device(device):
        return cfg, cls(cfg, dtype=dtype, lora_rank=4, remat=True)


@pytest.mark.parametrize("family", ["longcat_video", "sana", "sanavideo"])
def test_tiny_longcat_video_and_sana_on_the_card_match_their_cpu_runs(cuda, family):
    """Each DiT (``_tiny_video_family``) with a padded caption (the video
    families: 40 keys, 17 valid in the second sample) against its CPU run:
    prediction and LoRA gradients within the card-against-CPU bound."""
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg, cpu = _tiny_video_family(family, torch.float32, "cpu")
    init_parameters(cpu, torch.Generator().manual_seed(0))
    _, card = _tiny_video_family(family, torch.bfloat16, cuda)
    gen = torch.Generator().manual_seed(4)
    text_width = cfg.text_dim if family == "sana" else cfg.caption_channels
    text = torch.randn((2, 40, text_width), generator=gen)
    if family == "sana":
        shape = (2, 12, 20, cfg.in_channels)
        inputs = [torch.randn(shape, generator=gen), torch.tensor([0.9, 0.25]), text]
    else:
        shape = (2, 5, 8, 14, cfg.in_channels)
        mask = (torch.arange(40)[None] < torch.tensor([[40], [17]])).to(torch.int32)
        inputs = [torch.randn(shape, generator=gen), torch.tensor([900.0, 250.0]), text, mask]
    _card_against_cpu(cpu, card, inputs, torch.randn(shape, generator=gen), cuda)


@pytest.mark.parametrize("family", ["longcat_video", "sana", "sanavideo"])
def test_graphed_longcat_video_and_sana_steps_match_eager_bitwise(cuda, family):
    """Each tiny family's step (the video families on 5-D latents with a
    caption mask; their RoPE tables made once per device in the eager steps):
    three eager steps and three replays of the captured step from the same
    state and generator state give the same losses and grad norms bitwise."""
    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.training.optimizers import get_optimizer
    from simpletuner_tpu_torch.training.train_state import (build_train_step, create_train_state, jit_train_step,
                                                            state_tensors)

    config = TrainingConfig({"model_family": family, "model_arch_preset": "tiny", "model_type": "lora",
                             "lora_rank": 4, "learning_rate": 1e-3, "optimizer": "adamw",
                             "gradient_checkpointing": True})
    gen = torch.Generator(device=cuda).manual_seed(9)
    model = ModelRegistry.create(family, config)
    with torch.device(cuda):
        module = init_parameters(model.create_module(), gen)
    latents = (1, 16, 16, 4) if family == "sana" else (1, 3, 16, 16, 4)
    batch = {"latents": torch.randn(latents, generator=gen, device=cuda),
             "text_embeds": torch.randn((1, 12, 32), generator=gen, device=cuda)}
    if family != "sana":
        batch["text_attention_mask"] = (torch.arange(12, device=cuda) < 7)[None].to(torch.int32)
    tx = get_optimizer(config, 1e-3)
    state = create_train_state(model, module, tx)
    step_fn = build_train_step(model, tx)
    with torch.no_grad():
        saved = [x.clone() for x in state_tensors(state)]
    rng = torch.Generator(device=cuda)
    rng.manual_seed(5)
    start = rng.get_state()

    def trajectory(step):
        current, out = state, []
        for _ in range(3):
            current, metrics = step(current, batch, rng)
            out += [metrics["loss"], metrics["grad_norm"]]
        return torch.stack(out)

    eager = trajectory(step_fn)
    with torch.no_grad():
        for x, value in zip(state_tensors(state), saved):
            x.copy_(value)
    rng.set_state(start)
    state.step = 0
    graphed = jit_train_step(step_fn, state, batch, rng)
    replayed = trajectory(graphed)
    assert torch.isfinite(eager).all() and (eager[1::2] > 0).all()
    assert torch.equal(replayed, eager)


# Cosmos3: the generation attention over the 1280 x 704 x 93 clip (21,120
# generation tokens against 64 + 21,120 = 21,184 keys: 165 full 128-key tiles
# and a ragged 64), unmasked, and at the 17-frame parity clip (4,400 against
# 4,464); two heads (the heads are independent; the DiT repeats 8 kv heads to 32)
COSMOS3_CASES = [("cosmos3_gen_s21120_k21184", 21120, 21184), ("cosmos3_gen_s4400_k4464", 4400, 4464)]


@pytest.mark.parametrize("name,sq,sk", COSMOS3_CASES, ids=[c[0] for c in COSMOS3_CASES])
def test_kernels_at_the_cosmos3_shapes(cuda, name, sq, sk):
    """Forward and both backward kernels at the generation attention's shapes
    against the plain versions, in the dispatcher's (B, S, H, D) layout."""
    q, k, v = _qkv(130 + sk % 17, 1, 2, sq, sk, 128, cuda)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    out, lse = _check(*strided)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    del out, lse
    dq, dk, dv = _check_backward(*strided, None, seed=131)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


def _tiny_cosmos3(dtype, device, lora_rank=4):
    """The MoT at head dim 128 (2 query heads, 1 kv head, the published mRoPE
    sections), two layers, remat, rank-4 adapters."""
    import dataclasses

    from simpletuner_tpu_torch.models.cosmos3 import Cosmos3Config, Cosmos3OmniTransformer

    cfg = dataclasses.replace(Cosmos3Config.tiny(), hidden_size=256, head_dim=128, num_heads=2, num_kv_heads=1,
                              rope_axes_dim=(24, 20, 20))
    with torch.device(device):
        return cfg, Cosmos3OmniTransformer(cfg, dtype=dtype, lora_rank=lora_rank, remat=True)


class _VisionOnly(torch.nn.Module):
    """The MoT's vision prediction alone (the logits set aside)."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)[0]


def _cosmos3_inputs(cfg, gen, und=8, frames=3, height=8, width=12):
    from simpletuner_tpu_torch.models.cosmos3.transformer import cosmos3_position_ids

    pos = torch.from_numpy(cosmos3_position_ids(cfg, und, frames, height, width).astype(np.int32))[None]
    gen_len = frames * (height // 2) * (width // 2)
    return [torch.randint(0, cfg.vocab_size, (1, und), generator=gen).to(torch.int32),
            torch.randn((1, gen_len, cfg.patch_latent_dim), generator=gen), pos,
            torch.rand((1, gen_len), generator=gen) * 1000.0]


def test_tiny_cosmos3_on_the_card_matches_its_cpu_run(cuda):
    """The MoT (``_tiny_cosmos3``: 8 text tokens, 72 generation tokens) against
    its CPU run: the vision prediction and the LoRA gradients within the
    card-against-CPU bound; the replay of the reasoner's memory (the
    understanding pathway's own weights, no adapters) equals the full
    forward on the card bitwise."""
    import dataclasses

    from simpletuner_tpu_torch.models.cosmos3.reasoner import Cosmos3Reasoner, Cosmos3ReasonerConfig
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg, cpu = _tiny_cosmos3(torch.float32, "cpu")
    init_parameters(cpu, torch.Generator().manual_seed(0))
    _, card = _tiny_cosmos3(torch.bfloat16, cuda)
    gen = torch.Generator().manual_seed(4)
    inputs = _cosmos3_inputs(cfg, gen)
    # the last layer's understanding adapters reach only the logits
    _card_against_cpu(_VisionOnly(cpu), _VisionOnly(card), inputs, torch.randn(inputs[1].shape, generator=gen), cuda,
                      allow_unused=True)

    _, base = _tiny_cosmos3(torch.bfloat16, cuda, lora_rank=0)
    base.load_state_dict({k: v for k, v in cpu.state_dict().items() if not k.endswith(("lora_A", "lora_B"))})
    fields = {f.name for f in dataclasses.fields(Cosmos3ReasonerConfig)}
    with torch.device(cuda):
        reasoner = Cosmos3Reasoner(Cosmos3ReasonerConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                                                            if k in fields}), torch.bfloat16)
    # the reasoner's names for the understanding pathway of the MoT
    renames = {"to_q": "attn_und_q", "to_k": "attn_und_k", "to_v": "attn_und_v", "to_out": "attn_und_out",
               "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj", "down_proj": "mlp.down_proj"}
    state = base.state_dict()
    with torch.no_grad():
        for name, param in reasoner.named_parameters():
            parts = name.split(".")
            if len(parts) == 3 and parts[1] in renames:
                name = f"{parts[0]}.{renames[parts[1]]}.{parts[2]}"
            param.copy_(state[name])
    args = [x.to(cuda) for x in inputs]
    with torch.no_grad():
        full, _ = base(*args)
        memory = reasoner(args[0], args[2][:, :, :8])
        replay, logits = base(None, *args[1:], reasoner_kv=memory)
    assert logits is None and torch.equal(replay, full)


def test_graphed_cosmos3_step_matches_eager_bitwise(cuda):
    """The tiny family's step (5-D latents, 6 text ids; the mRoPE constants
    and ids made once per device in the eager steps): three eager steps and
    three replays of the captured step from the same state and generator
    state give the same losses and grad norms bitwise."""
    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.training.optimizers import get_optimizer
    from simpletuner_tpu_torch.training.train_state import (build_train_step, create_train_state, jit_train_step,
                                                            state_tensors)

    config = TrainingConfig({"model_family": "cosmos3", "model_arch_preset": "tiny", "model_type": "lora",
                             "lora_rank": 4, "learning_rate": 1e-3, "optimizer": "adamw",
                             "gradient_checkpointing": True})
    gen = torch.Generator(device=cuda).manual_seed(9)
    model = ModelRegistry.create("cosmos3", config)
    with torch.device(cuda):
        module = init_parameters(model.create_module(), gen)
    batch = {"latents": torch.randn((1, 3, 8, 8, 2), generator=gen, device=cuda),
             "text_ids": torch.randint(0, 64, (1, 6), generator=gen, device=cuda).to(torch.int32)}
    tx = get_optimizer(config, 1e-3)
    state = create_train_state(model, module, tx)
    step_fn = build_train_step(model, tx)
    with torch.no_grad():
        saved = [x.clone() for x in state_tensors(state)]
    rng = torch.Generator(device=cuda)
    rng.manual_seed(5)
    start = rng.get_state()

    def trajectory(step):
        current, out = state, []
        for _ in range(3):
            current, metrics = step(current, batch, rng)
            out += [metrics["loss"], metrics["grad_norm"]]
        return torch.stack(out)

    eager = trajectory(step_fn)
    with torch.no_grad():
        for x, value in zip(state_tensors(state), saved):
            x.copy_(value)
    rng.set_state(start)
    state.step = 0
    graphed = jit_train_step(step_fn, state, batch, rng)
    replayed = trajectory(graphed)
    assert torch.isfinite(eager).all() and (eager[1::2] > 0).all()
    assert torch.equal(replayed, eager)


def test_tiny_avae_on_the_card_matches_float64(cuda):
    """The tiny AVAE tokenizer (seeded) encodes and decodes a stereo batch on
    the card within 1e-3 relative L2 of the same module in float64 on the
    CPU (cuDNN may run f32 convolutions in TF32)."""
    from simpletuner_tpu_torch.models.cosmos3.audio_tokenizer import Cosmos3AudioTokenizer, Cosmos3AudioTokenizerConfig
    from simpletuner_tpu_torch.models.layers import init_parameters

    cpu = init_parameters(Cosmos3AudioTokenizer(Cosmos3AudioTokenizerConfig.tiny()), torch.Generator().manual_seed(2))
    with torch.no_grad():
        for name, param in cpu.named_parameters():
            if name.endswith(("alpha", "beta")):
                param.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(3))
    card = Cosmos3AudioTokenizer(Cosmos3AudioTokenizerConfig.tiny()).to(cuda)
    card.load_state_dict(cpu.state_dict())
    wave = torch.randn((2, 2, 640), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref_latents = cpu.double().encode(wave.double())
        ref = cpu.decode(ref_latents)
        latents = card.encode(wave.to(cuda))
        out = card.decode(latents)
    for a, b in ((latents, ref_latents), (out, ref)):
        assert ((a.double().cpu() - b).norm() / b.norm()).item() <= 1e-3


# LTX-2 at the 768 x 512 x 121 clip (16 x 16 x 24 latents: 6,144 video
# tokens, 121 audio tokens, 256 Gemma tokens with 180 valid): the video
# self-attention (32 x 128), the video prompt cross-attention, a2v (video
# queries against the audio keys) and v2a (audio queries against the video
# keys) at 32 heads of 64, the audio self- and prompt cross-attention, and
# the connectors' self-attention (30 x 128 over 256 tokens); two heads (the
# heads are independent)
LTX2_CASES = [("ltx2_video_self_s6144_d128", 6144, 6144, 128, None),
              ("ltx2_video_cross_k256_d128", 6144, 256, 128, 180),
              ("ltx2_a2v_s6144_k121_d64", 6144, 121, 64, None),
              ("ltx2_v2a_s121_k6144_d64", 121, 6144, 64, None),
              ("ltx2_audio_self_s121_d64", 121, 121, 64, None),
              ("ltx2_audio_cross_s121_k256_d64", 121, 256, 64, 180),
              ("ltx2_connector_s256_d128", 256, 256, 128, None)]


@pytest.mark.parametrize("name,sq,sk,dim,valid", LTX2_CASES, ids=[c[0] for c in LTX2_CASES])
def test_kernels_at_the_ltx2_shapes(cuda, name, sq, sk, dim, valid):
    """Forward and both backward kernels at each LTX-2 attention's shape
    against the plain versions, in the dispatcher's (B, S, H, D) layout as
    the DiT calls them; with the caption mask (query ids 1, key ids 1 / -1)
    the pad keys get no weight (dk, dv 0 there)."""
    q, k, v = _qkv(140 + sk % 19 + dim, 1, 2, sq, sk, dim, cuda)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    q_seg = kv_seg = None
    if valid is not None:
        q_seg = torch.ones((1, sq), dtype=torch.int32, device=cuda)
        kv_seg = torch.where(torch.arange(sk, device=cuda) < valid, 1, SEGMENT_PAD_ID)[None].to(torch.int32)
    out, lse = _check(*strided, q_seg, kv_seg)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    del out, lse
    dq, dk, dv = _check_backward(*strided, q_seg, seed=141, kv_seg=kv_seg)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    if valid is not None:
        assert dk[0, :, valid:].abs().max() == dv[0, :, valid:].abs().max() == 0


class _LTX2Joint(torch.nn.Module):
    """The LTX-2 DiT on a 2 x 4 x 6 grid with its video and audio
    predictions side by side, for ``_card_against_cpu``."""

    def __init__(self, dit):
        super().__init__()
        self.dit = dit

    def forward(self, video, audio, text, timesteps, audio_timesteps, mask):
        out = self.dit(video, audio, text, timesteps, 2, 4, 6, audio_timesteps=audio_timesteps, text_mask=mask)
        return torch.cat([out[0].flatten(1), out[1].flatten(1)], dim=1)


def _tiny_ltx2(dtype, device):
    """The DiT at widths that run the head dim 64 kernels (2 video heads of
    64, 2 audio heads of 32 padded to 64), two blocks, remat, rank-4 adapters."""
    import dataclasses

    from simpletuner_tpu_torch.models.ltxvideo2 import LTX2Config, LTX2Transformer

    cfg = dataclasses.replace(LTX2Config.tiny(), num_heads=2, head_dim=64, audio_num_heads=2, audio_head_dim=32,
                              audio_cross_attention_dim=64, caption_channels=48)
    with torch.device(device):
        return cfg, _LTX2Joint(LTX2Transformer(cfg, dtype=dtype, lora_rank=4, remat=True))


def test_tiny_ltx2_on_the_card_matches_its_cpu_run(cuda):
    """The DiT (``_tiny_ltx2``) with tokenwise video sigmas, a per-sample
    audio sigma and a padded caption (40 keys, 17 valid in the second
    sample) against its CPU run: both predictions and the LoRA gradients
    within the card-against-CPU bound."""
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg, cpu = _tiny_ltx2(torch.float32, "cpu")
    init_parameters(cpu, torch.Generator().manual_seed(0))
    _, card = _tiny_ltx2(torch.bfloat16, cuda)
    gen = torch.Generator().manual_seed(4)
    mask = (torch.arange(40)[None] < torch.tensor([[40], [17]])).to(torch.int32)
    inputs = [torch.randn((2, 48, cfg.in_channels), generator=gen),
              torch.randn((2, 9, cfg.audio_in_channels), generator=gen),
              torch.randn((2, 40, cfg.caption_channels), generator=gen), torch.rand((2, 48), generator=gen),
              torch.tensor([0.9, 0.25]), mask]
    weight = torch.randn((2, 48 * cfg.in_channels + 9 * cfg.audio_in_channels), generator=gen)
    _card_against_cpu(cpu, card, inputs, weight, cuda)


def test_graphed_ltx2_joint_step_matches_eager_bitwise(cuda):
    """The tiny family's joint audiovisual step (5-D latents, 5 audio latent
    tokens whose noise the step draws, the first frame held clean at
    tokenwise t = 0; the RoPE tables made once per device in the eager
    steps): three eager steps and three replays of the captured step from
    the same state and generator state give the same losses, grad norms and
    audio losses bitwise."""
    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.training.optimizers import get_optimizer
    from simpletuner_tpu_torch.training.train_state import (build_train_step, create_train_state, jit_train_step,
                                                            state_tensors)

    config = TrainingConfig({"model_family": "ltxvideo2", "model_arch_preset": "tiny", "model_type": "lora",
                             "lora_rank": 4, "learning_rate": 1e-3, "optimizer": "adamw",
                             "gradient_checkpointing": True, "ltx2_first_frame_conditioning_probability": 1.0})
    gen = torch.Generator(device=cuda).manual_seed(9)
    model = ModelRegistry.create("ltxvideo2", config)
    with torch.device(cuda):
        module = init_parameters(model.create_module(), gen)
    batch = {"latents": torch.randn((1, 3, 4, 6, 8), generator=gen, device=cuda),
             "audio_latents": torch.randn((1, 5, 6), generator=gen, device=cuda),
             "text_embeds": torch.randn((1, 12, 20), generator=gen, device=cuda)}
    tx = get_optimizer(config, 1e-3)
    state = create_train_state(model, module, tx)
    step_fn = build_train_step(model, tx)
    with torch.no_grad():
        saved = [x.clone() for x in state_tensors(state)]
    rng = torch.Generator(device=cuda)
    rng.manual_seed(5)
    start = rng.get_state()

    def trajectory(step):
        current, out = state, []
        for _ in range(3):
            current, metrics = step(current, batch, rng)
            out += [metrics["loss"], metrics["grad_norm"], metrics["audio_loss"]]
        return torch.stack(out)

    eager = trajectory(step_fn)
    with torch.no_grad():
        for x, value in zip(state_tensors(state), saved):
            x.copy_(value)
    rng.set_state(start)
    state.step = 0
    graphed = jit_train_step(step_fn, state, batch, rng)
    replayed = trajectory(graphed)
    assert torch.isfinite(eager).all() and (eager[1::3] > 0).all()
    assert torch.equal(replayed, eager)


# ACE-Step at 47 s of 44.1 kHz audio (4,048 latents: 253 tokens of the mel
# layout) against its 385 conditioning keys (1 speaker, 256 umT5 and 128 lyric
# keys, 106 lyric ids valid) at 24 heads of 64; Wan-S2V's cross-attention over
# 512 umT5 and 128 audio-feature keys at the 14B's 40 heads of 128 and 32,760
# tokens; two heads (the heads are independent)
AUDIO_CASES = [("ace_cross_s253_k385_d64", 253, 385, 64, 363), ("s2v_cross_s32760_k640_d128", 32760, 640, 128, None)]


@pytest.mark.parametrize("name,sq,sk,dim,valid", AUDIO_CASES, ids=[c[0] for c in AUDIO_CASES])
def test_kernels_at_the_audio_family_shapes(cuda, name, sq, sk, dim, valid):
    """Forward and both backward kernels at ACE-Step's and Wan-S2V's
    cross-attention shapes against the plain versions, in the dispatcher's
    (B, S, H, D) layout; ACE-Step's lyric pad keys (key id -1) get no weight."""
    q, k, v = _qkv(150 + sk % 23 + dim, 1, 2, sq, sk, dim, cuda)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    q_seg = kv_seg = None
    if valid is not None:
        q_seg = torch.ones((1, sq), dtype=torch.int32, device=cuda)
        kv_seg = torch.where(torch.arange(sk, device=cuda) < valid, 1, SEGMENT_PAD_ID)[None].to(torch.int32)
    out, lse = _check(*strided, q_seg, kv_seg)
    assert out.shape == q.shape and torch.isfinite(lse).all()
    del out, lse
    dq, dk, dv = _check_backward(*strided, q_seg, seed=151, kv_seg=kv_seg)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    if valid is not None:
        assert dk[0, :, valid:].abs().max() == dv[0, :, valid:].abs().max() == 0


def _graphed_against_eager(cuda, values, batch):
    """Three eager steps and three replays of the captured step of a tiny
    family from the same state and generator state: losses and grad norms."""
    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.training.optimizers import get_optimizer
    from simpletuner_tpu_torch.training.train_state import (build_train_step, create_train_state, jit_train_step,
                                                            state_tensors)

    config = TrainingConfig({"model_arch_preset": "tiny", "model_type": "lora", "lora_rank": 4, "learning_rate": 1e-3,
                             "optimizer": "adamw", "gradient_checkpointing": True, **values})
    gen = torch.Generator(device=cuda).manual_seed(9)
    model = ModelRegistry.create(values["model_family"], config)
    with torch.device(cuda):
        module = init_parameters(model.create_module(), gen)
    with torch.no_grad():  # nonzero adapters: every LoRA B reaches the loss
        for name, param in module.named_parameters():
            if name.endswith("lora_B"):
                param.normal_(0.0, 0.05, generator=gen)
    tx = get_optimizer(config, 1e-3)
    state = create_train_state(model, module, tx)
    step_fn = build_train_step(model, tx)
    with torch.no_grad():
        saved = [x.clone() for x in state_tensors(state)]
    rng = torch.Generator(device=cuda)
    rng.manual_seed(5)
    start = rng.get_state()

    def trajectory(step):
        current, out = state, []
        for _ in range(3):
            current, metrics = step(current, batch, rng)
            out += [metrics["loss"], metrics["grad_norm"]]
        return torch.stack(out)

    eager = trajectory(step_fn)
    with torch.no_grad():
        for x, value in zip(state_tensors(state), saved):
            x.copy_(value)
    rng.set_state(start)
    state.step = 0
    graphed = jit_train_step(step_fn, state, batch, rng)
    replayed = trajectory(graphed)
    assert torch.isfinite(eager).all() and (eager[1::2] > 0).all()
    assert torch.equal(replayed, eager)


def test_graphed_ace_step_step_matches_eager_bitwise(cuda):
    """The tiny ACE-Step step on (B, S, C) audio latents with lyric ids and a
    padded lyric mask (the rope tables and the conformer's position table
    made once per device in the eager steps): replays of the captured step
    bitwise the eager steps."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    batch = {"latents": torch.randn((2, 32, 4), generator=gen, device=cuda),
             "text_embeds": torch.randn((2, 6, 16), generator=gen, device=cuda),
             "lyrics_tokens": torch.randint(0, 64, (2, 16), generator=gen, device=cuda, dtype=torch.int32),
             "lyrics_mask": (torch.arange(16, device=cuda)[None] < torch.tensor([[16], [9]], device=cuda)).float()}
    _graphed_against_eager(cuda, {"model_family": "ace_step"}, batch)


def test_graphed_wan_s2v_step_matches_eager_bitwise(cuda):
    """The tiny Wan-S2V step with audio features (64 wide, cut to the text
    width and joined after the text): replays of the captured step bitwise
    the eager steps."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    batch = {"latents": torch.randn((1, 3, 4, 6, 4), generator=gen, device=cuda),
             "text_embeds": torch.randn((1, 12, 32), generator=gen, device=cuda),
             "audio_embeds": torch.randn((1, 10, 64), generator=gen, device=cuda)}
    _graphed_against_eager(cuda, {"model_family": "wan_s2v"}, batch)
