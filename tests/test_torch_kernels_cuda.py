"""The Hopper flash-attention kernel against its plain PyTorch version, on the card.

Skipped without CUDA: a CUDA kernel has no CPU mode.  Run on a machine with an
H100 (the JAX test bootstrap in conftest.py is not needed there):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from simpletuner_tpu_torch.ops import SEGMENT_PAD_ID, flash_attention, mha_reference_lse
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
    q96 = torch.zeros((1, 2, 128, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):
        flash_attention(q96, q96, q96)
