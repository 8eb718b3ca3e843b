"""Flash attention forward over ``(batch, heads, seq, head_dim)`` tensors.

PyTorch counterpart of ``simpletuner_tpu/ops/flash_attention.py``.  On a CUDA
tensor :func:`flash_attention` launches the hand-written Hopper kernel in
``csrc/flash_fwd.cu`` (the port of the Pallas ``_fwd_kernel``); on a CPU tensor
it runs the plain PyTorch version, :func:`mha_reference_lse`.  There is no
fallback between the two: a CUDA call that the kernel cannot take raises.

Segment ids (int32 per token) implement padding/sample masking: positions
attend only within equal segment ids, and ``SEGMENT_PAD_ID`` tokens are masked
out everywhere.  Rows that see no key emit exactly 0 and ``lse = -1e30``.
The backward kernels (dq, dkv) belong to the training path and are not ported
yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import csrc

SEGMENT_PAD_ID = -1
DEFAULT_MASK_VALUE = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)
KERNEL_BLOCK_KV = 64  # key tile of csrc/flash_fwd.cu; a ragged tail needs the masked mode


def _segment_mask(q_segment_ids, kv_segment_ids, batch, sq, sk, device):
    if q_segment_ids is None:
        q_segment_ids = torch.zeros((batch, sq), dtype=torch.int32, device=device)
    if kv_segment_ids is None:
        kv_segment_ids = torch.zeros((batch, sk), dtype=torch.int32, device=device)
    q_ids = q_segment_ids[:, None, :, None]
    kv_ids = kv_segment_ids[:, None, None, :]
    return (q_ids == kv_ids) & (kv_ids != SEGMENT_PAD_ID)


def mha_reference_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention in f32; returns ``out`` (q's dtype) and ``lse`` (B, H, Sq) f32.

    The plain version of the flash kernel: same mask semantics, same
    fully-masked-row convention (out 0, lse -1e30)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    masked = q_segment_ids is not None or kv_segment_ids is not None
    if masked:
        batch, _, sq, sk = s.shape
        mask = _segment_mask(q_segment_ids, kv_segment_ids, batch, sq, sk, q.device)
        s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if masked:
        p = torch.where(mask, p, torch.zeros_like(p))
    denom = p.sum(dim=-1, keepdim=True)
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    out = torch.einsum("bhqk,bhkd->bhqd", p / safe, v.float()).to(q.dtype)
    lse = (m + torch.log(safe)).squeeze(-1)
    return out, lse


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Straightforward attention; ground truth for the kernel and the CPU path."""
    return mha_reference_lse(q, k, v, q_segment_ids, kv_segment_ids, sm_scale)[0]


class FlashForwardKernel:
    """ctypes binding of ``st_flash_fwd_bf16`` with its launch count.

    ``launches`` goes up by one for every kernel launch and for nothing else."""

    name = "flash_fwd"

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            lib = csrc.load(self.name)
            fn = lib.st_flash_fwd_bf16
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            fn.argtypes = [ptr] * 7 + [i64] * 9 + [i32] * 5 + [ctypes.c_float, i32, ptr]
            fn.restype = i32
            lib.st_flash_fwd_abi_version.restype = i32
            if lib.st_flash_fwd_abi_version() != 1:
                raise RuntimeError("flash_fwd library has an unexpected ABI version")
            self._fn = fn
        return self._fn

    def __call__(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        q_segment_ids: Optional[torch.Tensor],
        kv_segment_ids: Optional[torch.Tensor],
        sm_scale: float,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        batch, heads, sq, dim = q.shape
        sk = k.shape[2]
        for name, x in (("q", q), ("k", k), ("v", v)):
            if not x.is_cuda or x.device != q.device:
                raise ValueError(f"flash kernel: {name} must be on q's CUDA device")
            if x.dtype != torch.bfloat16:
                raise TypeError(f"flash kernel takes bf16 operands, got {name}.dtype={x.dtype}")
            if x.dim() != 4 or x.stride(-1) != 1:
                raise ValueError(f"flash kernel: {name} needs 4 dims with a unit-stride head dim")
            if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]):
                raise ValueError(f"flash kernel: {name} rows must be 16-byte aligned")
        if k.shape != (batch, heads, sk, dim) or v.shape != k.shape:
            raise ValueError(f"flash kernel: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
        if dim not in SUPPORTED_HEAD_DIMS:
            raise NotImplementedError(f"flash kernel supports head_dim {SUPPORTED_HEAD_DIMS}, got {dim}")
        if sq == 0 or sk == 0 or batch * heads > 65535:
            raise ValueError(f"flash kernel: unsupported sizes batch*heads={batch * heads} sq={sq} sk={sk}")
        segs = []
        for ids, length in ((q_segment_ids, sq), (kv_segment_ids, sk)):
            if ids is not None:
                if ids.shape != (batch, length) or ids.device != q.device:
                    raise ValueError(f"flash kernel: segment ids {tuple(ids.shape)} != {(batch, length)}")
                ids = ids.to(torch.int32).contiguous()
            segs.append(ids)
        masked = any(s is not None for s in segs) or sk % KERNEL_BLOCK_KV != 0

        out = torch.empty((batch, heads, sq, dim), dtype=torch.bfloat16, device=q.device)
        lse = torch.empty((batch, heads, sq), dtype=torch.float32, device=q.device)
        status = self._entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            segs[0].data_ptr() if segs[0] is not None else None,
            segs[1].data_ptr() if segs[1] is not None else None,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            batch, heads, sq, sk, dim, float(sm_scale), int(masked),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        if status != 0:  # a refused launch never runs; only cudaGetLastError shows it
            raise RuntimeError(f"flash_fwd launch failed with cudaError_t {status}")
        self.launches += 1
        return out, lse


flash_fwd_kernel = FlashForwardKernel()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Flash attention forward; ``out`` (B, H, Sq, D), plus ``lse`` (B, H, Sq)
    f32 when ``return_lse``.

    CUDA tensors go through the Hopper kernel (bf16 only); CPU tensors through
    the plain version."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        out, lse = flash_fwd_kernel(q, k, v, q_segment_ids, kv_segment_ids, sm_scale)
    elif q.device.type == "cpu":
        out, lse = mha_reference_lse(q, k, v, q_segment_ids, kv_segment_ids, sm_scale)
    else:
        raise NotImplementedError(f"flash_attention has no path for device {q.device}")
    return (out, lse) if return_lse else out
