"""Flash attention, forward and backward, over ``(batch, heads, seq, head_dim)`` tensors.

PyTorch counterpart of ``simpletuner_tpu/ops/flash_attention.py``.  On CUDA
tensors :func:`flash_attention` launches the hand-written Hopper kernels, all
warp-specialised TMA + wgmma kernels: ``csrc/flash_fwd.cu`` (the port of the
Pallas ``_fwd_kernel``) in the forward and ``csrc/flash_bwd.cu`` (the ports
of ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``) in the backward.  On CPU
tensors it runs their plain PyTorch versions, :func:`mha_reference_lse` and
:func:`mha_backward_reference`.  There is no fallback between the two: a
CUDA call that a kernel cannot take raises.  Each kernel has instances at
head dims 64, 128 and 256 (AuraFlow's); any other head dim up to 256 is
zero-padded to the next of them.

The differentiable op is ``torch.ops.simpletuner_tpu_torch.flash_attention``
(a ``torch.library`` custom op returning ``(out, lse)``), so selective
checkpointing can name it: the ``attn`` remat policy saves its outputs and
the recompute skips the forward kernel.

Segment ids (int32 per token) implement padding/sample masking: positions
attend only within equal segment ids, and ``SEGMENT_PAD_ID`` tokens are masked
out everywhere.  Rows that see no key emit exactly 0 and ``lse = -1e30``;
their dq is exactly 0, as are the dk and dv of keys nothing attends to.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Tuple

import torch

from .. import csrc

SEGMENT_PAD_ID = -1
DEFAULT_MASK_VALUE = -1e30
# (query, key) tiles of each kernel up to head dim 128; a ragged tail needs
# the masked mode
FWD_BLOCKS = (128, 128)
DQ_BLOCKS = (128, 64)
DKV_BLOCKS = (64, 128)
# the head dim 256 forms stream narrower tiles, so that the tiles fit in
# shared memory and the accumulators in registers (csrc/flash_fwd.cu
# ``block_n``, csrc/flash_bwd.cu ``DqSmem`` / ``DkvSmem``)
FWD_BLOCKS_256 = (128, 64)
DQ_BLOCKS_256 = (128, 32)
DKV_BLOCKS_256 = (32, 64)
# the kernels take these head dims; every other head dim up to 256 reaches
# them zero-padded to the next one (exact: the padded columns add 0 to every
# product, and sm_scale stays that of the unpadded head dim)
WGMMA_HEAD_DIMS = (64, 128, 256)
TILE_SKIP, TILE_FULL, TILE_MIXED = 0, 1, 2


def _segment_mask(q_segment_ids, kv_segment_ids, batch, sq, sk, device):
    if q_segment_ids is None:
        q_segment_ids = torch.zeros((batch, sq), dtype=torch.int32, device=device)
    if kv_segment_ids is None:
        kv_segment_ids = torch.zeros((batch, sk), dtype=torch.int32, device=device)
    q_ids = q_segment_ids[:, None, :, None]
    kv_ids = kv_segment_ids[:, None, None, :]
    return (q_ids == kv_ids) & (kv_ids != SEGMENT_PAD_ID)


def _tile_ranges(ids: torch.Tensor, block: int):
    """(min, max) over each tile of ``block`` ids, and (min, max, count)
    over its non-pad ids; positions past the end count as pad."""
    batch, length = ids.shape
    tiles = -(-length // block)
    padded = torch.full((batch, tiles * block), SEGMENT_PAD_ID, dtype=torch.int64, device=ids.device)
    padded[:, :length] = ids.to(torch.int64)
    padded = padded.view(batch, tiles, block)
    valid = padded != SEGMENT_PAD_ID
    big = torch.iinfo(torch.int64).max
    valid_lo = torch.where(valid, padded, torch.full_like(padded, big)).amin(-1)
    valid_hi = torch.where(valid, padded, torch.full_like(padded, -big)).amax(-1)
    return padded.amin(-1), padded.amax(-1), valid_lo, valid_hi, valid.sum(-1)


def tile_schedule(
    q_segment_ids: Optional[torch.Tensor],
    kv_segment_ids: Optional[torch.Tensor],
    sq: int,
    sk: int,
    block_q: int,
    block_k: int,
    batch: int = 1,
) -> torch.Tensor:
    """Class of every (query tile, key tile) pair of the segment mask, as the
    TMA + wgmma kernels schedule them (``hopper::tile_class`` in
    ``csrc/hopper.cuh``): (batch, q tiles, k tiles) int8 of ``TILE_SKIP`` (no
    pair of the two tiles attends), ``TILE_FULL`` (every pair attends) or
    ``TILE_MIXED``.  Missing ids are all 0; positions past the sequence are
    pad.  The rule reads only id ranges: skip when the key tile has no
    non-pad id or its non-pad range misses the query range, full when every
    key is non-pad and all ids of both tiles are one value."""
    if q_segment_ids is None:
        q_segment_ids = torch.zeros((batch, sq), dtype=torch.int32)
    if kv_segment_ids is None:
        kv_segment_ids = torch.zeros((batch, sk), dtype=torch.int32, device=q_segment_ids.device)
    q_lo, q_hi = _tile_ranges(q_segment_ids, block_q)[:2]
    _, _, kv_lo, kv_hi, kv_n = _tile_ranges(kv_segment_ids.to(q_segment_ids.device), block_k)
    q_lo, q_hi = q_lo[:, :, None], q_hi[:, :, None]
    kv_lo, kv_hi, kv_n = kv_lo[:, None, :], kv_hi[:, None, :], kv_n[:, None, :]
    skip = (kv_n == 0) | (kv_hi < q_lo) | (kv_lo > q_hi)
    full = (kv_n == block_k) & (q_lo == q_hi) & (kv_lo == kv_hi) & (q_lo == kv_lo)
    classes = torch.full(skip.shape, TILE_MIXED, dtype=torch.int8, device=skip.device)
    classes[full] = TILE_FULL
    classes[skip] = TILE_SKIP
    return classes


def _masked_scores(q, k, q_segment_ids, kv_segment_ids, sm_scale):
    """f32 scores with masked logits at -1e30, and the mask (None when unmasked)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if q_segment_ids is None and kv_segment_ids is None:
        return s, None
    batch, _, sq, sk = s.shape
    mask = _segment_mask(q_segment_ids, kv_segment_ids, batch, sq, sk, q.device)
    return torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE)), mask


def mha_reference_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention in f32; returns ``out`` (q's dtype) and ``lse`` (B, H, Sq) f32.

    The plain version of the forward kernel: same mask semantics, same
    fully-masked-row convention (out 0, lse -1e30)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s, mask = _masked_scores(q, k, q_segment_ids, kv_segment_ids, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
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


def mha_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor],
    kv_segment_ids: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward of the flash kernels; dq, dk, dv in q's dtype.

    The plain version of kernels ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``:
    f32 arithmetic with their rounding sites (dP from operands in q's dtype,
    dS and P rounded to it before their products, the scale applied after
    the f32 product), P recomputed from the saved ``lse`` and zeroed under the
    mask, delta = rowsum(out * do) in f32."""
    dtype = q.dtype
    s, mask = _masked_scores(q, k, q_segment_ids, kv_segment_ids, sm_scale)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    do_f = do.to(dtype).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do_f, v.float())
    delta = (out.float() * do.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(dtype).float()
    dq = sm_scale * torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = sm_scale * torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dtype).float(), do_f)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _kernel_head_dim(dim: int) -> int:
    """The head dim a kernel runs for ``dim``: 64, 128 or 256 as they are,
    every other ``dim`` <= 256 zero-padded to the next of the three."""
    if dim < 1:
        raise ValueError(f"head_dim must be positive, got {dim}")
    for width in WGMMA_HEAD_DIMS:
        if dim <= width:
            return width
    raise NotImplementedError(f"the flash kernels take head_dim <= 256, got {dim}")


def kernel_blocks(part: str, head_dim: int) -> Tuple[int, int]:
    """(query, key) tile of kernel ``part`` ("fwd", "dq" or "dkv") at the
    kernel head dim ``head_dim`` (64, 128 or 256)."""
    blocks = {"fwd": (FWD_BLOCKS, FWD_BLOCKS_256), "dq": (DQ_BLOCKS, DQ_BLOCKS_256),
              "dkv": (DKV_BLOCKS, DKV_BLOCKS_256)}[part]
    return blocks[head_dim == 256]


def _check_kernel_operands(kernel: str, q: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Device, dtype and layout checks shared by the kernel wrappers, on the
    operands as the kernel reads them (after any head-dim padding)."""
    for name, x in (("q", q), *tensors.items()):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{kernel}: {name} must be on q's CUDA device")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} takes bf16 operands, got {name}.dtype={x.dtype}")
        if x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError(f"{kernel}: {name} needs 4 dims with a unit-stride head dim")
        if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]):
            raise ValueError(f"{kernel}: {name} rows must be 16-byte aligned")


def _kernel_segments(kernel, q, k, q_segment_ids, kv_segment_ids):
    """Checked shapes; the segment ids as contiguous int32 (or None)."""
    batch, heads, sq, dim = q.shape
    sk = k.shape[2]
    if sq == 0 or sk == 0 or batch * heads > 65535:
        raise ValueError(f"{kernel}: unsupported sizes batch*heads={batch * heads} sq={sq} sk={sk}")
    segs = []
    for ids, length in ((q_segment_ids, sq), (kv_segment_ids, sk)):
        if ids is not None:
            if ids.shape != (batch, length) or ids.device != q.device:
                raise ValueError(f"{kernel}: segment ids {tuple(ids.shape)} != {(batch, length)}")
            ids = ids.to(torch.int32).contiguous()
        segs.append(ids)
    return segs


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _pad_head_dim(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its head dim zero-padded to :func:`_kernel_head_dim` (a
    contiguous copy; ``x`` itself when no padding is needed)."""
    width = _kernel_head_dim(x.shape[-1])
    return x if width == x.shape[-1] else torch.nn.functional.pad(x, (0, width - x.shape[-1]))


class FlashForwardKernel:
    """ctypes binding of ``st_flash_fwd_bf16`` with its launch count.

    ``launches`` goes up by one for every kernel launch and for nothing else;
    ``shape_launches`` counts the same launches by (heads, sq, sk, head dim)."""

    name = "flash_fwd"
    library = "flash_fwd"

    def __init__(self) -> None:
        self.launches = 0
        self.shape_launches: Counter = Counter()
        self._fn = None

    def _entry(self):
        if self._fn is None:
            lib = csrc.load(self.library)
            fn = lib.st_flash_fwd_bf16
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            fn.argtypes = [ptr] * 7 + [i64] * 9 + [i32] * 5 + [ctypes.c_float, i32, ptr]
            fn.restype = i32
            lib.st_flash_fwd_abi_version.restype = i32
            if lib.st_flash_fwd_abi_version() != 3:
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
        if k.shape != (batch, heads, sk, dim) or v.shape != k.shape:
            raise ValueError(f"flash kernel: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
        q, k, v = (_pad_head_dim(x) for x in (q, k, v))
        _check_kernel_operands("flash kernel", q, k=k, v=v)
        segs = _kernel_segments("flash kernel", q, k, q_segment_ids, kv_segment_ids)
        masked = any(s is not None for s in segs) or sk % kernel_blocks("fwd", q.shape[-1])[1] != 0

        out = torch.empty((batch, heads, sq, q.shape[-1]), dtype=torch.bfloat16, device=q.device)
        lse = torch.empty((batch, heads, sq), dtype=torch.float32, device=q.device)
        status = self._entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _ptr(segs[0]), _ptr(segs[1]),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            batch, heads, sq, sk, q.shape[-1], float(sm_scale), int(masked),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        if status != 0:  # a refused launch never runs; only cudaGetLastError shows it
            raise RuntimeError(f"flash_fwd launch failed with cudaError_t {status}")
        self.launches += 1
        self.shape_launches[(heads, sq, sk, dim)] += 1
        return (out if out.shape[-1] == dim else out[..., :dim].contiguous()), lse


class FlashBackwardKernel:
    """ctypes binding of one backward entry of ``csrc/flash_bwd.cu`` with its
    launch count: ``part`` "dq" writes dq, "dkv" writes dk and dv.

    Both read q, k, v and dO through their strides (unit stride on the head
    dim) and write their gradients in the layout of the tensor they belong
    to.  ``launches`` goes up by one for every kernel launch and for nothing
    else; ``shape_launches`` counts the same launches by (heads, sq, sk, head
    dim)."""

    library = "flash_bwd"

    def __init__(self, part: str) -> None:
        if part not in ("dq", "dkv"):
            raise ValueError(f"unknown backward kernel part {part!r}")
        self.part = part
        self.name = f"flash_bwd_{part}"
        self.launches = 0
        self.shape_launches: Counter = Counter()
        self._fn = None

    def _entry(self):
        if self._fn is None:
            lib = csrc.load(self.library)
            fn = getattr(lib, f"st_flash_bwd_{self.part}_bf16")
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            n_out = 1 if self.part == "dq" else 2
            fn.argtypes = [ptr] * (8 + n_out) + [ptr] + [i32] * 5 + [ctypes.c_float, i32, ptr]
            fn.restype = i32
            lib.st_flash_bwd_abi_version.restype = i32
            if lib.st_flash_bwd_abi_version() != 4:
                raise RuntimeError("flash_bwd library has an unexpected ABI version")
            self._fn = fn
        return self._fn

    def __call__(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        q_segment_ids: Optional[torch.Tensor],
        kv_segment_ids: Optional[torch.Tensor],
        lse: torch.Tensor,
        delta: torch.Tensor,
        do: torch.Tensor,
        sm_scale: float,
    ) -> Tuple[torch.Tensor, ...]:
        """dq (part "dq") or (dk, dv) (part "dkv")."""
        kernel = f"flash {self.part} kernel"
        batch, heads, sq, dim = q.shape
        sk = k.shape[2]
        if k.shape != (batch, heads, sk, dim) or v.shape != k.shape or do.shape != q.shape:
            raise ValueError(f"{kernel}: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
                             f"do{tuple(do.shape)}")
        for name, x in (("lse", lse), ("delta", delta)):
            if x.shape != (batch, heads, sq) or x.dtype != torch.float32 or not x.is_contiguous() \
                    or x.device != q.device:
                raise ValueError(f"{kernel}: {name} must be contiguous f32 {(batch, heads, sq)} on q's device")
        padded = _kernel_head_dim(dim) != dim
        grads = [torch.empty_like(q)] if self.part == "dq" else [torch.empty_like(k), torch.empty_like(v)]
        q, k, v, do = (_pad_head_dim(x) for x in (q, k, v, do))
        _check_kernel_operands(kernel, q, k=k, v=v, do=do)
        segs = _kernel_segments(kernel, q, k, q_segment_ids, kv_segment_ids)
        block_q, block_k = kernel_blocks(self.part, q.shape[-1])
        masked = any(s is not None for s in segs) or sq % block_q != 0 or sk % block_k != 0
        # a padded call writes padded gradients, sliced into ``grads`` below;
        # otherwise the kernel writes ``grads`` in place, in their inputs' layout
        outs = grads
        if padded:
            outs = [torch.empty_like(q)] if self.part == "dq" else [torch.empty_like(k), torch.empty_like(v)]
        for x in outs:
            if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]):
                raise ValueError(f"{kernel}: cannot lay out a gradient with strides {x.stride()}")

        layouts = [q, k, v, do] + outs + ([outs[0]] if len(outs) == 1 else [])
        strides = (ctypes.c_int64 * 18)(*[s for x in layouts for s in x.stride()[:3]])
        status = self._entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(segs[0]), _ptr(segs[1]), *[x.data_ptr() for x in outs], strides,
            batch, heads, sq, sk, q.shape[-1], float(sm_scale), int(masked),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        if status != 0:
            raise RuntimeError(f"{self.name} launch failed with cudaError_t {status}")
        self.launches += 1
        self.shape_launches[(heads, sq, sk, dim)] += 1
        if padded:
            for grad, wide in zip(grads, outs):
                grad.copy_(wide[..., :dim])
        return tuple(grads) if len(grads) > 1 else grads[0]


flash_fwd_kernel = FlashForwardKernel()
flash_bwd_dq_kernel = FlashBackwardKernel("dq")
flash_bwd_dkv_kernel = FlashBackwardKernel("dkv")


def flash_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor],
    kv_segment_ids: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of the flash forward: the dq and dkv kernels on CUDA
    tensors (delta = rowsum(out * do) in f32 computed here, as the Pallas
    wrapper does), :func:`mha_backward_reference` on CPU tensors."""
    if q.is_cuda:
        delta = (out.float() * do.float()).sum(dim=-1)
        lse = lse.contiguous()
        dq = flash_bwd_dq_kernel(q, k, v, q_segment_ids, kv_segment_ids, lse, delta, do, sm_scale)
        dk, dv = flash_bwd_dkv_kernel(q, k, v, q_segment_ids, kv_segment_ids, lse, delta, do, sm_scale)
        return dq, dk, dv
    if q.device.type == "cpu":
        return mha_backward_reference(q, k, v, q_segment_ids, kv_segment_ids, out, lse, do, sm_scale)
    raise NotImplementedError(f"flash attention backward has no path for device {q.device}")


@torch.library.custom_op("simpletuner_tpu_torch::flash_attention", mutates_args=())
def flash_attention_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor],
    kv_segment_ids: Optional[torch.Tensor],
    sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the forward kernel on CUDA, the plain version on CPU."""
    if q.is_cuda:
        return flash_fwd_kernel(q, k, v, q_segment_ids, kv_segment_ids, sm_scale)
    if q.device.type == "cpu":
        return mha_reference_lse(q, k, v, q_segment_ids, kv_segment_ids, sm_scale)
    raise NotImplementedError(f"flash_attention has no path for device {q.device}")


def _setup_context(ctx, inputs, output) -> None:
    q, k, v, q_segment_ids, kv_segment_ids, sm_scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, out, lse)
    ctx.mark_non_differentiable(lse)
    ctx.sm_scale = sm_scale


def _backward(ctx, d_out, _d_lse):
    q, k, v, q_segment_ids, kv_segment_ids, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_backward(q, k, v, q_segment_ids, kv_segment_ids, out, lse, d_out, ctx.sm_scale)
    return dq, dk, dv, None, None, None


torch.library.register_autograd(
    "simpletuner_tpu_torch::flash_attention", _backward, setup_context=_setup_context
)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Flash attention; ``out`` (B, H, Sq, D), plus ``lse`` (B, H, Sq) f32
    when ``return_lse``.  Differentiable in q, k and v.

    CUDA tensors go through the Hopper kernels (bf16 only); CPU tensors
    through the plain versions."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    out, lse = flash_attention_op(q, k, v, q_segment_ids, kv_segment_ids, float(sm_scale))
    return (out, lse) if return_lse else out
