"""Block-quantized optimizer states (8-bit / 4-bit / fp8 Adam moments, 8-bit Lion).

PyTorch counterpart of ``simpletuner_tpu/training/optim_quant.py``: the moments
live as ``int8``, packed 4-bit (``uint8``) or ``float8_e4m3fn`` tensors with one
f32 scale per block of 256 elements, and are dequantized, updated and
quantized again at every step.

* a leaf is flattened, zero-padded to a multiple of the block and cut into
  rows of ``block`` elements; each row keeps its absmax;
* int8 and int4 use log-spaced codes (code 0 is 0, code +-i is
  +-exp(-range + (i - 1) * step) times the absmax), over 2^16 of range for
  int8 and 2^8 for signed int4; Adam's non-negative second moment spends all
  15 4-bit codes on magnitudes over 2^12 of range;
* fp8 stores ``x / (absmax / 240)`` in e4m3 (240, not 448: headroom for the
  moments' growth);
* the 4-bit *state* packs even/odd elements of a row (element 2j in the high
  nibble, 2j+1 in the low), unlike the int4 *weight*, which packs the two
  halves of the input axis;
* leaves under ``min_quant_size`` (4096) elements keep f32 moments.

The port's trainable tensors are the transposes of the Flax leaves they stand
for (LoRA ``A`` (r, in) against the JAX (in, r)), so a 2-D tensor is walked in
its transpose's order: the blocks then hold the same elements as the JAX
package's and the two states agree code for code.

Divisions by a constant go through a device tensor: CUDA turns a division
by a host scalar into a multiplication by its reciprocal, which is not the
JAX arithmetic.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .optimizers import Optimizer, Tensors, bias_corrections, zero_count

DEFAULT_BLOCK = 256
INT4_PACKED = "int4_packed"  # two 4-bit codes per uint8 byte

_INT8_LEVELS = 127
_INT8_RANGE_LN = 16.0 * 0.6931471805599453  # 2^16
_INT4_LEVELS = 7  # signed: sign x 7 levels
_INT4_RANGE_LN = 8.0 * 0.6931471805599453  # 2^8
_UINT4_LEVELS = 15  # unsigned (second moment): 15 levels
_UINT4_RANGE_LN = 12.0 * 0.6931471805599453  # 2^12
_FP8_MAX = 240.0


def _divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    return torch.div(x, torch.full((), divisor, dtype=x.dtype, device=x.device))


def _zero_threshold(range_ln: float, like: torch.Tensor) -> torch.Tensor:
    """``exp(-range) * 0.5`` in f32: magnitudes below it take code 0."""
    return torch.exp(torch.full((), -range_ln, dtype=torch.float32, device=like.device)) * 0.5


def _log_index(mag: torch.Tensor, levels: int, range_ln: float) -> torch.Tensor:
    """Code magnitude in [0, levels] of non-negative ``mag`` (a float tensor)."""
    step = range_ln / (levels - 1)
    idx = torch.round(_divide(torch.log(torch.clamp_min(mag, 1e-30)) + range_ln, step)) + 1.0
    idx = torch.clamp(idx, 0.0, float(levels))
    return torch.where(mag < _zero_threshold(range_ln, mag), 0.0, idx)


def _log_code(norm: torch.Tensor, levels: int, range_ln: float) -> torch.Tensor:
    """Signed log-spaced code in [-levels, levels]; 0 encodes 0."""
    return torch.sign(norm) * _log_index(norm.abs(), levels, range_ln)


def _log_decode(code: torch.Tensor, levels: int, range_ln: float) -> torch.Tensor:
    step = range_ln / (levels - 1)
    mag = torch.exp(-range_ln + (code.abs() - 1.0) * step)
    return torch.sign(code) * torch.where(code == 0, 0.0, mag)


def quantize_blockwise(x: torch.Tensor, dtype: Any, block: int = DEFAULT_BLOCK, unsigned: bool = False):
    """(q, scale): ``q`` of ``dtype`` (``torch.int8``, ``torch.float8_e4m3fn``
    or ``INT4_PACKED``) shaped (blocks, block) (half as wide when packed),
    ``scale`` (blocks, 1) f32.  ``unsigned`` (4-bit only) codes magnitudes."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    absmax = blocks.abs().amax(dim=1, keepdim=True)

    if dtype == INT4_PACKED:
        norm = blocks / torch.where(absmax > 0, absmax, 1.0)
        if unsigned:
            nibble = _log_index(norm.abs(), _UINT4_LEVELS, _UINT4_RANGE_LN).to(torch.uint8)
        else:
            nibble = (_log_code(norm, _INT4_LEVELS, _INT4_RANGE_LN) + 8.0).to(torch.uint8)  # 1..15, 8 = zero
        return (nibble[:, 0::2] << 4) | nibble[:, 1::2], absmax
    if dtype == torch.float8_e4m3fn:
        scale = _divide(absmax, _FP8_MAX)
        return (blocks / torch.where(scale > 0, scale, 1.0)).to(dtype), scale
    if dtype == torch.int8:
        norm = blocks / torch.where(absmax > 0, absmax, 1.0)
        return _log_code(norm, _INT8_LEVELS, _INT8_RANGE_LN).to(torch.int8), absmax
    raise ValueError(f"unsupported quantized state dtype {dtype}")


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int],
                         block: int = DEFAULT_BLOCK, unsigned: bool = False) -> torch.Tensor:
    """The f32 tensor of ``shape`` that ``quantize_blockwise`` coded."""
    if q.dtype == torch.uint8:
        nibbles = torch.stack([(q >> 4) & 0xF, q & 0xF], dim=-1).reshape(q.shape[0], -1).to(torch.float32)
        if unsigned:
            step = _UINT4_RANGE_LN / (_UINT4_LEVELS - 1)
            mag = torch.exp(-_UINT4_RANGE_LN + (nibbles - 1.0) * step)
            values = torch.where(nibbles == 0, 0.0, mag)
        else:
            values = _log_decode(nibbles - 8.0, _INT4_LEVELS, _INT4_RANGE_LN)
    elif q.dtype == torch.float8_e4m3fn:
        values = q.to(torch.float32)
    else:
        values = _log_decode(q.to(torch.float32), _INT8_LEVELS, _INT8_RANGE_LN)
    return (values * scale).reshape(-1)[: math.prod(shape)].reshape(tuple(shape))


def _jax_order(x: torch.Tensor) -> torch.Tensor:
    """The tensor in the layout of its Flax leaf (a view): 2-D tensors are transposed."""
    return x.t() if x.dim() == 2 else x


def _zero_moment(p: torch.Tensor, dtype: Any, block: int, min_quant_size: int,
                 unsigned: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(state, scale) of a zero moment for ``p``: f32 below ``min_quant_size``
    elements (with a dummy scale), else coded by ``quantize_blockwise``."""
    if p.numel() < min_quant_size:
        return torch.zeros_like(p, dtype=torch.float32), torch.zeros((), device=p.device)
    zeros = torch.zeros(_jax_order(p).shape, dtype=torch.float32, device=p.device)
    return quantize_blockwise(zeros, dtype, block, unsigned=unsigned)


@dataclasses.dataclass
class QuantizedAdamState:
    count: torch.Tensor
    mu_q: Tensors
    mu_scale: Tensors
    nu_q: Tensors
    nu_scale: Tensors


@dataclasses.dataclass(frozen=True)
class AdamWQuantized(Optimizer):
    """``adamw_quantized``: ``scale_by_adam_quantized`` (moments stored by
    ``quantize_blockwise``), then ``add_decayed_weights``, then the learning
    rate read at the count before the update."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-2
    state_dtype: Any = torch.int8
    block_size: int = DEFAULT_BLOCK
    min_quant_size: int = 4096

    def init(self, params: Tensors) -> QuantizedAdamState:
        zeros = functools.partial(_zero_moment, dtype=self.state_dtype, block=self.block_size,
                                  min_quant_size=self.min_quant_size)
        mu = {k: zeros(p) for k, p in params.items()}
        nu = {k: zeros(p, unsigned=True) for k, p in params.items()}
        return QuantizedAdamState(zero_count(params), {k: v[0] for k, v in mu.items()},
                                  {k: v[1] for k, v in mu.items()}, {k: v[0] for k, v in nu.items()},
                                  {k: v[1] for k, v in nu.items()})

    def _update(self, grads: Tensors, state: QuantizedAdamState, params: Tensors, lr: Optional[torch.Tensor]):
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        bc1, bc2 = bias_corrections(count, b1, b2)
        neg_lr = -self._lr(state.count, lr)
        new = QuantizedAdamState(count, {}, {}, {}, {})
        updates = {}
        for k, g in grads.items():
            mq, ms, nq, ns = state.mu_q[k], state.mu_scale[k], state.nu_q[k], state.nu_scale[k]
            if g.numel() < self.min_quant_size:
                m = mq * b1 + g * (1.0 - b1)
                n = nq * b2 + g.square() * (1.0 - b2)
                u = (m / bc1) / (torch.sqrt(n / bc2) + self.eps)
                new.mu_q[k], new.mu_scale[k], new.nu_q[k], new.nu_scale[k] = m, ms, n, ns
            else:
                g = _jax_order(g)
                m = dequantize_blockwise(mq, ms, g.shape, self.block_size) * b1 + g * (1.0 - b1)
                n = (dequantize_blockwise(nq, ns, g.shape, self.block_size, unsigned=True) * b2
                     + g.square() * (1.0 - b2))
                u = _jax_order((m / bc1) / (torch.sqrt(n / bc2) + self.eps))
                new.mu_q[k], new.mu_scale[k] = quantize_blockwise(m, self.state_dtype, self.block_size)
                new.nu_q[k], new.nu_scale[k] = quantize_blockwise(n, self.state_dtype, self.block_size,
                                                                  unsigned=True)
            updates[k] = neg_lr * (u + self.weight_decay * params[k].float())
        return updates, new


@dataclasses.dataclass
class QuantizedLionState:
    count: torch.Tensor
    mu_q: Tensors
    mu_scale: Tensors


@dataclasses.dataclass(frozen=True)
class LionQuantized(Optimizer):
    """``lion_quantized`` (bnb-lion8bit): Lion with its one momentum buffer
    stored by ``quantize_blockwise``, then the learning rate read at the
    count before the update."""

    b1: float = 0.9
    b2: float = 0.99
    weight_decay: float = 1e-2
    state_dtype: Any = torch.int8
    block_size: int = DEFAULT_BLOCK
    min_quant_size: int = 4096

    def init(self, params: Tensors) -> QuantizedLionState:
        mu = {k: _zero_moment(p, self.state_dtype, self.block_size, self.min_quant_size) for k, p in params.items()}
        return QuantizedLionState(zero_count(params), {k: v[0] for k, v in mu.items()},
                                  {k: v[1] for k, v in mu.items()})

    def _update(self, grads: Tensors, state: QuantizedLionState, params: Tensors, lr: Optional[torch.Tensor]):
        neg_lr = -self._lr(state.count, lr)
        new = QuantizedLionState(state.count + 1, {}, {})
        updates = {}
        for k, g in grads.items():
            mq, ms, p = state.mu_q[k], state.mu_scale[k], params[k].float()
            small = g.numel() < self.min_quant_size
            if not small:
                g, p = _jax_order(g), _jax_order(p)
            m = mq if small else dequantize_blockwise(mq, ms, g.shape, self.block_size)
            direction = torch.sign(m * self.b1 + g * (1.0 - self.b1))
            new_m = m * self.b2 + g * (1.0 - self.b2)
            step = direction + self.weight_decay * p
            updates[k] = neg_lr * (step if small else _jax_order(step))
            if small:
                new.mu_q[k], new.mu_scale[k] = new_m, ms
            else:
                new.mu_q[k], new.mu_scale[k] = quantize_blockwise(new_m, self.state_dtype, self.block_size)
        return updates, new
