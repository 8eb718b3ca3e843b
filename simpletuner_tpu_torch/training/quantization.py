"""Base-model weight quantization and the int8 matmul.

PyTorch counterpart of ``simpletuner_tpu/training/quantization.py``.  A LoRA
run stores its frozen base quantized per output channel and dequantizes (or
multiplies in int8) at each use site, inside the block's checkpoint scope, so
device memory holds the quantized copy plus one transient weight:

* ``int8``: ``weight`` (out, in) int8, ``round(w / s)`` clipped to +-127,
  ``s = max(absmax / 127, 1e-12)`` per output channel in ``weight_scale``;
* ``fp8``: ``weight`` (out, in) ``float8_e4m3fn`` = ``w / s``, ``s = absmax / 448``;
* ``int4``: ``weight_packed`` (out, in/2) uint8, two biased nibbles
  (``q + 8``, ``q`` in [-7, 7], ``s = absmax / 7``) per byte, the low nibble from
  the first half of the input axis and the high nibble from the second half
  (not even/odd columns), and no ``weight`` at all.

The port stores Linear weights as (out, in), the transpose of the Flax
``kernel`` (in, out); the per-output-channel scales and the int4 halves are
the same numbers in both layouts.

``int8_dynamic_dot`` is the SwitchBack-style product of the JAX package:
per-row symmetric int8 activations, an s8 x s8 -> s32 contraction
(``torch._int_mm``, cuBLASLt's int8 tensor-core GEMM on CUDA), and no weight
gradient.  The JAX package leaves this contraction to XLA (it is not a Pallas
kernel), and so does the port: ``torch._int_mm`` on every device, with the
row padding and operand layout that cuBLASLt needs on CUDA.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

logger = logging.getLogger(__name__)

# reference precision names (--base_model_precision) -> storage modes; the
# _SUBSTITUTED names map to the nearest format class and are logged
PRECISION_ALIASES = {
    "no_change": None,
    "int8-quanto": "int8",
    "int8-torchao": "int8",
    "int8-sdnq": "int8",
    "int8bnb": "int8",
    "int8": "int8",
    "fp8-quanto": "fp8",
    "fp8-torchao": "fp8",
    "fp8uz-quanto": "fp8",
    "fp8": "fp8",
    "int4-quanto": "int4",
    "int4": "int4",
    "nf4-bnb": "int4",  # same 4-bit storage class; symmetric grid, not NF4's
    "int2-quanto": "int4",  # no 2-bit path; int4 is the nearest format class
}

_SUBSTITUTED = {
    "nf4-bnb": "symmetric per-channel int4 (not the NF4 quantile grid)",
    "int2-quanto": "packed int4 (no int2 storage class on TPU)",
}

MODES = ("int8", "fp8", "int4")
QUANTIZED_MATMUL_MODES = ("off", "forward", "full", "auto")
_INT8_MAX, _FP8_MAX, _INT4_MAX = 127.0, 448.0, 7.0
_SCALE_FLOOR = 1e-12


def _absmax_scale(weight: torch.Tensor, qmax: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f32 weight, per-output-channel scale) of an (out, in) weight."""
    w = weight.to(torch.float32)
    return w, torch.clamp_min(w.abs().amax(dim=1) / qmax, _SCALE_FLOOR)


def quantize_weight(weight: torch.Tensor, mode: str) -> Dict[str, torch.Tensor]:
    """The stored tensors of one (out, in) weight: ``weight`` and
    ``weight_scale`` (int8, fp8), or ``weight_packed`` and ``weight_scale``
    (int4), with ``quantize_params``' formulas (quantization.py:124-162)."""
    if weight.dim() != 2:
        raise ValueError(f"quantize_weight takes an (out, in) weight, got shape {tuple(weight.shape)}")
    if mode == "int8":
        w, s = _absmax_scale(weight, _INT8_MAX)
        q = torch.clamp(torch.round(w / s[:, None]), -_INT8_MAX, _INT8_MAX).to(torch.int8)
        return {"weight": q, "weight_scale": s}
    if mode == "fp8":
        w, s = _absmax_scale(weight, _FP8_MAX)
        return {"weight": (w / s[:, None]).to(torch.float8_e4m3fn), "weight_scale": s}
    if mode == "int4":
        if weight.shape[1] % 2:
            raise ValueError(f"int4 packing needs an even input dim; the weight has shape {tuple(weight.shape)}")
        w, s = _absmax_scale(weight, _INT4_MAX)
        q = torch.clamp(torch.round(w / s[:, None]), -_INT4_MAX, _INT4_MAX).to(torch.int32) + 8
        half = weight.shape[1] // 2
        return {"weight_packed": (q[:, :half] | (q[:, half:] << 4)).to(torch.uint8), "weight_scale": s}
    raise ValueError(f"unknown quantization mode {mode!r}")


def quantize_dequantize(weight: torch.Tensor, mode: str) -> torch.Tensor:
    """Quantize -> dequantize round trip of an (out, in) weight in f32, with
    the formulas of :func:`quantize_weight` (the LoftQ residual's input)."""
    w = weight.to(torch.float32)
    if mode in ("int8", "int4"):
        qmax = _INT8_MAX if mode == "int8" else _INT4_MAX
        _, s = _absmax_scale(w, qmax)
        return torch.clamp(torch.round(w / s[:, None]), -qmax, qmax) * s[:, None]
    if mode == "fp8":
        _, s = _absmax_scale(w, _FP8_MAX)
        return (w / s[:, None]).to(torch.float8_e4m3fn).to(torch.float32) * s[:, None]
    raise ValueError(f"unknown quantization mode {mode!r}")


def unpack_int4_to_int8(packed: torch.Tensor) -> torch.Tensor:
    """(out, in/2) nibbles -> (out, in) int8 values in [-7, 7], no scale: the
    operand of the int8 product."""
    low = (packed & 0xF).to(torch.int8) - 8
    high = (packed >> 4).to(torch.int8) - 8
    return torch.cat([low, high], dim=1)


def unpack_int4(packed: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(out, in/2) nibbles + (out,) scales -> (out, in) weight in ``dtype``,
    the product taken in ``dtype`` as the JAX function does."""
    return unpack_int4_to_int8(packed).to(dtype) * scale[:, None].to(dtype)


def dequantize_weight(weight: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An int8 or fp8 (out, in) weight in ``dtype``: ``(w.f32 * scale).to(dtype)``."""
    return (weight.to(torch.float32) * scale[:, None].to(torch.float32)).to(dtype)


def dequantize_state_dict(
    state: Mapping[str, torch.Tensor], dtype: torch.dtype = torch.bfloat16
) -> Dict[str, torch.Tensor]:
    """A state dict with every quantized weight rebuilt in ``dtype`` (the
    counterpart of ``dequantize_params``, for export): it loads into a module
    of the same configuration that was never quantized."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in state.items():
        prefix = name[: len(name) - len(name.rpartition(".")[2])]
        leaf = name[len(prefix):]
        scale = state.get(prefix + "weight_scale")
        if leaf == "weight_scale":
            continue
        if leaf == "weight_packed":
            out[prefix + "weight"] = unpack_int4(value, scale, dtype)
        elif leaf == "weight" and scale is not None:
            out[name] = dequantize_weight(value, scale, dtype)
        else:
            out[name] = value
    return out


def has_quantized(state: Mapping[str, Any]) -> bool:
    """Whether a state dict holds a quantized weight."""
    return any(name.rpartition(".")[2] == "weight_scale" for name in state)


def resolve_precision(config: Any) -> Optional[str]:
    """``base_model_precision`` -> None, "int8", "fp8" or "int4"."""
    raw = getattr(config, "base_model_precision", None)
    if not raw or raw == "no_change":
        return None
    if raw not in PRECISION_ALIASES:
        raise ValueError(f"unknown base_model_precision {raw!r}; known: {sorted(PRECISION_ALIASES)}")
    if raw in _SUBSTITUTED:
        logger.warning(
            "base_model_precision=%s substituted with %s — numerics differ from the reference backend",
            raw, _SUBSTITUTED[raw],
        )
    return PRECISION_ALIASES[raw]


def resolve_quantized_matmul(config: Any) -> str:
    """``quantized_matmul`` -> "off", "forward" or "full".  A bool maps
    before the falsy fallback (``False`` is "off", not "auto"); "auto" is
    "full" for int8 and int4 bases and "off" otherwise."""
    raw = getattr(config, "quantized_matmul", None)
    if isinstance(raw, bool):
        raw = "forward" if raw else "off"
    raw = raw or "auto"
    if raw not in QUANTIZED_MATMUL_MODES:
        raise ValueError(f"unknown quantized_matmul mode {raw!r}; known: {QUANTIZED_MATMUL_MODES}")
    if raw == "auto":
        return "full" if resolve_precision(config) in ("int8", "int4") else "off"
    return raw


# ---- the int8 product ------------------------------------------------------------------------------

# cuBLASLt's int8 GEMM takes more than 16 rows, and k and n in multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_PAD_ROWS = 32
_INT_MM_ALIGN = 8


class Int8Matmul:
    """``a (m, k) int8 @ b (k, n) int8 -> (m, n) int32`` through ``torch._int_mm``.

    ``a`` is row-major and ``b`` must be K-major (the transpose of a
    row-major (n, k) tensor): the layout cuBLASLt's int8 path takes.  Fewer
    than 17 rows are padded with zero rows, and on the card a k or n off a
    multiple of 8 (Cosmos's patch embed: 17 channels x 4 = 68 features) with
    zero columns of ``a`` and zero rows and columns of ``b``, which leaves the
    product exact.
    ``launches`` goes up by one for every ``torch._int_mm`` call and for
    nothing else."""

    name = "int_mm"

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2:
            raise TypeError(f"int8 matmul takes 2-D int8 operands, got {a.dtype}{tuple(a.shape)} "
                            f"and {b.dtype}{tuple(b.shape)}")
        rows, k = a.shape
        n = b.shape[1]
        if a.is_cuda:
            if b.stride(0) != 1:
                raise ValueError("int8 matmul on CUDA needs a K-major second operand (a transposed row-major tensor)")
            k_pad, n_pad = -k % _INT_MM_ALIGN, -n % _INT_MM_ALIGN
            if k_pad or n_pad:  # pad b's row-major (n, k) transpose, so that b stays K-major
                a = F.pad(a, (0, k_pad))
                b = F.pad(b.t(), (0, k_pad, 0, n_pad)).t()
        a = a.contiguous()
        if rows < _INT_MM_MIN_ROWS:
            a = F.pad(a, (0, 0, 0, _INT_MM_PAD_ROWS - rows))
        out = torch._int_mm(a, b)
        self.launches += 1
        return out[:rows, :n]


int8_matmul = Int8Matmul()


def _dynamic_quantize(values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) symmetric int8: (int8 values, f32 scales (..., 1)).

    The JAX arithmetic in fewer passes over the activation: the row absmax
    of a bf16 row is exact in bf16, and ``div`` promotes to f32 as it reads."""
    low, high = torch.aminmax(values, dim=-1, keepdim=True)
    absmax = torch.maximum(high, -low).to(torch.float32)
    scales = torch.clamp_min(absmax / _INT8_MAX, _SCALE_FLOOR)
    return torch.div(values, scales).round_().to(torch.int8), scales


def _scaled(acc: torch.Tensor, *scales: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``acc.f32 * scales[0] * scales[1] ...`` in f32, left to right, rounded
    to ``dtype`` once: each product promotes the int32 or f32 operand as it
    reads, and the last one writes ``dtype`` directly."""
    out = torch.empty(acc.shape, dtype=dtype, device=acc.device)
    for scale in scales[:-1]:
        acc = torch.mul(acc, scale)
    return torch.mul(acc, scales[-1], out=out)


class Int8DynamicDot(torch.autograd.Function):
    """``y = (x_q @ w_q^T).f32 * x_scale * w_scale`` in ``x``'s dtype.

    Saves ``w_q`` and ``w_scale`` (never a dequantized weight) and ``x``'s
    dtype: the JAX residual holds ``x`` only for its dtype.  The backward
    returns ``dx`` alone (the base is frozen): in int8 when ``bwd_int8`` (dy
    pre-scaled by ``w_scale`` and quantized per row), else through the bf16
    dequantized weight."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, bwd_int8: bool) -> torch.Tensor:
        lead, k = x.shape[:-1], x.shape[-1]
        x_q, x_scales = _dynamic_quantize(x.reshape(-1, k))
        acc = int8_matmul(x_q, w_q.t())
        y = _scaled(acc, x_scales, w_scale.to(torch.float32), dtype=x.dtype)
        ctx.save_for_backward(w_q, w_scale)
        ctx.bwd_int8 = bwd_int8
        ctx.x_dtype = x.dtype
        return y.reshape(*lead, w_q.shape[0])

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        w_q, w_scale = ctx.saved_tensors
        lead, n = dy.shape[:-1], dy.shape[-1]
        dy = dy.reshape(-1, n)
        if ctx.bwd_int8:
            # dx_j = sum_o dy_o s_o w_q[o, j]: fold s into dy, contract in
            # int8; cuBLASLt wants the weight K-major (over out), so it goes
            # through a transposed copy (4-6x faster than the row-major operand)
            dy_q, dy_scales = _dynamic_quantize(torch.mul(dy, w_scale.to(torch.float32)))
            acc = int8_matmul(dy_q, w_q.t().contiguous().t())
            dx = _scaled(acc, dy_scales, dtype=ctx.x_dtype)
        else:
            w = (w_q.to(torch.float32) * w_scale[:, None].to(torch.float32)).to(torch.bfloat16)
            dx = torch.matmul(dy.to(torch.bfloat16), w).to(ctx.x_dtype)
        return dx.reshape(*lead, w_q.shape[1]), None, None, None


def int8_dynamic_dot(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, bwd_int8: bool = False) -> torch.Tensor:
    """``x`` (..., in) float, ``w_q`` (out, in) int8, ``w_scale`` (out,) f32 ->
    (..., out) in ``x``'s dtype, with the contraction in int8."""
    return Int8DynamicDot.apply(x, w_q, w_scale, bwd_int8)
