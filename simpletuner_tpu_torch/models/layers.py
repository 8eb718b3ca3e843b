"""Shared building blocks, the subset the Flux DiT uses.

PyTorch counterpart of ``simpletuner_tpu/models/layers.py``.  Submodule names
follow the JAX modules so that a Flax parameter tree maps onto a ``state_dict``
by name (``models/weight_bridge.py``).  Linear weights live in the compute
dtype (the JAX code casts its f32 kernels at use, layers.py:208/:217, so the
arithmetic is the same); norm scales stay f32 and norms compute in f32 with
``eps=1e-6``.  LoRA adapters are f32 master weights cast to the compute dtype
at use, as the JAX ``lora`` collection is (``param_dtype``, layers.py:277-297).

The dense path, the quantized frozen base (:func:`quantize_module`, the
use sites of layers.py:159-208) and the ``lora`` adapter algorithm are
ported; other adapter algorithms raise.  Which modules get an adapter is
decided by a predicate on the JAX module path (:func:`apply_lora_target`,
the counterpart of ``lora_path_enabled``, layers.py:77).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..training.quantization import (
    dequantize_weight,
    int8_dynamic_dot,
    quantize_weight,
    unpack_int4,
    unpack_int4_to_int8,
)

# flax lecun_normal draws N(0, 1) truncated at +-2 and rescales by this
# factor so that the truncated draw keeps unit variance
_TRUNCATED_NORMAL_STD = 0.87962566103423978


LORA_LEAVES = ("lora_A", "lora_B")


class LoRADense(nn.Module):
    """Linear layer with an optional low-rank adapter: y = x W^T + b + (a/r) (x A^T) B^T.

    ``weight`` is (out, in) and ``lora_A``/``lora_B`` are (rank, in)/(out, rank),
    the torch/PEFT orientation of the JAX (in, out)/(in, rank)/(rank, out)
    leaves.  The adapter is f32 and is cast to ``dtype`` at use.
    ``zero_init`` mirrors ``kernel_init=zeros`` (AdaLN-Zero).

    After :meth:`quantize_` the base is stored as ``training/quantization.py``
    lays it out (``quant`` names the mode) and is used as the JAX use site
    uses it: int8 (and int4, unpacked to int8) goes through
    ``int8_dynamic_dot`` unless ``quantized_matmul`` is "off" ("full" also
    runs dx in int8); otherwise the weight is dequantized to ``dtype`` at use.
    fp8 always dequantizes: the JAX package has no fp8 product.  The
    dequantized weight is a transient of the forward, so under a block's
    checkpoint device memory holds it for one layer at a time.  ``float8`` is
    a floating dtype, so ``Module.to(dtype)`` would cast an fp8 base: move a
    quantized module with ``.to(device)`` only."""

    def __init__(
        self,
        in_features: int,
        features: int,
        use_bias: bool = True,
        dtype: torch.dtype = torch.bfloat16,
        lora_rank: int = 0,
        lora_alpha: Optional[float] = None,
        lora_algo: str = "lora",
        zero_init: bool = False,
    ) -> None:
        super().__init__()
        if lora_algo != "lora":
            raise NotImplementedError(f"lora_algo={lora_algo!r} is not ported (only 'lora')")
        self.in_features = in_features
        self.features = features
        self.dtype = dtype
        self.zero_init = zero_init
        self.quant: Optional[str] = None
        self.quantized_matmul = "off"
        self.weight = nn.Parameter(torch.empty(features, in_features, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(features, dtype=dtype)) if use_bias else None
        self.lora_rank = lora_rank
        if lora_rank > 0:
            self.lora_scale = (lora_alpha if lora_alpha is not None else float(lora_rank)) / lora_rank
            self.lora_A = nn.Parameter(torch.empty(lora_rank, in_features, dtype=torch.float32))
            self.lora_B = nn.Parameter(torch.empty(features, lora_rank, dtype=torch.float32))

    def remove_adapter(self) -> None:
        if self.lora_rank > 0:
            del self.lora_A, self.lora_B
            self.lora_rank = 0

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.quant is not None:
            raise RuntimeError("initialise the weights before quantizing them")
        if self.zero_init:
            self.weight.zero_()
        else:
            lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            self.bias.zero_()
        if self.lora_rank > 0:
            # flax variance_scaling(1/3, fan_in, uniform) == U(+-1/sqrt(fan_in))
            bound = 1.0 / math.sqrt(self.in_features)
            self.lora_A.uniform_(-bound, bound, generator=generator)
            self.lora_B.zero_()

    @torch.no_grad()
    def quantize_(self, mode: str) -> None:
        """Replace the float weight by its quantized storage, in place: int8
        and fp8 keep a frozen ``weight`` parameter of that dtype, int4 holds a
        ``weight_packed`` buffer instead; ``weight_scale`` is a buffer."""
        if self.quant is not None:
            raise RuntimeError(f"the weight is already quantized ({self.quant})")
        stored = quantize_weight(self.weight, mode)
        del self.weight  # the float copy goes before the next layer is quantized
        if "weight" in stored:
            self.weight = nn.Parameter(stored["weight"], requires_grad=False)
        else:
            self.register_buffer("weight_packed", stored["weight_packed"])
        self.register_buffer("weight_scale", stored["weight_scale"])
        self.quant = mode

    @torch.no_grad()
    def dequantize_(self, dtype: torch.dtype = torch.bfloat16) -> None:
        """Replace the quantized storage by the float weight that
        ``dequantize_params`` rebuilds in ``dtype``, held in the layer's dtype
        (the JAX layer casts that kernel to its dtype at use), in place."""
        if self.quant is None:
            raise RuntimeError("the weight is not quantized")
        if self.quant == "int4":
            weight = unpack_int4(self.weight_packed, self.weight_scale, dtype)
            del self.weight_packed
        else:
            weight = dequantize_weight(self.weight, self.weight_scale, dtype)
            del self.weight
        del self.weight_scale
        self.weight = nn.Parameter(weight.to(self.dtype), requires_grad=False)
        self.quant = None

    def _base(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant is None:
            return F.linear(x, self.weight, self.bias)
        matmul = self.quantized_matmul
        if self.quant == "int4" and matmul != "off":
            y = int8_dynamic_dot(x, unpack_int4_to_int8(self.weight_packed), self.weight_scale, matmul == "full")
        elif self.quant == "int8" and matmul != "off":
            y = int8_dynamic_dot(x, self.weight, self.weight_scale, matmul == "full")
        elif self.quant == "int4":
            y = torch.matmul(x, unpack_int4(self.weight_packed, self.weight_scale, self.dtype).t())
        else:
            y = torch.matmul(x, dequantize_weight(self.weight, self.weight_scale, self.dtype).t())
        return y if self.bias is None else y + self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        y = self._base(x)
        if self.lora_rank > 0:
            h = F.linear(x, self.lora_A.to(self.dtype))
            y = y + self.lora_scale * F.linear(h, self.lora_B.to(self.dtype))
        return y


def apply_lora_target(module: nn.Module, predicate: Optional[Callable[[str], bool]]) -> nn.Module:
    """Drop the adapter of every ``LoRADense`` whose "/"-joined JAX module path
    fails ``predicate`` (None keeps every adapter), as ``lora_path_enabled``
    decides in the JAX package.  The port keeps the JAX submodule names, so the
    path is the torch module name with dots as slashes."""
    if predicate is not None:
        for name, sub in module.named_modules():
            if isinstance(sub, LoRADense) and sub.lora_rank > 0 and not predicate(name.replace(".", "/")):
                sub.remove_adapter()
    return module


def lora_parameters(module: nn.Module) -> Dict[str, nn.Parameter]:
    """The adapters by JAX path (``double_0/img_attn_q/lora_A``), in module order."""
    return {
        name.replace(".", "/"): param
        for name, param in module.named_parameters()
        if name.rsplit(".", 1)[-1] in LORA_LEAVES
    }


def freeze_base(module: nn.Module) -> Dict[str, nn.Parameter]:
    """LoRA training: every parameter but the adapters stops requiring grad
    (autograd then builds no base-weight gradients); returns the adapters."""
    adapters = lora_parameters(module)
    trainable = {id(p) for p in adapters.values()}
    for param in module.parameters():
        param.requires_grad_(id(param) in trainable)
    return adapters


def quantize_module(module: nn.Module, mode: str) -> nn.Module:
    """Quantize every ``LoRADense`` base weight of ``module`` in place, one
    layer at a time, so the float and the quantized copy of the whole base
    never coexist (the counterpart of ``quantize_params``, which quantizes
    every 2-D ``kernel``).  Returns ``module``."""
    for sub in module.modules():
        if isinstance(sub, LoRADense):
            sub.quantize_(mode)
    return module


def dequantize_module(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Rebuild every quantized ``LoRADense`` weight of ``module`` in place,
    one layer at a time, as ``dequantize_params`` rebuilds the frozen tree in
    ``dtype`` (bf16 by default, as ``TrainState.variables`` asks for it).
    Returns ``module``."""
    for sub in module.modules():
        if isinstance(sub, LoRADense) and sub.quant is not None:
            sub.dequantize_(dtype)
    return module


def set_quantized_matmul(module: nn.Module, mode: str) -> nn.Module:
    """Set the int8 product mode ("off", "forward" or "full", as
    ``resolve_quantized_matmul`` gives it) of every ``LoRADense`` in
    ``module``: the per-module counterpart of the JAX global
    ``set_quantized_matmul`` (layers.py:34)."""
    if mode not in ("off", "forward", "full"):
        raise ValueError(f"quantized_matmul mode {mode!r} is not one of off/forward/full")
    for sub in module.modules():
        if isinstance(sub, LoRADense):
            sub.quantized_matmul = mode
    return module


@torch.no_grad()
def lecun_normal_(tensor: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None) -> None:
    """flax ``lecun_normal``: truncated (+-2 sigma) normal with variance 1/fan_in.

    Drawn in f32 and copied, so a bf16 parameter gets a rounded f32 draw."""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_NORMAL_STD
    draw = torch.empty(tensor.shape, dtype=torch.float32, device=tensor.device)
    nn.init.trunc_normal_(draw, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    tensor.copy_(draw)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(dim, dtype=torch.float32))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_f = x.to(torch.float32)
        var = x_f.square().mean(dim=-1, keepdim=True)
        return (x_f * torch.rsqrt(var + self.eps) * self.scale).to(self.dtype)


def layer_norm(x: torch.Tensor, dtype: torch.dtype, eps: float = 1e-6) -> torch.Tensor:
    """``LayerNorm(use_scale=False, use_bias=False)``: f32 statistics, output in ``dtype``."""
    return F.layer_norm(x.to(torch.float32), (x.shape[-1],), eps=eps).to(dtype)


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, max_period: float = 10000.0, time_factor: float = 1000.0
) -> torch.Tensor:
    """Sinusoidal timestep embedding, cos before sin; sigma in [0, 1] is scaled by 1000."""
    timesteps = timesteps.to(torch.float32) * time_factor
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


class MLPEmbedder(nn.Module):
    """2-layer SiLU MLP used for time/vector/guidance conditioning."""

    def __init__(self, in_features: int, hidden_size: int, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.in_layer = LoRADense(in_features, hidden_size, dtype=dtype)
        self.out_layer = LoRADense(hidden_size, hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_layer(F.silu(self.in_layer(x)))


class FeedForward(nn.Module):
    """gelu(tanh) MLP, the JAX module's Flux branch (geglu/silu are not ported)."""

    def __init__(
        self,
        dim: int,
        mult: float = 4.0,
        dtype: torch.dtype = torch.bfloat16,
        lora_rank: int = 0,
        lora_alpha: Optional[float] = None,
        lora_algo: str = "lora",
    ) -> None:
        super().__init__()
        inner = int(dim * mult)
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.proj_in = LoRADense(dim, inner, **lora)
        self.proj_out = LoRADense(inner, dim, **lora)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj_out(F.gelu(self.proj_in(x), approximate="tanh"))


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(B, dim) mods broadcast over the sequence; (B, S, dim) mods apply per token."""
    if shift.dim() == 2:
        shift, scale = shift[:, None, :], scale[:, None, :]
    return x * (1.0 + scale) + shift


def gate_mod(gate: torch.Tensor) -> torch.Tensor:
    """Broadcast a (B, dim) gate over the sequence axis; pass (B, S, dim) through."""
    return gate[:, None, :] if gate.dim() == 2 else gate


class AdaLayerNormZero(nn.Module):
    """AdaLN-Zero: emits ``num_outputs`` (shift/scale/gate) chunks from the
    conditioning vector; ``lin`` starts at zero."""

    def __init__(
        self,
        dim: int,
        num_outputs: int = 6,
        dtype: torch.dtype = torch.bfloat16,
        lora_rank: int = 0,
        lora_alpha: Optional[float] = None,
        lora_algo: str = "lora",
    ) -> None:
        super().__init__()
        self.num_outputs = num_outputs
        self.lin = LoRADense(
            dim, dim * num_outputs, dtype=dtype, zero_init=True,
            lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo,
        )

    def forward(self, vec: torch.Tensor) -> List[torch.Tensor]:
        return list(self.lin(F.silu(vec)).chunk(self.num_outputs, dim=-1))


@torch.no_grad()
def init_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Seeded initialisation mirroring the Flax initialisers: lecun-normal
    dense and conv kernels, zero biases, unit norm scales, zero AdaLN ``lin``,
    and the ``lora`` adapter's U(+-1/sqrt(in)) A and zero B."""
    for sub in module.modules():
        if isinstance(sub, (LoRADense, RMSNorm)):
            sub.reset_parameters(generator)
        elif isinstance(sub, (nn.Linear, nn.Conv2d)):
            lecun_normal_(sub.weight, sub.weight[0].numel(), generator)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, nn.GroupNorm):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
    return module
