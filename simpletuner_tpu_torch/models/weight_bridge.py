"""Flax parameter trees <-> the port's parameters.

The port keeps the JAX submodule names, so the bridge only renames leaves and
transposes: a dense ``kernel`` (in, out) becomes ``weight`` (out, in), a 1-D
conv ``kernel`` (k, in, out) ``weight`` (out, in, k), a conv
``kernel`` (kh, kw, in, out) becomes ``weight`` (out, in, kh, kw) and a 3-D
conv ``kernel`` (kt, kh, kw, in, out) ``weight`` (out, in, kt, kh, kw), ``lora_A``
(in, r) / ``lora_B`` (r, out) become (r, in) / (out, r), and a norm ``scale``
stays ``scale`` (RMSNorm) or becomes ``weight`` (GroupNorm); any other leaf
names a parameter of its module as it is (SD3's ``pos_embed`` table).  Values take the
dtype of the port's parameter (linear and conv weights the compute dtype,
norm scales f32), except the ``lora`` collection, which stays f32: it is the
optimizer's master copy.

A quantized base (``training/quantization.py``) crosses in its stored form:
int8 and fp8 ``kernel`` leaves (fp8 by its bytes) become ``weight``, and the
``qscales`` collection's ``kernel_scale`` (out,) and int4 ``kernel_packed``
(in/2, out) become ``weight_scale`` and ``weight_packed`` (out, in/2).  The
port's module must be quantized in the same mode first
(``layers.quantize_module``); a float tree loads into a float module, which
``create_train_state`` then quantizes.  The legacy ``QuantizedParam`` leaves
are not ported and raise.

:func:`lora_to_flax` maps the port's adapters back to a Flax ``lora`` tree and
:func:`flax_variables` the base (quantized or not) to ``params`` and
``qscales``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .layers import LORA_LEAVES, lora_parameters

_FLOAT_KINDS = ("float16", "float32", "float64", "bfloat16")
_QUANT_KINDS = ("int8", "uint8", "float8_e4m3fn")
_QSCALE_LEAVES = {"kernel_scale": "weight_scale", "kernel_packed": "weight_packed"}
_STORED = (torch.int8, torch.uint8, torch.float8_e4m3fn)  # quantized storage, never cast
# conv kernels by rank: flax (k..., in, out) <-> torch (out, in, k...)
_CONV_TO_TORCH = {3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_CONV_TO_FLAX = {3: (2, 1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _to_torch(path: Tuple[str, ...], value: Any) -> torch.Tensor:
    leaf = path[-1]
    if isinstance(value, torch.Tensor):  # an imported checkpoint's leaf: a (transposed) view, no copy
        if leaf in ("kernel", "kernel_packed") + LORA_LEAVES and value.dim() == 2:
            return value.t()
        if leaf == "kernel" and value.dim() in _CONV_TO_TORCH:
            return value.permute(*_CONV_TO_TORCH[value.dim()])
        return value
    if hasattr(value, "dequantize") and hasattr(value, "scales"):
        raise NotImplementedError(
            f"{'/'.join(path)} is a legacy QuantizedParam leaf, which the port does not read; "
            "store the base with quantize_params (the qscales layout) instead"
        )
    arr = np.asarray(value)
    kind = arr.dtype.name
    if kind not in _FLOAT_KINDS + _QUANT_KINDS:
        raise NotImplementedError(f"{'/'.join(path)} has dtype {kind}, which the port does not store")
    if kind == "bfloat16":
        arr = arr.astype(np.float32)
    if leaf in ("kernel", "kernel_packed") + LORA_LEAVES and arr.ndim == 2:
        arr = arr.T
    elif leaf == "kernel" and arr.ndim in _CONV_TO_TORCH:
        arr = arr.transpose(*_CONV_TO_TORCH[arr.ndim])
    if kind == "float8_e4m3fn":  # numpy has no fp8: carry the bytes
        return torch.from_numpy(np.array(arr.view(np.uint8), order="C")).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(arr, order="C"))  # a writable, C-ordered copy


def _target_name(path: Tuple[str, ...], target: Mapping[str, torch.Tensor]) -> str:
    module, leaf = "".join(p + "." for p in path[:-1]), path[-1]
    if leaf == "kernel":
        return f"{module}weight"
    if leaf in ("bias",) + LORA_LEAVES:
        return f"{module}{leaf}"
    if leaf == "scale":
        return f"{module}scale" if f"{module}scale" in target else f"{module}weight"
    if leaf in _QSCALE_LEAVES:
        return module + _QSCALE_LEAVES[leaf]
    if f"{module}{leaf}" in target:  # a parameter of the module itself (SD3's pos_embed)
        return f"{module}{leaf}"
    raise KeyError(f"no port counterpart for flax leaf {'/'.join(path)}")


def _checked(
    params: Mapping[str, Any],
    target: Mapping[str, torch.Tensor],
    lora: Optional[Mapping[str, Any]],
    qscales: Optional[Mapping[str, Any]],
    keep_adapters: bool,
) -> Dict[str, torch.Tensor]:
    """The Flax leaves by the name of the port tensor each lands on, as torch
    tensors in the leaf's dtype, every one checked against its port tensor."""
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, lora or {}, qscales or {}):
        for path, value in _flatten(tree):
            name = _target_name(path, target)
            tensor = _to_torch(path, value)
            if name not in target:
                raise KeyError(f"flax leaf {'/'.join(path)} -> {name}: not a tensor of the port")
            if tuple(tensor.shape) != tuple(target[name].shape):
                raise ValueError(f"{name}: flax shape {tuple(tensor.shape)} != port {tuple(target[name].shape)}")
            stored = tensor.dtype in _STORED
            if not _float8_values(tensor, target[name]) and (
                    stored != (target[name].dtype in _STORED) or (stored and tensor.dtype != target[name].dtype)):
                raise ValueError(f"{name}: flax {tensor.dtype} does not match the port's {target[name].dtype} "
                                 "(quantize the port's module in the tree's mode first)")
            out[name] = tensor
    missing = sorted(name for name in set(target) - set(out)
                     if not (keep_adapters and name.rsplit(".", 1)[-1] in LORA_LEAVES))
    if missing:
        raise KeyError(f"port tensors without a flax leaf: {missing[:8]}")
    return out


def _float8_values(tensor: torch.Tensor, target: torch.Tensor) -> bool:
    """An e4m3 leaf bound for a float (not quantized) tensor of the port: a
    float8 checkpoint's values (a quantized tree's e4m3 kernels come with
    their ``qscales``, which land on no float module)."""
    return tensor.dtype == torch.float8_e4m3fn and target.dtype not in _STORED


def flax_to_state_dict(
    params: Mapping[str, Any],
    module: nn.Module,
    lora: Optional[Mapping[str, Any]] = None,
    qscales: Optional[Mapping[str, Any]] = None,
    keep_adapters: bool = False,
) -> Dict[str, torch.Tensor]:
    """Map Flax ``params`` (and the ``lora`` and ``qscales`` collections) onto
    ``module``'s state dict.  Leaves are numpy arrays (a JAX tree) or CPU
    tensors (an imported checkpoint's, in the file's dtype).  Every leaf
    must land on a port tensor of the same shape and storage class (or be a
    float8 checkpoint's e4m3 values for a float tensor), and every port
    tensor must be set, except the adapters when ``keep_adapters`` is true."""
    target = module.state_dict()
    return {name: value.float() if name.rsplit(".", 1)[-1] in LORA_LEAVES else value.to(target[name].dtype)
            for name, value in _checked(params, target, lora, qscales, keep_adapters).items()}


def load_flax_params(
    module: nn.Module,
    params: Mapping[str, Any],
    lora: Optional[Mapping[str, Any]] = None,
    qscales: Optional[Mapping[str, Any]] = None,
    keep_adapters: bool = False,
) -> nn.Module:
    """Copy Flax weights into ``module`` in place (on its device); returns it.
    With ``keep_adapters`` the module's LoRA tensors that the tree lacks keep
    their values.  A float8 checkpoint's e4m3 values cross to the module's
    device as they are, one tensor at a time, and are cast there (exactly)."""
    target = module.state_dict()
    with torch.no_grad():
        for name, value in _checked(params, target, lora, qscales, keep_adapters).items():
            if _float8_values(value, target[name]):
                value = value.to(target[name].device)
            target[name].copy_(value)
    return module


def _numpy(tensor: torch.Tensor) -> np.ndarray:
    tensor = tensor.detach().cpu()
    if tensor.dtype == torch.float8_e4m3fn:
        import ml_dtypes  # numpy's fp8 type, read only for an fp8 base

        return tensor.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    return tensor.float().numpy() if tensor.dtype == torch.bfloat16 else tensor.numpy()


def flax_variables(module: nn.Module) -> Dict[str, Dict[str, Any]]:
    """The port's base as Flax collections: ``params`` (dense ``kernel`` (in,
    out), ``bias``, norm ``scale``) and, for a quantized base, ``qscales``,
    laid out as ``quantize_params`` leaves them; numpy leaves in the stored
    dtype.  The adapters are left out (:func:`lora_to_flax`)."""
    variables: Dict[str, Dict[str, Any]] = {"params": {}}
    for name, tensor in module.state_dict().items():
        *parents, leaf = name.split(".")
        if leaf in LORA_LEAVES:
            continue
        value = _numpy(tensor)
        if leaf in ("weight", "weight_packed") and value.ndim == 2:
            value = value.T
        elif leaf == "weight" and value.ndim in _CONV_TO_FLAX:
            value = value.transpose(*_CONV_TO_FLAX[value.ndim])
        if leaf in ("weight_scale", "weight_packed"):
            collection, leaf = "qscales", {v: k for k, v in _QSCALE_LEAVES.items()}[leaf]
        else:
            collection = "params"
            leaf = {"weight": "kernel" if value.ndim > 1 else "scale"}.get(leaf, leaf)
        node = variables.setdefault(collection, {})
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.array(value, order="C")
    return variables


def lora_to_flax(module: nn.Module) -> Dict[str, Any]:
    """The port's adapters as a Flax ``lora`` collection: nested dicts by
    module path with f32 numpy ``lora_A`` (in, r) and ``lora_B`` (r, out)."""
    tree: Dict[str, Any] = {}
    for path, param in lora_parameters(module).items():
        *parents, leaf = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = param.detach().float().cpu().numpy().T.copy()
    return tree
