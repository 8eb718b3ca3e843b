"""Flax parameter trees <-> the port's parameters.

The port keeps the JAX submodule names, so the bridge only renames leaves and
transposes: a dense ``kernel`` (in, out) becomes ``weight`` (out, in), a conv
``kernel`` (kh, kw, in, out) becomes ``weight`` (out, in, kh, kw), ``lora_A``
(in, r) / ``lora_B`` (r, out) become (r, in) / (out, r), and a norm ``scale``
stays ``scale`` (RMSNorm) or becomes ``weight`` (GroupNorm).  Values take the
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

from typing import Any, Dict, Iterable, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .layers import LORA_LEAVES, lora_parameters

_FLOAT_KINDS = ("float16", "float32", "float64", "bfloat16")
_QUANT_KINDS = ("int8", "uint8", "float8_e4m3fn")
_QSCALE_LEAVES = {"kernel_scale": "weight_scale", "kernel_packed": "weight_packed"}
_STORED = (torch.int8, torch.uint8, torch.float8_e4m3fn)  # quantized storage, never cast


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _to_torch(path: Tuple[str, ...], value: Any) -> torch.Tensor:
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
    leaf = path[-1]
    if leaf in ("kernel", "kernel_packed") + LORA_LEAVES and arr.ndim == 2:
        arr = arr.T
    elif leaf == "kernel" and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
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
    raise KeyError(f"no port counterpart for flax leaf {'/'.join(path)}")


def flax_to_state_dict(
    params: Mapping[str, Any],
    module: nn.Module,
    lora: Optional[Mapping[str, Any]] = None,
    ignore: Iterable[str] = (),
    qscales: Optional[Mapping[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Map Flax ``params`` (and the ``lora`` and ``qscales`` collections) onto
    ``module``'s state dict.  Top-level subtrees named in ``ignore`` are
    skipped (e.g. the VAE encoder, which the port does not have); every other
    leaf must land on a port tensor of the same shape and storage class, and
    every port tensor must be set."""
    target = module.state_dict()
    skip = set(ignore)
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, lora or {}, qscales or {}):
        for path, value in _flatten(tree):
            if path[0] in skip:
                continue
            name = _target_name(path, target)
            tensor = _to_torch(path, value)
            if name not in target:
                raise KeyError(f"flax leaf {'/'.join(path)} -> {name}: not a tensor of the port")
            if tuple(tensor.shape) != tuple(target[name].shape):
                raise ValueError(f"{name}: flax shape {tuple(tensor.shape)} != port {tuple(target[name].shape)}")
            stored = tensor.dtype in _STORED
            if stored != (target[name].dtype in _STORED) or (stored and tensor.dtype != target[name].dtype):
                raise ValueError(f"{name}: flax {tensor.dtype} does not match the port's {target[name].dtype} "
                                 "(quantize the port's module in the tree's mode first)")
            out[name] = tensor.float() if path[-1] in LORA_LEAVES else tensor.to(target[name].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port tensors without a flax leaf: {missing[:8]}")
    return out


def load_flax_params(
    module: nn.Module,
    params: Mapping[str, Any],
    lora: Optional[Mapping[str, Any]] = None,
    ignore: Iterable[str] = (),
    qscales: Optional[Mapping[str, Any]] = None,
) -> nn.Module:
    """Copy Flax weights into ``module`` in place (on its device); returns it."""
    module.load_state_dict(flax_to_state_dict(params, module, lora, ignore, qscales))
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
        elif leaf == "weight" and value.ndim == 4:
            value = value.transpose(2, 3, 1, 0)
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
