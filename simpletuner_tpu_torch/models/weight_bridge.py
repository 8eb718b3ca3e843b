"""Flax parameter trees <-> the port's parameters.

The port keeps the JAX submodule names, so the bridge only renames leaves and
transposes: a dense ``kernel`` (in, out) becomes ``weight`` (out, in), a conv
``kernel`` (kh, kw, in, out) becomes ``weight`` (out, in, kh, kw), ``lora_A``
(in, r) / ``lora_B`` (r, out) become (r, in) / (out, r), and a norm ``scale``
stays ``scale`` (RMSNorm) or becomes ``weight`` (GroupNorm).  Values take the
dtype of the port's parameter (linear and conv weights the compute dtype,
norm scales f32), except the ``lora`` collection, which stays f32: it is the
optimizer's master copy.  Quantized leaves (int8/fp8/int4 bases) are refused.
:func:`lora_to_flax` maps the port's adapters back to a Flax ``lora`` tree.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .layers import LORA_LEAVES, lora_parameters

_FLOAT_KINDS = ("float16", "float32", "float64", "bfloat16")


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _to_torch(path: Tuple[str, ...], value: Any) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype.name not in _FLOAT_KINDS:
        raise NotImplementedError(
            f"{'/'.join(path)} has dtype {arr.dtype.name}: quantized bases are not ported"
        )
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    leaf = path[-1]
    if leaf == "kernel" and arr.ndim == 2:
        arr = arr.T
    elif leaf == "kernel" and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    elif leaf in LORA_LEAVES:
        arr = arr.T
    return torch.from_numpy(np.array(arr, order="C"))  # a writable, C-ordered copy


def _target_name(path: Tuple[str, ...], target: Mapping[str, torch.Tensor]) -> str:
    module, leaf = "".join(p + "." for p in path[:-1]), path[-1]
    if leaf == "kernel":
        return f"{module}weight"
    if leaf in ("bias",) + LORA_LEAVES:
        return f"{module}{leaf}"
    if leaf == "scale":
        return f"{module}scale" if f"{module}scale" in target else f"{module}weight"
    raise KeyError(f"no port counterpart for flax leaf {'/'.join(path)}")


def flax_to_state_dict(
    params: Mapping[str, Any],
    module: nn.Module,
    lora: Optional[Mapping[str, Any]] = None,
    ignore: Iterable[str] = (),
) -> Dict[str, torch.Tensor]:
    """Map Flax ``params`` (and the ``lora`` collection) onto ``module``'s
    state dict.  Top-level subtrees named in ``ignore`` are skipped (e.g. the
    VAE encoder, which the port does not have); every other leaf must land on a
    port parameter of the same shape, and every port parameter must be set."""
    target = module.state_dict()
    skip = set(ignore)
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, lora or {}):
        for path, value in _flatten(tree):
            if path[0] in skip:
                continue
            name = _target_name(path, target)
            if name not in target:
                raise KeyError(f"flax leaf {'/'.join(path)} -> {name}: not a parameter of the port")
            tensor = _to_torch(path, value)
            if tuple(tensor.shape) != tuple(target[name].shape):
                raise ValueError(f"{name}: flax shape {tuple(tensor.shape)} != port {tuple(target[name].shape)}")
            out[name] = tensor.float() if path[-1] in LORA_LEAVES else tensor.to(target[name].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port parameters without a flax leaf: {missing[:8]}")
    return out


def load_flax_params(
    module: nn.Module,
    params: Mapping[str, Any],
    lora: Optional[Mapping[str, Any]] = None,
    ignore: Iterable[str] = (),
) -> nn.Module:
    """Copy Flax weights into ``module`` in place (on its device); returns it."""
    module.load_state_dict(flax_to_state_dict(params, module, lora, ignore))
    return module


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
