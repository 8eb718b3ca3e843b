"""Attention backend dispatch.

PyTorch counterpart of ``simpletuner_tpu/ops/attention.py``: the same backend
names and reference aliases, the same (B, S, H, D) layout at the public
function.  ``auto`` resolves per call to the Hopper flash kernel for CUDA
tensors and to :func:`mha_reference` for CPU tensors; ``pallas_flash`` and
``splash`` name the flash kernel and ``xla`` the plain version.  The ``sla``
backend and context parallelism are not ported yet and raise.

The backend starts at ``auto`` and changes only through
:func:`set_attention_backend`; unlike the JAX package, no environment variable
selects it, because on the card ``xla`` and its aliases run the f32 plain
version with its S x S scores in device memory.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, mha_reference

_VALID_BACKENDS = ("auto", "pallas_flash", "xla", "splash", "sla")
_state = {"backend": "auto", "cp": None}

# Aliases so reference config values map onto the port's backends.
_ALIASES = {
    "flash": "pallas_flash",
    "flash_attn": "pallas_flash",
    "flash-attn": "pallas_flash",
    "sageattention": "pallas_flash",
    "xformers": "pallas_flash",
    "sdpa": "xla",
    "native": "xla",
    "native-xla": "xla",
    "math": "xla",
    "diffusers": "auto",
}


def set_attention_backend(name: str) -> None:
    """Select the backend of every later dispatch that names none.

    ``xla`` and its aliases run :func:`mha_reference` on CUDA tensors too: a
    parity check against the plain version, never a fast path."""
    name = _ALIASES.get(name, name)
    if name not in _VALID_BACKENDS:
        raise ValueError(f"unknown attention backend {name!r}; valid: {_VALID_BACKENDS}")
    _state["backend"] = name


def get_attention_backend() -> str:
    return _state["backend"]


def set_context_parallel(config) -> None:
    """Context parallelism is not ported yet; a non-None config makes every
    dispatch raise instead of silently running the local path."""
    _state["cp"] = config


def _resolve(backend: Optional[str], device: torch.device) -> str:
    name = _ALIASES.get(backend, backend) if backend else _state["backend"]
    if name not in _VALID_BACKENDS:
        raise ValueError(f"unknown attention backend {name!r}; valid: {_VALID_BACKENDS}")
    if name == "auto":
        return "pallas_flash" if device.type == "cuda" else "xla"
    return name


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Multi-head attention over ``(batch, seq, heads, head_dim)`` tensors.

    The kernel reads the (B, S, H, D) views through their strides, so no
    transposing copy is made on the way in."""
    if _state["cp"] is not None:
        raise NotImplementedError("context-parallel attention is not ported to the torch package yet")
    name = _resolve(backend, q.device)
    if name == "sla":
        raise NotImplementedError("the sla attention backend is not ported to the torch package yet")
    q_t, k_t, v_t = (x.transpose(1, 2) for x in (q, k, v))
    if name in ("pallas_flash", "splash"):
        out = flash_attention(q_t, k_t, v_t, q_segment_ids, kv_segment_ids, sm_scale=scale)
    else:
        out = mha_reference(q_t, k_t, v_t, q_segment_ids, kv_segment_ids, sm_scale=scale)
    return out.transpose(1, 2)
