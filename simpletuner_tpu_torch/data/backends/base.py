"""Storage backend ABC (reference: helpers/data_backend/base.py:8 ``BaseDataBackend``).

The torch port's copy of ``simpletuner_tpu/data/backends/base.py``, cut to what
the port reads and writes: raw bytes, and tensors in the reference's ``.pt``
cache format with optional gzip compression (base.py:126-153), so caches
written by the JAX package load here and the other way round.  Values load
as numpy arrays (bf16 as f32), as the JAX package loads them.
"""

from __future__ import annotations

import gzip
import io
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence


class BaseDataBackend(ABC):
    id: str
    type: str = "base"
    compress_cache: bool = False

    @abstractmethod
    def read(self, location: str) -> bytes: ...

    @abstractmethod
    def write(self, location: str, data: bytes) -> None: ...

    @abstractmethod
    def delete(self, location: str) -> None: ...

    @abstractmethod
    def exists(self, location: str) -> bool: ...

    @abstractmethod
    def list_files(self, file_extensions: Optional[Sequence[str]] = None, instance_data_dir: Optional[str] = None) -> List[str]: ...

    # ---- tensor (cache) IO -------------------------------------------------------------
    def _maybe_compress(self, payload: bytes) -> bytes:
        if self.compress_cache:
            return gzip.compress(payload)
        return payload

    def _maybe_decompress(self, payload: bytes) -> bytes:
        if payload[:2] == b"\x1f\x8b":  # gzip magic
            return gzip.decompress(payload)
        return payload

    def torch_save(self, obj: Any, location: str) -> None:
        """Serialize tensors/arrays in the reference's .pt cache format; numpy
        arrays are converted to torch tensors."""
        import numpy as np
        import torch

        def to_torch(value):
            if isinstance(value, torch.Tensor):
                return value
            if isinstance(value, np.ndarray):
                return torch.from_numpy(np.ascontiguousarray(value))
            if isinstance(value, dict):
                return {k: to_torch(v) for k, v in value.items()}
            if isinstance(value, (list, tuple)):
                return type(value)(to_torch(v) for v in value)
            return value

        buffer = io.BytesIO()
        torch.save(to_torch(obj), buffer)
        self.write(location, self._maybe_compress(buffer.getvalue()))

    def torch_load(self, location: str) -> Any:
        import torch

        payload = self._maybe_decompress(self.read(location))
        obj = torch.load(io.BytesIO(payload), map_location="cpu", weights_only=False)

        def to_numpy(value):
            if isinstance(value, torch.Tensor):
                t = value.detach().cpu()
                if t.dtype == torch.bfloat16:
                    t = t.to(torch.float32)
                return t.numpy()
            if isinstance(value, dict):
                return {k: to_numpy(v) for k, v in value.items()}
            if isinstance(value, (list, tuple)):
                return type(value)(to_numpy(v) for v in value)
            return value

        return to_numpy(obj)

    def get_instance_representation(self) -> Dict[str, Any]:
        return {"type": self.type, "id": self.id}
