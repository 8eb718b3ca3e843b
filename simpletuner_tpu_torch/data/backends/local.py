"""Local filesystem backend (reference: helpers/data_backend/local.py).

The torch port's own copy of ``simpletuner_tpu/data/backends/local.py``."""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence

from .base import BaseDataBackend

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".webp", ".bmp", ".tiff", ".jxl")
VIDEO_EXTENSIONS = (".mp4", ".webm", ".mov", ".avi", ".mkv", ".gif")
AUDIO_EXTENSIONS = (".wav", ".mp3", ".flac", ".ogg", ".m4a")


class LocalDataBackend(BaseDataBackend):
    type = "local"

    def __init__(self, id: str, instance_data_dir: Optional[str] = None, compress_cache: bool = False):
        self.id = id
        self.instance_data_dir = instance_data_dir
        self.compress_cache = compress_cache

    def _resolve(self, location: str) -> str:
        return str(location)

    def abspath(self, location: str) -> str:
        """Local filesystem path for zero-copy consumers (video decode)."""
        return self._resolve(location)

    def read(self, location: str) -> bytes:
        with open(self._resolve(location), "rb") as handle:
            return handle.read()

    def write(self, location: str, data: bytes) -> None:
        path = Path(self._resolve(location))
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "wb") as handle:
            handle.write(data if isinstance(data, bytes) else bytes(data))
        os.replace(tmp, path)  # atomic like the reference's atomicwrites

    def delete(self, location: str) -> None:
        path = self._resolve(location)
        if os.path.exists(path):
            os.remove(path)

    def exists(self, location: str) -> bool:
        return os.path.exists(self._resolve(location))

    def list_files(
        self,
        file_extensions: Optional[Sequence[str]] = None,
        instance_data_dir: Optional[str] = None,
    ) -> List[str]:
        root = instance_data_dir or self.instance_data_dir
        if root is None or not os.path.isdir(root):
            return []
        extensions = tuple(
            ext.lower() if ext.startswith(".") else "." + ext.lower()
            for ext in (file_extensions or IMAGE_EXTENSIONS)
        )
        found: List[str] = []
        for dirpath, _dirnames, filenames in os.walk(root):
            for name in sorted(filenames):
                if name.lower().endswith(extensions):
                    found.append(os.path.join(dirpath, name))
        return sorted(found)

    def get_instance_representation(self):
        return {
            "type": self.type,
            "id": self.id,
            "instance_data_dir": self.instance_data_dir,
            "compress_cache": self.compress_cache,
        }
