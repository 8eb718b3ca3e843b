"""Auxiliary platform services backing the extra API routes (hardware,
version, checkpoints, prompt libraries, dataset viewer, webhooks, system).

The torch port's copy of ``simpletuner_tpu/server/extras.py``: small helpers
consumed by ``server/app.py``.  ``hardware_info`` and ``version_info`` report
torch, CUDA and the ``torch.cuda`` devices where the JAX helpers report JAX;
the rest is the same.
"""

from __future__ import annotations

import base64
import io
import json
import os
import platform
import re
import shutil
import sys
import time
from typing import Any, Dict, List, Optional

_START_TIME = time.time()

_SAFE_NAME = re.compile(r"^[\w.-]{1,80}$")


# ---- hardware / system (reference routes/hardware.py, system.py) -----------------------


def hardware_info() -> Dict[str, Any]:
    """Accelerator + host inventory: the ``torch.cuda`` devices (name, total
    memory, this process's allocated and peak bytes) and their count, in the
    JAX report's schema.  Without a card the list is empty and ``backend`` is
    ``cpu``.  Reading the device properties creates no CUDA context."""
    info: Dict[str, Any] = {
        "host": {
            "platform": platform.platform(),
            "python": platform.python_version(),
            "cpu_count": os.cpu_count(),
        },
        "accelerators": [],
    }
    try:
        load1, load5, load15 = os.getloadavg()
        info["host"]["loadavg"] = [load1, load5, load15]
    except OSError:  # pragma: no cover
        pass
    try:
        page = os.sysconf("SC_PAGE_SIZE")
        info["host"]["mem_total_bytes"] = page * os.sysconf("SC_PHYS_PAGES")
        info["host"]["mem_available_bytes"] = page * os.sysconf("SC_AVPHYS_PAGES")
    except (ValueError, OSError):  # pragma: no cover
        pass
    usage = shutil.disk_usage(os.getcwd())
    info["host"]["disk"] = {"total_bytes": usage.total, "free_bytes": usage.free}
    try:
        import torch

        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        info["backend"] = "cuda" if count else "cpu"
        for index in range(count):
            props = torch.cuda.get_device_properties(index)
            info["accelerators"].append({
                "id": index,
                "kind": props.name,
                "platform": "gpu",
                "process_index": 0,
                "memory": {
                    "bytes_in_use": torch.cuda.memory_allocated(index),
                    "bytes_limit": props.total_memory,
                    "peak_bytes_in_use": torch.cuda.max_memory_allocated(index),
                },
            })
        info["device_count"] = count
        info["process_count"] = 1
    except Exception as exc:  # pragma: no cover - torch import/device failure
        info["error"] = str(exc)
    return info


def system_info(state_dir: str, sse_clients: int) -> Dict[str, Any]:
    return {
        "version": version_info(),
        "state_dir": state_dir,
        "uptime_seconds": time.time() - _START_TIME,
        "sse_clients": sse_clients,
        "pid": os.getpid(),
        "argv0": sys.argv[0],
    }


def version_info() -> Dict[str, Any]:
    """The port's version, torch's, the CUDA it was built with and the card's
    name (None without one)."""
    from .. import __version__

    out: Dict[str, Any] = {"simpletuner_tpu_torch": __version__}
    try:
        import torch

        out["torch"] = torch.__version__
        out["cuda"] = torch.version.cuda
        out["device"] = torch.cuda.get_device_name(0) if torch.cuda.is_available() else None
    except Exception:  # pragma: no cover
        out.update(torch=None, cuda=None, device=None)
    return out


# ---- checkpoints (reference routes/checkpoints.py) -------------------------------------


def list_checkpoints(output_dir: str) -> List[Dict[str, Any]]:
    """Inventory checkpoint directories with completeness (guard file),
    manifest metadata, and exported release artifacts (safetensors)."""
    from ..training.checkpoints import GUARD_FILE, MANIFEST_FILE

    entries: List[Dict[str, Any]] = []
    if not os.path.isdir(output_dir):
        return entries
    pattern = re.compile(r"^(rolling-)?checkpoint-(\d+)$")
    for name in sorted(os.listdir(output_dir)):
        match = pattern.match(name)
        if not match:
            continue
        path = os.path.join(output_dir, name)
        if not os.path.isdir(path):
            continue
        entry: Dict[str, Any] = {
            "name": name,
            "path": path,
            "step": int(match.group(2)),
            "rolling": bool(match.group(1)),
            "complete": os.path.exists(os.path.join(path, GUARD_FILE)),
            "mtime": os.path.getmtime(path),
        }
        manifest_path = os.path.join(path, MANIFEST_FILE)
        if os.path.exists(manifest_path):
            try:
                with open(manifest_path) as handle:
                    entry["manifest"] = json.load(handle)
            except (OSError, json.JSONDecodeError):
                entry["manifest"] = None
        exports = [
            f for f in os.listdir(path)
            if f.endswith(".safetensors") or f.endswith(".json") and f != MANIFEST_FILE
        ]
        entry["artifacts"] = sorted(exports)
        entries.append(entry)
    return entries


# ---- prompt libraries (reference routes/prompt_libraries.py) ---------------------------


class PromptLibraryStore:
    """Named validation prompt libraries — ``{shortname: prompt}`` JSON files
    usable as ``user_prompt_library`` in a training config."""

    def __init__(self, state_dir: str):
        self.root = os.path.join(state_dir, "prompt_libraries")
        os.makedirs(self.root, exist_ok=True)

    def _path(self, name: str) -> str:
        if not _SAFE_NAME.match(name):
            raise ValueError(f"invalid library name {name!r}")
        return os.path.join(self.root, f"{name}.json")

    def list(self) -> List[Dict[str, Any]]:
        out = []
        for fname in sorted(os.listdir(self.root)):
            if not fname.endswith(".json"):
                continue
            path = os.path.join(self.root, fname)
            try:
                with open(path) as handle:
                    prompts = json.load(handle)
                count = len(prompts) if isinstance(prompts, dict) else 0
            except (OSError, json.JSONDecodeError):
                count = 0
            out.append({"name": fname[:-5], "prompts": count, "path": path})
        return out

    def get(self, name: str) -> Optional[Dict[str, Any]]:
        path = self._path(name)
        if not os.path.exists(path):
            return None
        with open(path) as handle:
            return {"name": name, "path": path, "library": json.load(handle)}

    def save(self, name: str, library: Dict[str, str]) -> Dict[str, Any]:
        if not isinstance(library, dict) or not library:
            raise ValueError("library must be a non-empty {shortname: prompt} object")
        for key, value in library.items():
            if not isinstance(key, str) or not isinstance(value, str):
                raise ValueError("library entries must map str shortname -> str prompt")
        path = self._path(name)
        tmp = path + ".tmp"
        with open(tmp, "w") as handle:
            json.dump(library, handle, indent=2)
        os.replace(tmp, path)
        return {"name": name, "path": path, "prompts": len(library)}

    def delete(self, name: str) -> bool:
        path = self._path(name)
        if not os.path.exists(path):
            return False
        os.unlink(path)
        return True


# ---- dataset viewer (reference routes/dataset_viewer.py) -------------------------------

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp", ".gif")
_MEDIA_EXTS = _IMAGE_EXTS + (".mp4", ".webm", ".mov", ".wav", ".flac", ".mp3", ".ogg")


def dataset_samples(
    directory: str,
    offset: int = 0,
    limit: int = 50,
    thumbnails: bool = False,
    thumb_size: int = 96,
) -> Dict[str, Any]:
    """Paginated sample listing with sidecar captions and optional inline
    base64 thumbnails (bounded: thumbnails only for the returned page)."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no such dataset directory: {directory}")
    names = sorted(
        f for f in os.listdir(directory)
        if f.lower().endswith(_MEDIA_EXTS)
    )
    page = names[offset : offset + max(0, min(limit, 200))]
    samples: List[Dict[str, Any]] = []
    for fname in page:
        full = os.path.join(directory, fname)
        stem = os.path.splitext(fname)[0]
        entry: Dict[str, Any] = {"name": fname, "size_bytes": os.path.getsize(full)}
        caption_path = os.path.join(directory, stem + ".txt")
        if os.path.exists(caption_path):
            try:
                with open(caption_path, errors="replace") as handle:
                    entry["caption"] = handle.read().strip()
            except OSError:
                pass
        if thumbnails and fname.lower().endswith(_IMAGE_EXTS):
            try:
                from PIL import Image

                with Image.open(full) as img:
                    img.thumbnail((thumb_size, thumb_size))
                    buf = io.BytesIO()
                    img.convert("RGB").save(buf, format="JPEG", quality=70)
                entry["thumbnail"] = "data:image/jpeg;base64," + base64.b64encode(
                    buf.getvalue()
                ).decode()
            except Exception:
                pass
        samples.append(entry)
    return {"directory": directory, "total": len(names), "offset": offset, "samples": samples}


# ---- webhook test fire (reference routes/webhooks.py + cli webhooks test) --------------


def webhook_test(url: str, message: str = "simpletuner-tpu webhook test") -> Dict[str, Any]:
    from ..webhooks.events import notification_event
    from ..webhooks.handler import WebhookConfig, WebhookHandler

    handler = WebhookHandler(WebhookConfig({"webhook_url": url, "webhook_type": "raw"}))
    event = notification_event(message)
    handler.send_raw(event)
    handler.flush()
    handler.close()
    return {"sent": True, "url": url, "event_type": event.get("event_type")}
