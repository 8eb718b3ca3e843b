"""Dataset management service: browse/detect/upload/scan/captions/viewer/plan.

The torch port's copy of ``simpletuner_tpu/server/datasets.py``: the same behavior.

Reference surface: simpletuner_sdk/server/routes/datasets.py (browse :408,
detect :488, folders :601, upload :640, upload/zip :673, captions :713-819,
plan :198-341) and routes/dataset_viewer.py (viewer/summary :84, viewer/files
:108, scan :515-597, cache :598-656), backed by services/dataset_service.py,
dataset_upload_service.py, dataset_scan_service.py, dataset_viewer_service.py.

the scan pass runs the SAME MetadataBackend the trainer
uses (aspect buckets are identical to what training will see), and everything
is stdlib — no FastAPI/pydantic.  Uploads are sandboxed under a datasets root;
zip extraction refuses path traversal.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".webp", ".bmp", ".tif", ".tiff"}
VIDEO_EXTS = {".mp4", ".webm", ".mov", ".avi", ".mkv", ".gif"}
AUDIO_EXTS = {".wav", ".mp3", ".flac", ".ogg", ".m4a"}
CAPTION_EXTS = {".txt", ".caption"}


def _classify(name: str) -> Optional[str]:
    ext = os.path.splitext(name)[1].lower()
    if ext in IMAGE_EXTS:
        return "image"
    if ext in VIDEO_EXTS:
        return "video"
    if ext in AUDIO_EXTS:
        return "audio"
    if ext in CAPTION_EXTS:
        return "caption"
    if ext in (".parquet", ".jsonl", ".csv"):
        return "metadata"
    return None


class DatasetPlanStore:
    """Persisted multidatabackend plan (reference DatasetPlanStore,
    routes/datasets.py:113-152): one canonical dataset list the config editor
    and trainer share, validated through the same loader the trainer uses."""

    def __init__(self, state_dir: str):
        self.path = os.path.join(state_dir, "dataset_plan.json")

    def get(self) -> List[Dict[str, Any]]:
        if not os.path.isfile(self.path):
            return []
        with open(self.path) as fh:
            data = json.load(fh)
        return data.get("datasets", []) if isinstance(data, dict) else data

    def save(self, datasets: List[Dict[str, Any]]) -> Dict[str, Any]:
        from ..configuration.dataloader import load_dataloader_config

        parsed = load_dataloader_config(datasets)  # raises on invalid
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"datasets": datasets, "saved_at": time.time()}, fh, indent=2)
        os.replace(tmp, self.path)
        return {"saved": True, "count": len(parsed)}

    def patch(self, dataset: Dict[str, Any]) -> Dict[str, Any]:
        """Upsert one dataset entry by id."""
        datasets = self.get()
        did = str(dataset.get("id") or "")
        if not did:
            raise ValueError("dataset id required")
        out = [d for d in datasets if str(d.get("id")) != did]
        out.append(dataset)
        return self.save(out)

    def delete(self, dataset_id: str) -> Dict[str, Any]:
        datasets = [d for d in self.get() if str(d.get("id")) != dataset_id]
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"datasets": datasets, "saved_at": time.time()}, fh, indent=2)
        os.replace(tmp, self.path)
        return {"deleted": True, "count": len(datasets)}


class ScanRunner:
    """Background aspect-bucket scans with status polling (reference
    dataset_scan_service.py + routes/dataset_viewer.py:515-597)."""

    def __init__(self):
        self._scans: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()

    def start(self, directory: str, resolution: float, resolution_type: str) -> Dict[str, Any]:
        scan_id = f"scan-{int(time.time()*1000):x}"
        record = {
            "scan_id": scan_id, "dir": directory, "state": "running",
            "started_at": time.time(), "buckets": None, "error": None,
            "total_files": None,
        }
        with self._lock:
            self._scans[scan_id] = record

        def _run():
            try:
                from ..data.backends.local import LocalDataBackend
                from ..data.buckets import BucketConfig
                from ..data.metadata import MetadataBackend

                backend = LocalDataBackend(scan_id, instance_data_dir=directory)
                cfg = BucketConfig(resolution=resolution, resolution_type=resolution_type)
                meta = MetadataBackend(
                    scan_id, backend, cfg, instance_data_dir=directory,
                    cache_file=os.path.join(directory, ".st_buckets.json"),
                    metadata_file=os.path.join(directory, ".st_metadata.json"),
                )
                meta.discover()
                meta.save_cache()  # persist .st_buckets.json for the viewer summary
                buckets = {k: len(v) for k, v in meta.aspect_ratio_bucket_indices.items()}
                record.update(
                    state="completed", buckets=buckets,
                    total_files=sum(buckets.values()),
                    finished_at=time.time(),
                )
            except Exception as exc:  # surfaced via status, not swallowed
                record.update(state="failed", error=f"{type(exc).__name__}: {exc}",
                              finished_at=time.time())

        threading.Thread(target=_run, daemon=True, name=scan_id).start()
        return dict(record)

    def status(self, scan_id: Optional[str] = None) -> Any:
        with self._lock:
            if scan_id:
                return self._scans.get(scan_id)
            return sorted(self._scans.values(), key=lambda r: -r["started_at"])

    def active(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._scans.values() if r["state"] == "running"]


class DatasetService:
    def __init__(self, state_dir: str):
        self.root = os.environ.get(
            "SIMPLETUNER_DATASETS_DIR", os.path.join(state_dir, "datasets"))
        os.makedirs(self.root, exist_ok=True)
        self.plan = DatasetPlanStore(state_dir)
        self.scans = ScanRunner()

    # ---- path sandbox --------------------------------------------------------------------
    def resolve(self, path: Optional[str], allow_outside: bool = False) -> str:
        """Map a client path into the datasets root; absolute paths outside
        the root are rejected unless explicitly allowed (reference
        _resolve_datasets_dir_and_validate_path, routes/datasets.py:342)."""
        if not path or path in (".", "/"):
            return self.root
        candidate = path if os.path.isabs(path) else os.path.join(self.root, path)
        candidate = os.path.realpath(candidate)
        if not candidate.startswith(os.path.realpath(self.root) + os.sep) and \
                candidate != os.path.realpath(self.root):
            if not allow_outside:
                raise PermissionError(f"path escapes datasets dir: {path}")
        return candidate

    # ---- browse / detect -----------------------------------------------------------------
    def browse(self, path: Optional[str] = None) -> Dict[str, Any]:
        full = self.resolve(path)
        if not os.path.isdir(full):
            raise FileNotFoundError(full)
        dirs, files = [], []
        for name in sorted(os.listdir(full)):
            if name.startswith("."):
                continue
            item = os.path.join(full, name)
            if os.path.isdir(item):
                dirs.append({"name": name, "path": os.path.relpath(item, self.root)})
            else:
                files.append({"name": name, "size": os.path.getsize(item),
                              "kind": _classify(name)})
        return {"root": self.root, "path": os.path.relpath(full, self.root),
                "directories": dirs, "files": files[:500],
                "file_count": len(files)}

    def detect(self, path: str) -> Dict[str, Any]:
        """Probe a directory and propose a dataset config (reference
        routes/datasets.py:488 detect_dataset)."""
        full = self.resolve(path, allow_outside=True)
        if not os.path.isdir(full):
            raise FileNotFoundError(full)
        counts: Dict[str, int] = {}
        caption_stems = set()
        media_stems = set()
        samples: List[str] = []
        parquet = None
        for base, _dirs, names in os.walk(full):
            for name in names:
                kind = _classify(name)
                if kind is None:
                    continue
                counts[kind] = counts.get(kind, 0) + 1
                stem = os.path.splitext(name)[0]
                if kind == "caption":
                    caption_stems.add(stem)
                elif kind in ("image", "video", "audio"):
                    media_stems.add(stem)
                    if len(samples) < 8:
                        samples.append(os.path.relpath(os.path.join(base, name), full))
                elif kind == "metadata" and name.endswith(".parquet"):
                    parquet = os.path.relpath(os.path.join(base, name), full)
        dataset_type = "image"
        if counts.get("video", 0) > counts.get("image", 0):
            dataset_type = "video"
        elif counts.get("audio", 0) > counts.get("image", 0):
            dataset_type = "audio"
        covered = len(media_stems & caption_stems)
        if parquet:
            caption_strategy = "parquet"
        elif media_stems and covered / max(len(media_stems), 1) > 0.5:
            caption_strategy = "textfile"
        else:
            caption_strategy = "filename"
        return {
            "path": full, "counts": counts, "dataset_type": dataset_type,
            "caption_strategy": caption_strategy,
            "caption_coverage": round(covered / max(len(media_stems), 1), 3),
            "sample_files": samples,
            "suggested_config": {
                "id": os.path.basename(full.rstrip(os.sep)) or "dataset",
                "type": "local", "dataset_type": dataset_type,
                "instance_data_dir": full,
                "caption_strategy": caption_strategy,
                "resolution": 1024 if dataset_type == "image" else 480,
                "resolution_type": "pixel_area",
            },
        }

    # ---- folders / upload ----------------------------------------------------------------
    def create_folder(self, name: str) -> Dict[str, Any]:
        if not re.match(r"^[\w][\w ./-]*$", name or ""):
            raise ValueError("invalid folder name")
        full = self.resolve(name)
        os.makedirs(full, exist_ok=True)
        return {"created": True, "path": os.path.relpath(full, self.root)}

    def save_upload(self, directory: str, filename: str, payload: bytes) -> Dict[str, Any]:
        safe = os.path.basename(filename)
        if not safe or _classify(safe) is None:
            raise ValueError(f"unsupported file type: {filename}")
        target_dir = self.resolve(directory)
        os.makedirs(target_dir, exist_ok=True)
        target = os.path.join(target_dir, safe)
        with open(target, "wb") as fh:
            fh.write(payload)
        return {"uploaded": safe, "bytes": len(payload),
                "path": os.path.relpath(target, self.root)}

    def save_zip(self, directory: str, payload: bytes) -> Dict[str, Any]:
        """Extract an uploaded archive, skipping traversal paths and
        non-dataset files (reference upload/zip :673 + upload service)."""
        target_dir = self.resolve(directory)
        os.makedirs(target_dir, exist_ok=True)
        extracted, skipped = [], []
        with zipfile.ZipFile(io.BytesIO(payload)) as zf:
            for info in zf.infolist():
                if info.is_dir():
                    continue
                name = info.filename
                norm = os.path.normpath(name)
                if norm.startswith("..") or os.path.isabs(norm) or _classify(norm) is None:
                    skipped.append(name)
                    continue
                dest = os.path.join(target_dir, norm)
                if not os.path.realpath(dest).startswith(os.path.realpath(target_dir)):
                    skipped.append(name)
                    continue
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                with zf.open(info) as src, open(dest, "wb") as dst:
                    shutil.copyfileobj(src, dst)
                extracted.append(norm)
        return {"extracted": len(extracted), "skipped": skipped[:20],
                "files": extracted[:100]}

    # ---- captions --------------------------------------------------------------------------
    def caption_status(self, path: str) -> Dict[str, Any]:
        full = self.resolve(path, allow_outside=True)
        media, captioned, missing = 0, 0, []
        for base, _dirs, names in os.walk(full):
            for name in names:
                if _classify(name) in ("image", "video", "audio"):
                    media += 1
                    stem = os.path.join(base, os.path.splitext(name)[0])
                    if os.path.isfile(stem + ".txt") or os.path.isfile(stem + ".caption"):
                        captioned += 1
                    elif len(missing) < 50:
                        missing.append(os.path.relpath(os.path.join(base, name), full))
        return {"media": media, "captioned": captioned,
                "coverage": round(captioned / max(media, 1), 3), "missing": missing}

    def write_caption(self, path: str, media_file: str, text: str) -> Dict[str, Any]:
        full = self.resolve(path, allow_outside=True)
        media_path = os.path.normpath(os.path.join(full, media_file))
        if not media_path.startswith(os.path.realpath(full)) and \
                not os.path.realpath(media_path).startswith(os.path.realpath(full)):
            raise PermissionError("media path escapes dataset dir")
        if not os.path.isfile(media_path):
            raise FileNotFoundError(media_file)
        caption_path = os.path.splitext(media_path)[0] + ".txt"
        with open(caption_path, "w") as fh:
            fh.write(text)
        return {"written": os.path.basename(caption_path), "chars": len(text)}

    def read_caption(self, path: str, media_file: str) -> Dict[str, Any]:
        full = self.resolve(path, allow_outside=True)
        stem = os.path.splitext(os.path.join(full, media_file))[0]
        for ext in (".txt", ".caption"):
            if os.path.isfile(stem + ext):
                with open(stem + ext) as fh:
                    return {"caption": fh.read(), "source": os.path.basename(stem + ext)}
        return {"caption": None, "source": None}

    # ---- viewer summary --------------------------------------------------------------------
    def summary(self, path: str) -> Dict[str, Any]:
        full = self.resolve(path, allow_outside=True)
        detect = self.detect(full)
        bucket_file = os.path.join(full, ".st_buckets.json")
        buckets = None
        if os.path.isfile(bucket_file):
            try:
                with open(bucket_file) as fh:
                    raw = json.load(fh)
                idx = raw.get("aspect_ratio_bucket_indices", raw)
                if isinstance(idx, dict):
                    buckets = {k: len(v) if isinstance(v, list) else v
                               for k, v in idx.items()}
            except (ValueError, OSError):
                buckets = None
        total_bytes = 0
        for base, _dirs, names in os.walk(full):
            for name in names:
                try:
                    total_bytes += os.path.getsize(os.path.join(base, name))
                except OSError:
                    pass
        return {**detect, "buckets": buckets, "total_bytes": total_bytes}


def parse_multipart(content_type: str, body: bytes) -> List[Tuple[str, str, bytes]]:
    """Minimal multipart/form-data parser: returns (field, filename, payload)
    triples.  Stdlib-only (the reference leans on starlette's parser)."""
    match = re.search(r'boundary="?([^";]+)"?', content_type or "")
    if not match:
        raise ValueError("no multipart boundary")
    boundary = match.group(1).encode()
    parts: List[Tuple[str, str, bytes]] = []
    for chunk in body.split(b"--" + boundary):
        chunk = chunk.strip(b"\r\n")
        if not chunk or chunk == b"--":
            continue
        if b"\r\n\r\n" not in chunk:
            continue
        header_blob, payload = chunk.split(b"\r\n\r\n", 1)
        headers = header_blob.decode("utf-8", "replace")
        name_m = re.search(r'name="([^"]*)"', headers)
        file_m = re.search(r'filename="([^"]*)"', headers)
        parts.append((
            name_m.group(1) if name_m else "",
            file_m.group(1) if file_m else "",
            payload,
        ))
    return parts
