"""Disk-backed platform stores: versioned configs + persistent job records.

The torch port's copy of ``simpletuner_tpu/server/store.py``: the same behavior.

Reference behavior: simpletuner_sdk/server/services config store/versioning and
the cloud job queue persistence (SURVEY.md §2.7) — here compact JSON stores
under a state directory (``SIMPLETUNER_STATE_DIR`` or ``~/.simpletuner_tpu_torch``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


def default_state_dir() -> str:
    return os.environ.get(
        "SIMPLETUNER_STATE_DIR", os.path.join(os.path.expanduser("~"), ".simpletuner_tpu_torch")
    )


class ConfigStore:
    """Named training configs with full version history.

    Layout: <dir>/configs/<name>.json = {"name", "versions": [{"version", "time",
    "config"}, ...]} — version 1 is the oldest; GET returns the newest.
    """

    def __init__(self, root: Optional[str] = None):
        self.root = os.path.join(root or default_state_dir(), "configs")
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, name: str) -> str:
        safe = "".join(c for c in name if c.isalnum() or c in "-_.")
        if not safe:
            raise ValueError(f"invalid config name {name!r}")
        return os.path.join(self.root, f"{safe}.json")

    def save(self, name: str, config: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            path = self._path(name)
            doc = {"name": name, "versions": []}
            if os.path.exists(path):
                with open(path) as fh:
                    doc = json.load(fh)
            entry = {
                "version": len(doc["versions"]) + 1,
                "time": time.time(),
                "config": config,
            }
            doc["versions"].append(entry)
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(doc, fh, indent=1)
            os.replace(tmp, path)
            return {"name": name, "version": entry["version"]}

    def get(self, name: str, version: Optional[int] = None) -> Optional[Dict[str, Any]]:
        path = self._path(name)
        if not os.path.exists(path):
            return None
        with open(path) as fh:
            doc = json.load(fh)
        versions = doc.get("versions", [])
        if not versions:
            return None
        if version is None:
            return versions[-1]
        for entry in versions:
            if entry["version"] == version:
                return entry
        return None

    def versions(self, name: str) -> List[Dict[str, Any]]:
        path = self._path(name)
        if not os.path.exists(path):
            return []
        with open(path) as fh:
            doc = json.load(fh)
        return [
            {"version": e["version"], "time": e["time"]} for e in doc.get("versions", [])
        ]

    def list(self) -> List[str]:
        return sorted(
            os.path.splitext(f)[0] for f in os.listdir(self.root) if f.endswith(".json")
        )

    def delete(self, name: str) -> bool:
        path = self._path(name)
        if os.path.exists(path):
            os.remove(path)
            return True
        return False


class JobStore:
    """Persistent job records (survive server restarts).

    Running jobs found at load time belonged to a dead server process and are
    marked ``interrupted`` — the reference recovers via checkpoint resume, not
    in-flight process adoption.
    """

    def __init__(self, root: Optional[str] = None):
        self.path = os.path.join(root or default_state_dir(), "jobs.json")
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._lock = threading.Lock()
        self.records: Dict[str, Dict[str, Any]] = {}
        self._load()

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        try:
            with open(self.path) as fh:
                self.records = json.load(fh)
        except (json.JSONDecodeError, OSError):
            self.records = {}
        for rec in self.records.values():
            if rec.get("state") in ("running", "pending"):
                rec["state"] = "interrupted"

    def _flush(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.records, fh, indent=1)
        os.replace(tmp, self.path)

    def upsert(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self.records[record["job_id"]] = dict(record)
            self._flush()

    def history(self) -> List[Dict[str, Any]]:
        return sorted(self.records.values(), key=lambda r: r.get("created_at", 0))
