"""Append-only audit log with hash-chain verification.

The torch port's copy of ``simpletuner_tpu/server/audit.py``: the same behavior.

Reference: the server platform's audit subsystem
(documentation/experimental/server/AUDIT.md — audit logs with chain
verification).  Each record carries the SHA-256 of the previous record, so
any tampering or truncation in the middle of the log breaks verification.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

_GENESIS = "0" * 64


def _record_hash(record: Dict[str, Any]) -> str:
    canonical = json.dumps(record, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canonical.encode()).hexdigest()


class AuditLog:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._records: List[Dict[str, Any]] = []
        if path and os.path.exists(path):
            with open(path) as handle:
                self._records = [json.loads(line) for line in handle if line.strip()]

    @property
    def _prev_hash(self) -> str:
        return _record_hash(self._records[-1]) if self._records else _GENESIS

    def append(self, action: str, actor: str = "local", detail: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        with self._lock:
            record = {
                "seq": len(self._records),
                "time": time.time(),
                "actor": actor,
                "action": action,
                "detail": detail or {},
                "prev_hash": self._prev_hash,
            }
            self._records.append(record)
            if self.path:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                with open(self.path, "a") as handle:
                    handle.write(json.dumps(record, sort_keys=True) + "\n")
            return record

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def verify(self) -> Tuple[bool, Optional[int]]:
        """(ok, first_bad_seq): replay the chain and check every link."""
        with self._lock:
            prev = _GENESIS
            for i, record in enumerate(self._records):
                if record.get("prev_hash") != prev or record.get("seq") != i:
                    return False, i
                prev = _record_hash(record)
            return True, None
