"""Job approval workflow: submissions gated until an admin approves.

The torch port's copy of ``simpletuner_tpu/server/approvals.py``: the same behavior.

Reference behavior: simpletuner_sdk/server/routes/approvals + the cloud
queue's approval states (SURVEY.md §2.7; reference CLI ``jobs approval``
subcommands).  A submission from a user whose org sets ``require_approval``
(or a user flagged ``needs_approval``) lands here instead of the run queue;
an admin (or org owner/admin) approves → the job is enqueued with its
original priority — or rejects with a reason.  Requests persist to the state
dir and survive restarts.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

APPROVAL_STATES = ("pending", "approved", "rejected")


class ApprovalStore:
    def __init__(self, root: str):
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, "approvals.json")
        self._lock = threading.Lock()
        self._requests: Dict[str, Dict[str, Any]] = {}
        if os.path.exists(self.path):
            with open(self.path) as fh:
                self._requests = json.load(fh)

    def _flush_locked(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._requests, fh, indent=2)
        os.replace(tmp, self.path)

    def submit(self, config: Dict[str, Any], owner: str, priority: int,
               org: Optional[str] = None) -> Dict[str, Any]:
        approval_id = uuid.uuid4().hex[:12]
        record = {
            "approval_id": approval_id,
            "state": "pending",
            "owner": owner,
            "org": org,
            "priority": priority,
            "config": config,
            "submitted_at": time.time(),
            "decided_at": None,
            "decided_by": None,
            "reason": None,
        }
        with self._lock:
            self._requests[approval_id] = record
            self._flush_locked()
        return dict(record)

    def decide(self, approval_id: str, approve: bool, decided_by: str,
               reason: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            record = self._requests.get(approval_id)
            if record is None:
                raise KeyError(f"unknown approval {approval_id!r}")
            if record["state"] != "pending":
                raise ValueError(f"approval {approval_id} already {record['state']}")
            record["state"] = "approved" if approve else "rejected"
            record["decided_at"] = time.time()
            record["decided_by"] = decided_by
            record["reason"] = reason
            self._flush_locked()
            return dict(record)

    def get(self, approval_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            record = self._requests.get(approval_id)
            return dict(record) if record else None

    def list(self, state: Optional[str] = None, owner: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = []
            for record in self._requests.values():
                if state and record["state"] != state:
                    continue
                if owner and record["owner"] != owner:
                    continue
                out.append(dict(record))
            return sorted(out, key=lambda r: r["submitted_at"])
