"""Priority + fair-share job queue feeding the process keeper.

The torch port's copy of ``simpletuner_tpu/server/jobqueue.py``: the same behavior.

Reference behavior: simpletuner_sdk/server/services cloud job queue
(SURVEY.md §2.7 "cloud job queue (priorities, fair share)"): submissions
carry a priority; among equal priorities the scheduler favors the submitter
with the least recently-consumed compute (decayed fair share), then FIFO.

a scheduler thread owns dispatch — the keeper no longer
self-starts queued jobs.  Fair share is an exponentially-decayed per-user
runtime-seconds tally (half-life 1 h) updated when jobs finish; pending
entries persist to the state dir so a server restart re-queues them.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

FAIR_SHARE_HALF_LIFE_S = 3600.0
PRIORITY_MIN, PRIORITY_MAX, PRIORITY_DEFAULT = 0, 9, 4


class QueueEntry:
    def __init__(self, job_id: str, config: Dict[str, Any], owner: str,
                 priority: int = PRIORITY_DEFAULT, submitted_at: Optional[float] = None):
        self.job_id = job_id
        self.config = config
        self.owner = owner
        self.priority = max(PRIORITY_MIN, min(PRIORITY_MAX, int(priority)))
        self.submitted_at = submitted_at if submitted_at is not None else time.time()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "job_id": self.job_id,
            "config": self.config,
            "owner": self.owner,
            "priority": self.priority,
            "submitted_at": self.submitted_at,
        }


class FairShareQueue:
    """Scheduler: dispatches the highest-priority entry whose owner has the
    lowest decayed usage; ties broken FIFO.  ``dispatch`` is the keeper-start
    callable; ``slots_free`` reports available concurrency."""

    def __init__(
        self,
        dispatch: Callable[[QueueEntry], None],
        slots_free: Callable[[], int],
        state_dir: Optional[str] = None,
        poll_interval: float = 0.25,
    ):
        self._dispatch = dispatch
        self._slots_free = slots_free
        self._poll = poll_interval
        self._entries: List[QueueEntry] = []
        self._usage: Dict[str, Dict[str, float]] = {}  # user -> {value, at}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._path = None
        if state_dir is not None:
            os.makedirs(state_dir, exist_ok=True)
            self._path = os.path.join(state_dir, "job_queue.json")
            self._load()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ---- persistence ----------------------------------------------------------------
    def _load(self) -> None:
        if self._path and os.path.exists(self._path):
            with open(self._path) as fh:
                data = json.load(fh)
            self._entries = [QueueEntry(**e) for e in data.get("entries", [])]
            self._usage = data.get("usage", {})

    def _flush_locked(self) -> None:
        if not self._path:
            return
        tmp = self._path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(
                {"entries": [e.to_dict() for e in self._entries], "usage": self._usage},
                fh,
            )
        os.replace(tmp, self._path)

    # ---- fair share -----------------------------------------------------------------
    def _decayed_usage(self, user: str, now: float) -> float:
        rec = self._usage.get(user)
        if not rec:
            return 0.0
        age = max(0.0, now - rec["at"])
        return rec["value"] * math.pow(0.5, age / FAIR_SHARE_HALF_LIFE_S)

    def record_usage(self, user: str, runtime_seconds: float) -> None:
        """Called when a job finishes: accrue decayed compute consumption."""
        now = time.time()
        with self._lock:
            current = self._decayed_usage(user, now)
            self._usage[user] = {"value": current + float(runtime_seconds), "at": now}
            self._flush_locked()

    def usage_snapshot(self) -> Dict[str, float]:
        now = time.time()
        with self._lock:
            return {u: self._decayed_usage(u, now) for u in self._usage}

    # ---- queue ops ------------------------------------------------------------------
    def enqueue(self, entry: QueueEntry) -> None:
        with self._lock:
            self._entries.append(entry)
            self._flush_locked()
        self._wake.set()

    def remove(self, job_id: str) -> bool:
        with self._lock:
            before = len(self._entries)
            self._entries = [e for e in self._entries if e.job_id != job_id]
            changed = len(self._entries) != before
            if changed:
                self._flush_locked()
            return changed

    def pending(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [e.to_dict() for e in self._ordered_locked(time.time())]

    def _ordered_locked(self, now: float) -> List[QueueEntry]:
        return sorted(
            self._entries,
            key=lambda e: (
                -e.priority,
                self._decayed_usage(e.owner, now),
                e.submitted_at,
            ),
        )

    def _pop_next_locked(self) -> Optional[QueueEntry]:
        if not self._entries:
            return None
        entry = self._ordered_locked(time.time())[0]
        self._entries.remove(entry)
        self._flush_locked()
        return entry

    # ---- scheduler loop -------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self._poll)
            self._wake.clear()
            while True:
                if self._slots_free() <= 0:
                    break
                with self._lock:
                    entry = self._pop_next_locked()
                if entry is None:
                    break
                try:
                    self._dispatch(entry)
                except Exception:  # dispatch failure must not kill the scheduler
                    import logging

                    logging.getLogger(__name__).exception(
                        "dispatch failed for job %s", entry.job_id
                    )

    def kick(self) -> None:
        self._wake.set()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=2.0)
