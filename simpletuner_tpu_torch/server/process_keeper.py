"""Trainer subprocess lifecycle management.

The torch port's copy of ``simpletuner_tpu/server/process_keeper.py``: one
compact supervisor; each job is a ``python -m simpletuner_tpu_torch.train
--config <job config> --device <device>`` subprocess (``device`` is the
keeper's, ``cuda`` unless the caller asks for the CPU) with captured logs,
status tracking, cancellation, and a signal file for manual
validation/checkpoint triggers (``SIMPLETUNER_SIGNAL_FILE``, read by the
trainer's ``_consume_signals``).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

JOB_STATES = ("pending", "running", "completed", "failed", "cancelled")
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class TrainingJob:
    def __init__(self, job_id: str, config: Dict[str, Any], workdir: str,
                 owner: Optional[str] = None, priority: int = 4,
                 kind: str = "train", argv: Optional[List[str]] = None):
        self.job_id = job_id
        self.config = config
        self.workdir = workdir
        self.owner = owner
        self.priority = priority
        self.kind = kind
        # non-training jobs (checkpoint inference) override the subprocess
        # command line; ``{config_path}`` is substituted at start
        self.argv = argv
        self.state = "pending"
        self.created_at = time.time()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.return_code: Optional[int] = None
        self.cost_usd: Optional[float] = None
        self.logs: deque = deque(maxlen=2000)
        self.process: Optional[subprocess.Popen] = None
        self.config_path = os.path.join(workdir, "config.json")
        self.signal_file = os.path.join(workdir, "signals")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "job_id": self.job_id,
            "state": self.state,
            "kind": self.kind,
            "owner": self.owner,
            "priority": self.priority,
            "created_at": self.created_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
            "return_code": self.return_code,
            "cost_usd": self.cost_usd,
            "output_dir": self.config.get("output_dir"),
        }


class ProcessKeeper:
    """One training job at a time (one card); queued jobs wait."""

    def __init__(self, max_concurrent: int = 1, state_dir: Optional[str] = None, device: str = "cuda"):
        self.jobs: Dict[str, TrainingJob] = {}
        self.max_concurrent = max_concurrent
        self.device = str(device)
        self._lock = threading.Lock()
        self._listeners: List[Any] = []  # callables(event_dict)
        self.store = None
        if state_dir is not None:
            from .store import JobStore

            self.store = JobStore(state_dir)

    # ---- events ---------------------------------------------------------------------------
    def add_listener(self, fn) -> None:
        self._listeners.append(fn)

    def _emit(self, event: Dict[str, Any]) -> None:
        job = self.jobs.get(event.get("job_id", ""))
        if self.store is not None and job is not None:
            try:
                self.store.upsert(job.to_dict())
            except OSError:
                pass
        for fn in list(self._listeners):
            try:
                fn(event)
            except Exception:
                pass

    # ---- submission -----------------------------------------------------------------------
    def running_count(self) -> int:
        return sum(1 for j in self.jobs.values() if j.state == "running")

    def slots_free(self) -> int:
        return max(0, self.max_concurrent - self.running_count())

    def submit_job(self, config: Dict[str, Any], job_id: Optional[str] = None,
                   owner: Optional[str] = None, priority: int = 4,
                   autostart: bool = True, kind: str = "train",
                   argv: Optional[List[str]] = None) -> TrainingJob:
        """With ``autostart`` the keeper self-schedules (standalone use);
        the server submits with ``autostart=False`` and dispatches through
        the fair-share queue (jobqueue.FairShareQueue → start_job)."""
        job_id = job_id or uuid.uuid4().hex[:12]
        workdir = tempfile.mkdtemp(prefix=f"st_job_{job_id}_")
        job = TrainingJob(job_id, dict(config), workdir, owner=owner, priority=priority,
                          kind=kind, argv=argv)
        with self._lock:
            self.jobs[job_id] = job
        if not autostart:
            self._emit({"event_type": "job_queued", "job_id": job_id})
            return job
        if self.running_count() >= self.max_concurrent:
            self._emit({"event_type": "job_queued", "job_id": job_id})
            threading.Thread(target=self._wait_and_start, args=(job,), daemon=True).start()
        else:
            self._start(job)
        return job

    def start_job(self, job_id: str) -> bool:
        """Dispatch a pending job (queue scheduler entry point)."""
        job = self.jobs.get(job_id)
        if job is None or job.state != "pending":
            return False
        self._start(job)
        return True

    def _wait_and_start(self, job: TrainingJob) -> None:
        while self.running_count() >= self.max_concurrent:
            if job.state == "cancelled":
                return
            time.sleep(1.0)
        if job.state == "pending":
            self._start(job)

    def _start(self, job: TrainingJob) -> None:
        with open(job.config_path, "w") as handle:
            json.dump(job.config, handle)
        env = dict(os.environ)
        env["SIMPLETUNER_SIGNAL_FILE"] = job.signal_file
        env["SIMPLETUNER_JOB_ID"] = job.job_id
        # the child imports this package from wherever the server's copy lives
        env["PYTHONPATH"] = os.pathsep.join(p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        cmd = [sys.executable, "-m", "simpletuner_tpu_torch.train", "--config", job.config_path,
               "--device", self.device]
        if job.argv is not None:
            cmd = [arg.replace("{config_path}", job.config_path) for arg in job.argv]
        job.process = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        job.state = "running"
        job.started_at = time.time()
        self._emit({"event_type": "job_started", "job_id": job.job_id})
        threading.Thread(target=self._supervise, args=(job,), daemon=True).start()

    def _supervise(self, job: TrainingJob) -> None:
        assert job.process is not None
        for line in job.process.stdout:  # type: ignore[union-attr]
            job.logs.append(line.rstrip("\n"))
        job.process.wait()
        job.return_code = job.process.returncode
        job.finished_at = time.time()
        if job.state != "cancelled":
            job.state = "completed" if job.return_code == 0 else "failed"
        self._emit(
            {
                "event_type": "job_finished",
                "job_id": job.job_id,
                "state": job.state,
                "return_code": job.return_code,
            }
        )

    # ---- control ------------------------------------------------------------------------
    def cancel_job(self, job_id: str) -> bool:
        job = self.jobs.get(job_id)
        if job is None:
            return False
        job.state = "cancelled"
        if job.process and job.process.poll() is None:
            job.process.send_signal(signal.SIGTERM)
            threading.Timer(10.0, lambda: job.process.kill() if job.process.poll() is None else None).start()
        self._emit({"event_type": "job_cancelled", "job_id": job_id})
        return True

    def send_signal(self, job_id: str, action: str) -> bool:
        """Manual validation/checkpoint trigger via the signal file
        (reference train.py:88-143 signal-file consumers)."""
        job = self.jobs.get(job_id)
        if job is None or job.state != "running":
            return False
        with open(job.signal_file, "a") as handle:
            handle.write(action + "\n")
        return True

    def get_job(self, job_id: str) -> Optional[TrainingJob]:
        return self.jobs.get(job_id)

    def list_jobs(self) -> List[Dict[str, Any]]:
        live = {j.job_id: j.to_dict() for j in self.jobs.values()}
        if self.store is not None:
            # persisted history from prior server lifetimes (VERDICT r1 Next #8)
            merged = {r["job_id"]: r for r in self.store.history()}
            merged.update(live)
            return sorted(merged.values(), key=lambda r: r.get("created_at", 0))
        return sorted(live.values(), key=lambda r: r.get("created_at", 0))
