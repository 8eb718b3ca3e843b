"""Remote training worker: registers with an orchestration server, receives
jobs over the SSE event stream, runs them locally, posts status back.

Reference behavior: simpletuner/worker_agent.py:34 ``WorkerConfig`` — a GPU
worker that connects to the panel via SSE and launches training jobs.  Here
the same loop over stdlib HTTP against ``server/app.py``'s surface:

  * GET  /api/events                (SSE; ``job_offer`` events carry configs)
  * POST /api/events/callback       (worker lifecycle + job status reports)

Run: ``python -m simpletuner_tpu_torch.worker_agent --server http://host:8005
[--device cuda|cpu]``.

The torch port's copy of ``simpletuner_tpu/worker_agent.py``: the same loop;
its jobs run ``simpletuner_tpu_torch.train`` on ``--device`` (default
``cuda``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import platform
import socket
import threading
import time
import urllib.request
from typing import Any, Dict, Optional

from .server.process_keeper import ProcessKeeper

logger = logging.getLogger("simpletuner_tpu_torch.worker_agent")


@dataclasses.dataclass
class WorkerConfig:
    server: str = "http://127.0.0.1:8005"
    worker_id: str = ""
    max_concurrent: int = 1
    heartbeat_seconds: float = 30.0
    reconnect_seconds: float = 5.0
    device: str = "cuda"

    def __post_init__(self):
        if not self.worker_id:
            self.worker_id = f"{socket.gethostname()}-{platform.machine()}"


class WorkerAgent:
    def __init__(self, config: WorkerConfig):
        self.config = config
        self.keeper = ProcessKeeper(max_concurrent=config.max_concurrent, device=config.device)
        self.keeper.add_listener(self._report)
        self._stop = threading.Event()

    # ---- outbound -------------------------------------------------------------------------
    def _post(self, payload: Dict[str, Any]) -> None:
        payload = {"worker_id": self.config.worker_id, **payload}
        data = json.dumps(payload).encode()
        req = urllib.request.Request(
            f"{self.config.server}/api/events/callback",
            data=data,
            headers={"Content-Type": "application/json"},
        )
        try:
            urllib.request.urlopen(req, timeout=10).read()
        except OSError as exc:
            logger.warning("status post failed: %s", exc)

    def _report(self, event: Dict[str, Any]) -> None:
        self._post({"event_type": f"worker_{event.get('event_type', 'event')}", **event})

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            self._post(
                {
                    "event_type": "worker_heartbeat",
                    "running": self.keeper.running_count(),
                    "time": time.time(),
                }
            )
            self._stop.wait(self.config.heartbeat_seconds)

    # ---- inbound (SSE) --------------------------------------------------------------------
    def _handle_event(self, event: Dict[str, Any]) -> None:
        kind = event.get("event_type")
        if kind == "job_offer":
            target = event.get("worker_id")
            if target and target != self.config.worker_id:
                return
            config = event.get("config") or {}
            if not config.get("model_family"):
                logger.warning("job_offer without config.model_family ignored")
                return
            job = self.keeper.submit_job(config, event.get("job_id"))
            logger.info("accepted job %s", job.job_id)
            self._post({"event_type": "worker_job_accepted", "job_id": job.job_id})
        elif kind == "job_cancel":
            if self.keeper.cancel_job(event.get("job_id", "")):
                self._post({"event_type": "worker_job_cancelled", "job_id": event.get("job_id")})

    def _sse_loop(self) -> None:
        url = f"{self.config.server}/api/events"
        while not self._stop.is_set():
            try:
                with urllib.request.urlopen(url, timeout=300) as stream:
                    logger.info("connected to %s", url)
                    self._post({"event_type": "worker_register", "time": time.time()})
                    for raw in stream:
                        if self._stop.is_set():
                            return
                        line = raw.decode("utf-8", "replace").strip()
                        if not line.startswith("data:"):
                            continue
                        try:
                            event = json.loads(line[5:].strip())
                        except json.JSONDecodeError:
                            continue
                        self._handle_event(event)
            except OSError as exc:
                logger.warning("SSE disconnected (%s); retrying", exc)
                self._stop.wait(self.config.reconnect_seconds)

    def run(self) -> None:
        hb = threading.Thread(target=self._heartbeat_loop, daemon=True)
        hb.start()
        try:
            self._sse_loop()
        finally:
            self._stop.set()

    def stop(self) -> None:
        self._stop.set()


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description="simpletuner-tpu-torch training worker")
    parser.add_argument("--server", default="http://127.0.0.1:8005")
    parser.add_argument("--worker-id", default="")
    parser.add_argument("--max-concurrent", type=int, default=1)
    parser.add_argument("--device", default="cuda", help="torch device of the jobs; 'cpu' for tests")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    WorkerAgent(
        WorkerConfig(server=args.server, worker_id=args.worker_id, max_concurrent=args.max_concurrent,
                     device=args.device)
    ).run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
