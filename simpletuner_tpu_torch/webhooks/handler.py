"""Webhook delivery: rate-limited message posts + structured raw events.

Reference: helpers/webhooks/handler.py:586 ``send`` / :667 ``send_raw`` — a
config-driven handler posting either Discord-style messages (content +
attachments) or raw JSON events to a callback URL, with per-message-type rate
limiting and log-level gating.  Network IO is kept off the training hot path by
a background worker thread draining a queue.

The torch port's own copy of ``simpletuner_tpu/webhooks/handler.py``.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

_LEVELS = {"critical": 0, "error": 1, "warning": 2, "info": 3, "debug": 4}


class WebhookConfig:
    def __init__(self, raw: Dict[str, Any]):
        self.webhook_type = raw.get("webhook_type", "raw")  # discord | raw
        self.webhook_url = raw.get("webhook_url") or raw.get("callback_url")
        self.log_level = raw.get("log_level", "info")
        self.message_prefix = raw.get("message_prefix")
        self.rate_limit_seconds = float(raw.get("rate_limit_seconds", 0.0) or 0.0)

    @classmethod
    def load(cls, path_or_dict) -> "WebhookConfig":
        if isinstance(path_or_dict, dict):
            return cls(path_or_dict)
        with open(path_or_dict) as handle:
            return cls(json.load(handle))


class WebhookHandler:
    """Queue + worker thread; ``send`` for human messages, ``send_raw`` for events."""

    def __init__(self, config: Optional[WebhookConfig] = None, job_id: Optional[str] = None):
        self.config = config
        self.job_id = job_id
        self._queue: "queue.Queue" = queue.Queue(maxsize=1024)
        self._last_sent: Dict[str, float] = {}
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._sent_log: List[Dict[str, Any]] = []  # retained tail for tests/UI
        if config and config.webhook_url:
            self._worker = threading.Thread(target=self._drain, daemon=True, name="webhook-worker")
            self._worker.start()

    @property
    def enabled(self) -> bool:
        return self.config is not None and bool(self.config.webhook_url)

    def _should_log(self, level: str) -> bool:
        if not self.config:
            return False
        return _LEVELS.get(level, 3) <= _LEVELS.get(self.config.log_level, 3)

    def _rate_limited(self, message_type: str) -> bool:
        limit = self.config.rate_limit_seconds if self.config else 0.0
        if limit <= 0:
            return False
        last = self._last_sent.get(message_type, 0.0)
        if time.monotonic() - last < limit:
            return True
        self._last_sent[message_type] = time.monotonic()
        return False

    # ---- public API ---------------------------------------------------------------------
    def send(
        self,
        message: str,
        message_level: str = "info",
        message_type: str = "message",
        images: Optional[List[Any]] = None,
    ) -> None:
        if not self.enabled or not self._should_log(message_level):
            return
        if self._rate_limited(message_type):
            return
        if self.config.webhook_type == "discord":
            payload = {"content": f"{self.config.message_prefix or ''}{message}"}
        else:
            payload = {"message": message, "message_type": message_type, "job_id": self.job_id}
        self._enqueue(payload, images)

    def send_raw(self, event: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        if self.job_id and not event.get("job_id"):
            event = {**event, "job_id": self.job_id}
        if self._rate_limited(event.get("event_type", "raw")):
            return
        self._enqueue(event, None)

    def flush(self, timeout: float = 5.0) -> None:
        deadline = time.monotonic() + timeout
        while not self._queue.empty() and time.monotonic() < deadline:
            time.sleep(0.05)

    def close(self) -> None:
        self._stop.set()
        if self._worker:
            self._worker.join(timeout=2.0)

    # ---- delivery ------------------------------------------------------------------------
    def _enqueue(self, payload: Dict[str, Any], images) -> None:
        try:
            self._queue.put_nowait((payload, images))
        except queue.Full:
            logger.warning("webhook queue full; dropping event")

    def _drain(self) -> None:
        import requests

        while not self._stop.is_set():
            try:
                payload, images = self._queue.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                if images:
                    files = {
                        f"file{i}": (f"image{i}.png", img) for i, img in enumerate(images)
                    }
                    requests.post(
                        self.config.webhook_url,
                        data={"payload_json": json.dumps(payload)},
                        files=files,
                        timeout=10,
                    )
                else:
                    requests.post(self.config.webhook_url, json=payload, timeout=10)
                self._sent_log.append(payload)
                del self._sent_log[:-100]
            except Exception as exc:  # network failures must never kill training
                logger.debug("webhook delivery failed: %s", exc)
