"""Notification service: in-app inbox + SMTP email channel.

The torch port's copy of ``simpletuner_tpu/server/notifications.py``: the same behavior.

Reference behavior: simpletuner_sdk notification services (SURVEY.md §2.7
"notifications (SMTP/IMAP)"; reference CLI ``notifications`` subcommands):
job lifecycle events generate per-user notifications, delivered to an in-app
inbox always and by email when SMTP is configured.

the inbox is a JSON store under the platform state dir; the SMTP
channel speaks RFC 5321 via stdlib smtplib to a configured relay
(``smtp.json``: host/port/from/starttls/username/password).  Email delivery
failures are recorded on the notification rather than raised — the inbox is
the source of truth, email is best-effort (matching the reference's
fire-and-forget notifier).
"""

from __future__ import annotations

import json
import logging
import os
import smtplib
import threading
import time
import uuid
from email.message import EmailMessage
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class SMTPConfig:
    def __init__(self, data: Dict[str, Any]):
        self.host = str(data.get("host") or "")
        self.port = int(data.get("port") or 25)
        self.sender = str(data.get("from") or "simpletuner@localhost")
        self.starttls = bool(data.get("starttls", False))
        self.username = data.get("username")
        self.password = data.get("password")
        self.timeout = float(data.get("timeout", 10.0))

    @property
    def enabled(self) -> bool:
        return bool(self.host)


class NotificationCenter:
    """notifications.json: {username: [records]}; addresses.json: {username: email}."""

    def __init__(self, root: str):
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, "notifications.json")
        self.smtp_path = os.path.join(root, "smtp.json")
        self.addr_path = os.path.join(root, "addresses.json")
        self._lock = threading.Lock()
        self._inbox: Dict[str, List[Dict[str, Any]]] = {}
        self._addresses: Dict[str, str] = {}
        if os.path.exists(self.path):
            with open(self.path) as fh:
                self._inbox = json.load(fh)
        if os.path.exists(self.addr_path):
            with open(self.addr_path) as fh:
                self._addresses = json.load(fh)
        self.smtp = SMTPConfig(self._read_json(self.smtp_path))

    @staticmethod
    def _read_json(path: str) -> Dict[str, Any]:
        if os.path.exists(path):
            with open(path) as fh:
                return json.load(fh)
        return {}

    def _flush_locked(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._inbox, fh)
        os.replace(tmp, self.path)

    # ---- configuration --------------------------------------------------------------
    def configure_smtp(self, data: Dict[str, Any]) -> None:
        self.smtp = SMTPConfig(data)
        tmp = self.smtp_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(data, fh, indent=2)
        os.replace(tmp, self.smtp_path)

    def set_address(self, username: str, email: str) -> None:
        if "@" not in email:
            raise ValueError(f"not an email address: {email!r}")
        with self._lock:
            self._addresses[username] = email
            tmp = self.addr_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(self._addresses, fh, indent=2)
            os.replace(tmp, self.addr_path)

    # ---- delivery -------------------------------------------------------------------
    def notify(self, username: str, kind: str, title: str,
               body: str = "", detail: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        record = {
            "id": uuid.uuid4().hex[:12],
            "kind": kind,
            "title": title,
            "body": body,
            "detail": detail or {},
            "created_at": time.time(),
            "read": False,
            "email": None,
        }
        email = self._addresses.get(username)
        if email and self.smtp.enabled:
            record["email"] = self._send_email(email, title, body or title)
        with self._lock:
            self._inbox.setdefault(username, []).append(record)
            del self._inbox[username][:-200]
            self._flush_locked()
        return record

    def _send_email(self, to: str, subject: str, body: str) -> str:
        msg = EmailMessage()
        msg["From"] = self.smtp.sender
        msg["To"] = to
        msg["Subject"] = subject
        msg.set_content(body)
        try:
            with smtplib.SMTP(self.smtp.host, self.smtp.port, timeout=self.smtp.timeout) as client:
                if self.smtp.starttls:
                    client.starttls()
                if self.smtp.username:
                    client.login(self.smtp.username, self.smtp.password or "")
                client.send_message(msg)
            return "sent"
        except Exception as exc:  # best-effort channel; inbox already has it
            logger.warning("SMTP delivery to %s failed: %s", to, exc)
            return f"failed: {exc}"

    # ---- inbox ----------------------------------------------------------------------
    def list(self, username: str, unread_only: bool = False) -> List[Dict[str, Any]]:
        with self._lock:
            records = [dict(r) for r in self._inbox.get(username, [])]
        if unread_only:
            records = [r for r in records if not r["read"]]
        return records

    def mark_read(self, username: str, notification_id: Optional[str] = None) -> int:
        """Mark one (or all when id is None) as read; returns count marked."""
        count = 0
        with self._lock:
            for record in self._inbox.get(username, []):
                if notification_id is None or record["id"] == notification_id:
                    if not record["read"]:
                        record["read"] = True
                        count += 1
            if count:
                self._flush_locked()
        return count

    # ---- event bridge ---------------------------------------------------------------
    def on_job_event(self, event: Dict[str, Any], owner: Optional[str]) -> None:
        """Keeper listener hook: job lifecycle events → owner notifications."""
        if owner is None:
            return
        kind = event.get("event_type", "")
        if kind == "job_finished":
            state = event.get("state")
            self.notify(
                owner,
                "job." + str(state),
                f"Job {event.get('job_id')} {state}",
                detail={k: v for k, v in event.items() if k != "event_type"},
            )
        elif kind in ("job_approval_required", "job_approved", "job_rejected"):
            self.notify(owner, kind, f"Job {event.get('job_id') or event.get('approval_id')}: "
                        + kind.replace("job_", "").replace("_", " "),
                        detail={k: v for k, v in event.items() if k != "event_type"})
