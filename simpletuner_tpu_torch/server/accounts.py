"""Users, API tokens, and quotas for the training server.

The torch port's copy of ``simpletuner_tpu/server/accounts.py``: the same behavior.

Reference behavior: simpletuner_sdk/server/services auth (API tokens, roles)
and the quota manager (per-user concurrent-job and step budgets; SURVEY.md
§2.7, reference routes ``users``/``quota``).  a compact JSON user
store under the platform state dir; authentication is bearer-token, quotas are
enforced at job submission.

Auth activates as soon as the first user exists (or ``require_auth`` is set);
an empty store keeps the server open for single-user localhost workflows,
matching the reference's default-off auth.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
import time
from typing import Any, Dict, List, Optional

from .store import default_state_dir


class QuotaExceeded(Exception):
    pass


class UserStore:
    """users.json: {username: {token, role, quotas, usage, created}}."""

    def __init__(self, root: Optional[str] = None):
        base = root or default_state_dir()
        os.makedirs(base, exist_ok=True)
        self.path = os.path.join(base, "users.json")
        self._lock = threading.Lock()
        self._users: Dict[str, Dict[str, Any]] = {}
        if os.path.exists(self.path):
            with open(self.path) as fh:
                self._users = json.load(fh)

    def _flush(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._users, fh, indent=2)
        os.replace(tmp, self.path)

    # ---- accounts ------------------------------------------------------------------
    def create_user(
        self,
        username: str,
        role: str = "user",
        max_concurrent_jobs: int = 2,
        max_total_steps: Optional[int] = None,
        needs_approval: bool = False,
    ) -> Dict[str, Any]:
        if role not in ("admin", "user"):
            raise ValueError("role must be admin|user")
        with self._lock:
            if username in self._users:
                raise ValueError(f"user {username!r} exists")
            token = secrets.token_urlsafe(24)
            self._users[username] = {
                "token": token,
                "role": role,
                "needs_approval": bool(needs_approval),
                "quotas": {
                    "max_concurrent_jobs": max_concurrent_jobs,
                    "max_total_steps": max_total_steps,
                },
                "usage": {"jobs_submitted": 0, "steps_requested": 0, "spend_usd": 0.0},
                "created": time.time(),
            }
            self._flush()
            return {"username": username, "token": token, "role": role}

    def ensure_user(self, username: str, role: str = "user") -> Dict[str, Any]:
        """Get-or-create for external-auth provisioning (OIDC/directory
        logins auto-provision local accounts, reference external_auth
        routes).  An existing user keeps their token; the role is upgraded
        to admin if the external identity grants it, never downgraded."""
        with self._lock:
            user = self._users.get(username)
            if user is not None:
                if role == "admin" and user["role"] != "admin":
                    user["role"] = "admin"
                    self._flush()
                return {"username": username, "token": user["token"], "role": user["role"]}
        return self.create_user(username, role=role)

    def set_needs_approval(self, username: str, needs_approval: bool) -> None:
        with self._lock:
            user = self._users.get(username)
            if user is None:
                raise KeyError(f"unknown user {username!r}")
            user["needs_approval"] = bool(needs_approval)
            self._flush()

    def needs_approval(self, username: str) -> bool:
        with self._lock:
            user = self._users.get(username)
            return bool(user and user.get("needs_approval"))

    def record_spend(self, username: str, usd: float) -> None:
        with self._lock:
            user = self._users.get(username)
            if user is None:
                return
            user["usage"]["spend_usd"] = user["usage"].get("spend_usd", 0.0) + float(usd)
            self._flush()

    def delete_user(self, username: str) -> bool:
        with self._lock:
            if self._users.pop(username, None) is None:
                return False
            self._flush()
            return True

    def list_users(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {"username": name, "role": u["role"], "quotas": u["quotas"], "usage": u["usage"]}
                for name, u in self._users.items()
            ]

    @property
    def auth_required(self) -> bool:
        return bool(self._users)

    def authenticate(self, bearer: Optional[str]) -> Optional[Dict[str, Any]]:
        """Bearer token → {"username", ...user} or None."""
        if not bearer:
            return None
        token = bearer.split(" ", 1)[1].strip() if bearer.lower().startswith("bearer ") else bearer.strip()
        with self._lock:
            for name, user in self._users.items():
                if secrets.compare_digest(user["token"], token):
                    return {"username": name, **user}
        return None

    # ---- quotas --------------------------------------------------------------------
    def check_quota(self, username: str, config: Dict[str, Any], running_jobs: int) -> None:
        """Raises :class:`QuotaExceeded` when the submit would breach limits
        (reference quota manager: concurrent jobs + cumulative step budget)."""
        with self._lock:
            user = self._users.get(username)
            if user is None:
                raise QuotaExceeded(f"unknown user {username!r}")
            quotas = user["quotas"]
            limit = quotas.get("max_concurrent_jobs")
            if limit is not None and running_jobs >= limit:
                raise QuotaExceeded(
                    f"{username} already has {running_jobs} active jobs (limit {limit})"
                )
            budget = quotas.get("max_total_steps")
            steps = int(config.get("max_train_steps") or 0)
            if budget is not None and user["usage"]["steps_requested"] + steps > budget:
                remaining = budget - user["usage"]["steps_requested"]
                raise QuotaExceeded(
                    f"{username} step budget exhausted ({remaining} of {budget} remaining, "
                    f"requested {steps})"
                )

    def record_submission(self, username: str, config: Dict[str, Any]) -> None:
        with self._lock:
            user = self._users.get(username)
            if user is None:
                return
            user["usage"]["jobs_submitted"] += 1
            user["usage"]["steps_requested"] += int(config.get("max_train_steps") or 0)
            self._flush()

    def usage(self, username: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            user = self._users.get(username)
            if user is None:
                return None
            return {"username": username, "quotas": user["quotas"], "usage": user["usage"]}
