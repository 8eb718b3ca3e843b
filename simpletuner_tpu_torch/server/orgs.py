"""Organizations: shared quotas, membership roles, approval policy.

The torch port's copy of ``simpletuner_tpu/server/orgs.py``: the same behavior.

Reference behavior: simpletuner_sdk/server/routes/{orgs,users,approvals}.py +
services (org-scoped quotas, member roles owner/admin/member, org-level
``require_approval`` forcing submissions through the approval queue; SURVEY.md
§2.7 "users/orgs/quotas/approvals").  a compact JSON store under the
platform state dir, enforced at job submission alongside per-user quotas.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .accounts import QuotaExceeded
from .store import default_state_dir

ORG_ROLES = ("owner", "admin", "member")


class OrgStore:
    """orgs.json: {org: {members: {user: role}, quotas, usage, require_approval}}."""

    def __init__(self, root: Optional[str] = None):
        base = root or default_state_dir()
        os.makedirs(base, exist_ok=True)
        self.path = os.path.join(base, "orgs.json")
        self._lock = threading.Lock()
        self._orgs: Dict[str, Dict[str, Any]] = {}
        if os.path.exists(self.path):
            with open(self.path) as fh:
                self._orgs = json.load(fh)

    def _flush(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._orgs, fh, indent=2)
        os.replace(tmp, self.path)

    # ---- lifecycle ------------------------------------------------------------------
    def create_org(
        self,
        name: str,
        owner: str,
        max_concurrent_jobs: Optional[int] = None,
        max_total_steps: Optional[int] = None,
        monthly_budget_usd: Optional[float] = None,
        require_approval: bool = False,
    ) -> Dict[str, Any]:
        if not name or not name.replace("-", "").replace("_", "").isalnum():
            raise ValueError("org name must be alphanumeric (dashes/underscores ok)")
        with self._lock:
            if name in self._orgs:
                raise ValueError(f"org {name!r} exists")
            self._orgs[name] = {
                "members": {owner: "owner"},
                "quotas": {
                    "max_concurrent_jobs": max_concurrent_jobs,
                    "max_total_steps": max_total_steps,
                    "monthly_budget_usd": monthly_budget_usd,
                },
                "usage": {"steps_requested": 0, "spend_usd": 0.0, "spend_month": _month()},
                "require_approval": bool(require_approval),
                "created": time.time(),
            }
            self._flush()
            return self._describe_locked(name)

    def delete_org(self, name: str) -> bool:
        with self._lock:
            if self._orgs.pop(name, None) is None:
                return False
            self._flush()
            return True

    def list_orgs(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [self._describe_locked(n) for n in sorted(self._orgs)]

    def describe(self, name: str) -> Dict[str, Any]:
        with self._lock:
            return self._describe_locked(name)

    def _describe_locked(self, name: str) -> Dict[str, Any]:
        org = self._orgs[name]
        return {
            "name": name,
            "members": dict(org["members"]),
            "quotas": dict(org["quotas"]),
            "usage": dict(org["usage"]),
            "require_approval": org["require_approval"],
        }

    # ---- membership -----------------------------------------------------------------
    def add_member(self, name: str, username: str, role: str = "member") -> None:
        if role not in ORG_ROLES:
            raise ValueError(f"role must be one of {ORG_ROLES}")
        with self._lock:
            org = self._orgs.get(name)
            if org is None:
                raise KeyError(f"unknown org {name!r}")
            org["members"][username] = role
            self._flush()

    def remove_member(self, name: str, username: str) -> bool:
        with self._lock:
            org = self._orgs.get(name)
            if org is None or username not in org["members"]:
                return False
            if org["members"][username] == "owner" and sum(
                1 for r in org["members"].values() if r == "owner"
            ) == 1:
                raise ValueError("cannot remove the last owner")
            del org["members"][username]
            self._flush()
            return True

    def org_of(self, username: str) -> Optional[str]:
        """First org the user belongs to (reference: one primary org/user)."""
        with self._lock:
            for name in sorted(self._orgs):
                if username in self._orgs[name]["members"]:
                    return name
        return None

    def member_role(self, name: str, username: str) -> Optional[str]:
        with self._lock:
            org = self._orgs.get(name)
            return None if org is None else org["members"].get(username)

    def set_policy(self, name: str, require_approval: Optional[bool] = None,
                   quotas: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            org = self._orgs.get(name)
            if org is None:
                raise KeyError(f"unknown org {name!r}")
            if require_approval is not None:
                org["require_approval"] = bool(require_approval)
            if quotas:
                for key in ("max_concurrent_jobs", "max_total_steps", "monthly_budget_usd"):
                    if key in quotas:
                        org["quotas"][key] = quotas[key]
            self._flush()

    # ---- quota enforcement ----------------------------------------------------------
    def requires_approval(self, username: str) -> bool:
        name = self.org_of(username)
        if name is None:
            return False
        with self._lock:
            return bool(self._orgs[name]["require_approval"])

    def check_quota(self, username: str, config: Dict[str, Any], org_running_jobs: int) -> None:
        """Org-level concurrent-job / step-budget / monthly-spend enforcement;
        raises :class:`QuotaExceeded` (complements per-user quota checks)."""
        name = self.org_of(username)
        if name is None:
            return
        with self._lock:
            org = self._orgs[name]
            self._roll_month_locked(org)
            quotas = org["quotas"]
            limit = quotas.get("max_concurrent_jobs")
            if limit is not None and org_running_jobs >= limit:
                raise QuotaExceeded(
                    f"org {name} already has {org_running_jobs} active jobs (limit {limit})"
                )
            budget = quotas.get("max_total_steps")
            steps = int(config.get("max_train_steps") or 0)
            if budget is not None and org["usage"]["steps_requested"] + steps > budget:
                raise QuotaExceeded(f"org {name} step budget exhausted (limit {budget})")
            spend_cap = quotas.get("monthly_budget_usd")
            if spend_cap is not None and org["usage"]["spend_usd"] >= spend_cap:
                raise QuotaExceeded(
                    f"org {name} monthly budget exhausted "
                    f"(${org['usage']['spend_usd']:.2f} of ${spend_cap:.2f})"
                )

    def record_submission(self, username: str, config: Dict[str, Any]) -> None:
        name = self.org_of(username)
        if name is None:
            return
        with self._lock:
            org = self._orgs[name]
            org["usage"]["steps_requested"] += int(config.get("max_train_steps") or 0)
            self._flush()

    def record_spend(self, username: str, usd: float) -> None:
        name = self.org_of(username)
        if name is None:
            return
        with self._lock:
            org = self._orgs[name]
            self._roll_month_locked(org)
            org["usage"]["spend_usd"] += float(usd)
            self._flush()

    def _roll_month_locked(self, org: Dict[str, Any]) -> None:
        month = _month()
        if org["usage"].get("spend_month") != month:
            org["usage"]["spend_month"] = month
            org["usage"]["spend_usd"] = 0.0


def _month() -> str:
    return time.strftime("%Y-%m", time.gmtime())
