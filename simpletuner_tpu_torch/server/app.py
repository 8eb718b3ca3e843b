"""Training API server of the torch port.

The port's copy of ``simpletuner_tpu/server/app.py``: a dependency-free
stdlib HTTP server carrying the training API surface: job
submission/status/logs/cancel, manual validation/checkpoint signals, SSE
event stream, model/optimizer listings, config validation, and a webhook
callback endpoint the trainer posts its events to.  Every route answers as
the JAX server answers, except where the port differs by design:

* training jobs run ``python -m simpletuner_tpu_torch.train --config ...
  --device <device>`` and render jobs ``python -m simpletuner_tpu_torch.cli
  inference ... --device <device>``, where ``device`` is the server's
  (``create_server(device=...)``, ``--device``; default ``cuda``);
* ``/api/hardware`` reports the ``torch.cuda`` devices, ``/api/version``
  torch, CUDA and the card;
* ``/api/optimizers`` lists the port's optimizer registry, and
  ``/api/models/<family>/presets`` gives the port's presets (the JAX ones
  without the mesh preset, ROADMAP Queue 1 item 5) for ``flux`` and ``sd3``
  and answers 501 for a family the port does not train (item 6).

Routes:
  GET  /health
  GET  /api/models  /api/models/<f>/presets  /api/optimizers  /api/fields
  POST /api/config/validate            {config}
  POST /api/training/start             {config, priority?, job_id?}
                                       → 201 job | 202 awaiting_approval
  GET  /api/training/jobs  /api/training/status/<id>  /api/training/logs/<id>
  POST /api/training/cancel/<id>  /api/training/signal/<id>
  GET  /api/queue                      (fair-share dispatch order + usage)
  GET  /api/events (SSE)   POST /api/events/callback
  GET/POST /api/users      DELETE /api/users/<name>      GET /api/quota
  GET/POST /api/orgs       GET/DELETE /api/orgs/<name>
  POST /api/orgs/<name>/members|policy DELETE /api/orgs/<name>/members/<user>
  GET  /api/approvals      POST /api/approvals/<id>/approve|reject
  GET/POST /api/pricing    POST /api/costs/estimate
  GET  /api/notifications  POST /api/notifications/read|address|smtp
  POST /api/auth/oidc {id_token}   /api/auth/login {username,password}
  POST /api/auth/config            (OIDC/directory provider setup, admin)
  GET  /metrics (Prometheus)  /api/audit  (hash-chain verified)
  GET  /api/version  /api/hardware  /api/system
  GET  /api/checkpoints?output_dir=…   (guard/manifest/artifact inventory)
  POST /api/inference/start            {checkpoint, prompt, …} → render job
  GET/POST/DELETE /api/prompt-libraries[/<name>]
  GET  /api/lycoris/presets            (algorithm preset table)
  GET  /api/datasets/viewer?dir=…&offset=&limit=&thumbnails=1
  GET  /api/datasets/browse|detect|viewer/summary|captions/status|captions/get
  POST /api/datasets/folders|upload|upload/zip|captions|scan
  GET  /api/datasets/scan/status|scan/active
  GET/POST/PATCH /api/datasets/plan    DELETE /api/datasets/plan/<id>
  GET  /api/themes[/<id>[/theme.css]]  POST /api/themes/<id>
  GET  /api/git/status|history|diff    POST /api/git/init|identity|remote|
                                            snapshot|revert
  POST /api/webhooks/test              {url, message?}
  GET  /  /ui  /static/*               (WebUI: dashboard + job form + dataset
                                        plan viewer, server/static/)
"""

from __future__ import annotations

import json
import logging
import os
import queue
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from .process_keeper import ProcessKeeper

logger = logging.getLogger(__name__)


class SSEManager:
    """In-memory fanout of server events to any number of SSE clients
    (reference simpletuner_sdk sse_manager.py)."""

    def __init__(self, history: int = 200):
        self._clients: List[queue.Queue] = []
        self._history: List[Dict[str, Any]] = []
        self._history_limit = history
        self._lock = threading.Lock()

    def publish(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._history.append(event)
            del self._history[: -self._history_limit]
            for q in list(self._clients):
                try:
                    q.put_nowait(event)
                except queue.Full:
                    pass

    def subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=256)
        with self._lock:
            for event in self._history[-20:]:
                q.put_nowait(event)
            self._clients.append(q)
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            if q in self._clients:
                self._clients.remove(q)


def create_server(
    host: str = "127.0.0.1",
    port: int = 8005,
    audit_path: Optional[str] = None,
    state_dir: Optional[str] = None,
    device: str = "cuda",
    max_concurrent_jobs: int = 1,  # job slots: child processes that run at once
) -> ThreadingHTTPServer:
    from .audit import AuditLog
    from .store import ConfigStore, default_state_dir

    state_dir = state_dir or default_state_dir()
    keeper = ProcessKeeper(max_concurrent=max_concurrent_jobs, state_dir=state_dir, device=device)
    configs = ConfigStore(state_dir)
    audit = AuditLog(audit_path)
    sse = SSEManager()
    keeper.add_listener(sse.publish)
    from .accounts import QuotaExceeded, UserStore
    from .approvals import ApprovalStore
    from .external_auth import ExternalAuth, ExternalAuthError
    from .jobqueue import FairShareQueue, QueueEntry
    from .notifications import NotificationCenter
    from .orgs import OrgStore
    from .pricing import PricingTable

    from . import extras
    from .datasets import DatasetService, parse_multipart
    from .extras import PromptLibraryStore
    from .git_integration import GitConfigRepo, GitError
    from .themes import ThemeStore

    datasets_svc = DatasetService(state_dir)
    themes = ThemeStore(state_dir)
    git_repo = GitConfigRepo(os.path.join(state_dir, "configs"))
    users = UserStore(state_dir)
    prompt_libraries = PromptLibraryStore(state_dir)
    orgs = OrgStore(state_dir)
    approvals = ApprovalStore(state_dir)
    notifications = NotificationCenter(state_dir)
    pricing = PricingTable(state_dir)
    external_auth = ExternalAuth(state_dir)
    run_queue = FairShareQueue(
        dispatch=lambda entry: keeper.start_job(entry.job_id),
        slots_free=keeper.slots_free,
        state_dir=state_dir,
    )
    # restart recovery: queue entries that persisted without a live keeper job
    # (server died between submit and dispatch) are re-registered
    for pending in run_queue.pending():
        if keeper.get_job(pending["job_id"]) is None:
            keeper.submit_job(pending["config"], pending["job_id"],
                              owner=pending["owner"], priority=pending["priority"],
                              autostart=False)

    def _on_job_finished(event: Dict[str, Any]) -> None:
        """Accounting bridge: fair-share usage, cost accrual, notifications
        (reference: cloud queue usage tracking + cost service + notifier)."""
        if event.get("event_type") != "job_finished":
            return
        job = keeper.get_job(event.get("job_id", ""))
        if job is None or job.owner is None:
            return
        duration = max(0.0, (job.finished_at or 0) - (job.started_at or job.finished_at or 0))
        run_queue.record_usage(job.owner, duration)
        cost = pricing.actual_cost(job.config, duration)
        job.cost_usd = cost
        if cost:
            users.record_spend(job.owner, cost)
            orgs.record_spend(job.owner, cost)
        notifications.on_job_event(event, job.owner)
        run_queue.kick()

    keeper.add_listener(_on_job_finished)

    def _submit_through_queue(config: Dict[str, Any], owner: str, priority: int,
                              job_id: Optional[str] = None):
        job = keeper.submit_job(config, job_id, owner=owner, priority=priority,
                                autostart=False)
        run_queue.enqueue(QueueEntry(job.job_id, config, owner, priority))
        return job

    class Handler(BaseHTTPRequestHandler):
        server_version = "simpletuner-tpu-torch"

        # ---- plumbing -------------------------------------------------------------------
        def log_message(self, fmt, *args):
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _json(self, payload: Any, status: int = 200) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> Dict[str, Any]:
            length = int(self.headers.get("Content-Length", 0) or 0)
            if not length:
                return {}
            return json.loads(self.rfile.read(length) or b"{}")

        def _html(self, body: str, status: int = 200) -> None:
            data = body.encode()
            self.send_response(status)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _static(self, name: str) -> None:
            """Serve the bundled WebUI (reference: simpletuner/static/ +
            templates/ trainer dashboard, rebuilt as static vanilla JS)."""
            base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")
            full = os.path.normpath(os.path.join(base, name))
            if not full.startswith(base) or not os.path.isfile(full):
                return self._json({"error": "not found"}, 404)
            ctype = {
                ".html": "text/html; charset=utf-8",
                ".js": "application/javascript; charset=utf-8",
                ".css": "text/css; charset=utf-8",
            }.get(os.path.splitext(full)[1], "application/octet-stream")
            with open(full, "rb") as fh:
                data = fh.read()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _auth(self):
            """Bearer auth (reference users/auth routes): active once any user
            exists.  Returns the user dict, or None with a 401 already sent."""
            if not users.auth_required:
                return {"username": "anonymous", "role": "admin"}
            user = users.authenticate(self.headers.get("Authorization"))
            if user is None:
                self._json({"error": "unauthorized"}, 401)
                return None
            return user

        # ---- GET --------------------------------------------------------------------------
        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/health":
                return self._json({"status": "ok", "time": time.time()})
            # static WebUI assets are public (the JSON APIs they call stay
            # behind bearer auth, like the reference's login-gated dashboard)
            if path in ("/", "/ui"):
                return self._static("index.html")
            if path.startswith("/static/"):
                return self._static(path[len("/static/"):])
            user = self._auth()
            if user is None:
                return
            if path == "/api/users":
                if user["role"] != "admin":
                    return self._json({"error": "admin only"}, 403)
                return self._json(users.list_users())
            if path == "/api/quota":
                usage = users.usage(user["username"])
                return self._json(usage or {"username": user["username"], "quotas": None})
            if path == "/metrics":
                # Prometheus text exposition (reference
                # server/services/cloud/prometheus_metrics.py)
                states: Dict[str, int] = {}
                for job in keeper.jobs.values():
                    states[job.state] = states.get(job.state, 0) + 1
                lines = [
                    "# HELP simpletuner_jobs_total Jobs by state",
                    "# TYPE simpletuner_jobs_total gauge",
                ]
                for state_name in ("pending", "running", "completed", "failed", "cancelled"):
                    lines.append(
                        f'simpletuner_jobs_total{{state="{state_name}"}} {states.get(state_name, 0)}'
                    )
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if path == "/api/models":
                from ..models.registry import ModelRegistry

                return self._json(
                    {f: ModelRegistry.metadata(f) for f in ModelRegistry.families()}
                )
            match = re.match(r"^/api/models/([\w-]+)/presets$", path)
            if match:
                # per-family acceleration presets (reference
                # get_acceleration_presets flux/model.py:122-229)
                from ..models.registry import ModelRegistry

                try:
                    cls = ModelRegistry.get(match.group(1))
                except KeyError:
                    return self._json({"error": "unknown model family"}, status=404)
                except NotImplementedError as exc:
                    return self._json({"error": str(exc)}, status=501)
                return self._json(cls.get_acceleration_presets())
            if path == "/api/optimizers":
                from ..training.optimizers import optimizer_names

                return self._json(list(optimizer_names()))
            if path == "/api/training/jobs":
                return self._json(keeper.list_jobs())
            match = re.match(r"^/api/training/status/([\w-]+)$", path)
            if match:
                job = keeper.get_job(match.group(1))
                if job is None:
                    return self._json({"error": "unknown job"}, 404)
                return self._json(job.to_dict())
            match = re.match(r"^/api/training/logs/([\w-]+)$", path)
            if match:
                job = keeper.get_job(match.group(1))
                if job is None:
                    return self._json({"error": "unknown job"}, 404)
                tail = 100
                if "tail=" in self.path:
                    tail = int(self.path.split("tail=")[1].split("&")[0])
                return self._json({"job_id": job.job_id, "logs": list(job.logs)[-tail:]})
            if path == "/api/events":
                return self._sse()
            if path == "/api/fields":
                # canonical config-field schema powering CLI + WebUI forms
                # (reference services/field_registry/registry.py)
                from ..configuration.fields import REGISTRY

                return self._json(
                    [
                        {
                            "name": f.name,
                            "type": f.type.value,
                            "default": f.default,
                            "help": f.help,
                            "section": f.section,
                            "choices": list(f.choices) if f.choices else None,
                        }
                        for f in REGISTRY.fields()
                    ]
                )
            if path == "/api/configs":
                return self._json(configs.list())
            match = re.match(r"^/api/configs/([\w.-]+)/versions$", path)
            if match:
                return self._json(configs.versions(match.group(1)))
            match = re.match(r"^/api/configs/([\w.-]+)$", path)
            if match:
                version = None
                if "version=" in self.path:
                    version = int(self.path.split("version=")[1].split("&")[0])
                entry = configs.get(match.group(1), version)
                if entry is None:
                    return self._json({"error": "unknown config"}, 404)
                return self._json(entry)
            if path == "/api/audit":
                # audit trail with chain verification (reference
                # documentation/experimental/server/AUDIT.md)
                ok, bad = audit.verify()
                return self._json({"verified": ok, "first_bad_seq": bad, "records": audit.records()})
            if path == "/api/orgs":
                return self._json(orgs.list_orgs())
            match = re.match(r"^/api/orgs/([\w-]+)$", path)
            if match:
                try:
                    return self._json(orgs.describe(match.group(1)))
                except KeyError:
                    return self._json({"error": "unknown org"}, 404)
            if path == "/api/approvals":
                state = None
                if "state=" in self.path:
                    state = self.path.split("state=")[1].split("&")[0]
                owner = None if user["role"] == "admin" else user["username"]
                return self._json(approvals.list(state=state, owner=owner))
            if path == "/api/queue":
                # pending dispatch order + decayed fair-share usage
                # (reference cloud queue status route)
                return self._json({
                    "pending": run_queue.pending(),
                    "fair_share_usage_seconds": run_queue.usage_snapshot(),
                    "slots_free": keeper.slots_free(),
                })
            if path == "/api/pricing":
                return self._json(pricing.rates())
            if path == "/api/notifications":
                unread = "unread=1" in self.path or "unread=true" in self.path
                return self._json(notifications.list(user["username"], unread_only=unread))
            if path == "/api/version":
                return self._json(extras.version_info())
            if path == "/api/hardware":
                return self._json(extras.hardware_info())
            if path == "/api/system":
                return self._json(extras.system_info(state_dir, len(sse._clients)))
            if path == "/api/checkpoints":
                output_dir = self._query_param("output_dir")
                if not output_dir:
                    return self._json({"error": "output_dir query param required"}, 422)
                return self._json(extras.list_checkpoints(output_dir))
            if path == "/api/lycoris/presets":
                from ..cli.configure_tui import LYCORIS_ALGORITHMS

                return self._json(LYCORIS_ALGORITHMS)
            if path == "/api/prompt-libraries":
                return self._json(prompt_libraries.list())
            match = re.match(r"^/api/prompt-libraries/([\w.-]+)$", path)
            if match:
                entry = prompt_libraries.get(match.group(1))
                if entry is None:
                    return self._json({"error": "unknown prompt library"}, 404)
                return self._json(entry)
            if path == "/api/datasets/viewer":
                directory = self._query_param("dir")
                if not directory:
                    return self._json({"error": "dir query param required"}, 422)
                try:
                    return self._json(extras.dataset_samples(
                        directory,
                        offset=int(self._query_param("offset") or 0),
                        limit=int(self._query_param("limit") or 50),
                        thumbnails=self._query_param("thumbnails") in ("1", "true"),
                    ))
                except FileNotFoundError as exc:
                    return self._json({"error": str(exc)}, 404)
            # ---- dataset management (reference routes/datasets.py + dataset_viewer.py)
            try:
                if path == "/api/datasets/browse":
                    return self._json(datasets_svc.browse(self._query_param("path")))
                if path == "/api/datasets/detect":
                    p = self._query_param("path")
                    if not p:
                        return self._json({"error": "path query param required"}, 422)
                    return self._json(datasets_svc.detect(p))
                if path == "/api/datasets/plan":
                    return self._json({"datasets": datasets_svc.plan.get()})
                if path == "/api/datasets/captions/status":
                    p = self._query_param("path")
                    if not p:
                        return self._json({"error": "path query param required"}, 422)
                    return self._json(datasets_svc.caption_status(p))
                if path == "/api/datasets/captions/get":
                    p, f = self._query_param("path"), self._query_param("file")
                    if not p or not f:
                        return self._json({"error": "path and file required"}, 422)
                    return self._json(datasets_svc.read_caption(p, f))
                if path == "/api/datasets/viewer/summary":
                    p = self._query_param("path")
                    if not p:
                        return self._json({"error": "path query param required"}, 422)
                    return self._json(datasets_svc.summary(p))
                if path == "/api/datasets/scan/active":
                    return self._json(datasets_svc.scans.active())
                if path == "/api/datasets/scan/status":
                    return self._json(
                        datasets_svc.scans.status(self._query_param("scan_id"))
                        or {"error": "unknown scan"})
            except PermissionError as exc:
                return self._json({"error": str(exc)}, 403)
            except FileNotFoundError as exc:
                return self._json({"error": f"not found: {exc}"}, 404)
            # ---- themes (reference routes/themes.py)
            if path == "/api/themes":
                return self._json(themes.list())
            match = re.match(r"^/api/themes/([\w-]+)/theme\.css$", path)
            if match:
                css = themes.css(match.group(1))
                if css is None:
                    return self._json({"error": "unknown theme"}, 404)
                data = css.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/css; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            match = re.match(r"^/api/themes/([\w-]+)$", path)
            if match:
                theme = themes.get(match.group(1))
                if theme is None:
                    return self._json({"error": "unknown theme"}, 404)
                return self._json(theme)
            # ---- git config versioning (reference routes/git.py)
            from .git_integration import GitError as _GitError

            try:
                if path == "/api/git/status":
                    return self._json(git_repo.status())
                if path == "/api/git/history":
                    return self._json(git_repo.history(
                        self._query_param("path"),
                        int(self._query_param("limit") or 20)))
                if path == "/api/git/diff":
                    return self._json({"diff": git_repo.diff(
                        self._query_param("path"), self._query_param("commit"))})
            except _GitError as exc:
                return self._json({"error": str(exc)}, 422)
            return self._json({"error": "not found"}, 404)

        def _query_param(self, name: str) -> Optional[str]:
            from urllib.parse import parse_qs, urlparse

            values = parse_qs(urlparse(self.path).query).get(name)
            return values[0] if values else None

        def _sse(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            q = sse.subscribe()
            try:
                while True:
                    try:
                        event = q.get(timeout=15.0)
                        payload = f"data: {json.dumps(event)}\n\n"
                    except queue.Empty:
                        payload = ": keepalive\n\n"
                    self.wfile.write(payload.encode())
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                sse.unsubscribe(q)

        # ---- POST -------------------------------------------------------------------------
        def do_POST(self):
            path = self.path.split("?")[0]
            # binary upload endpoints parse their own bodies (multipart/zip)
            if path in ("/api/datasets/upload", "/api/datasets/upload/zip"):
                user = self._auth()
                if user is None:
                    return
                return self._dataset_upload(path)
            try:
                body = self._read_body()
            except (ValueError, json.JSONDecodeError):
                return self._json({"error": "invalid json"}, 400)

            # external-auth logins are reachable without a bearer token
            if path == "/api/auth/oidc":
                try:
                    identity = external_auth.oidc_login(str(body.get("id_token") or ""))
                except ExternalAuthError as exc:
                    audit.append("auth.oidc_denied", detail={"error": str(exc)})
                    return self._json({"error": str(exc)}, 401)
                account = users.ensure_user(identity["username"], identity["role"])
                audit.append("auth.oidc_login", detail={"username": identity["username"]})
                return self._json({**account, "email": identity.get("email")})
            if path == "/api/auth/login":
                try:
                    identity = external_auth.directory_login(
                        str(body.get("username") or ""), str(body.get("password") or "")
                    )
                except ExternalAuthError as exc:
                    audit.append("auth.login_denied",
                                 detail={"username": body.get("username")})
                    return self._json({"error": str(exc)}, 401)
                account = users.ensure_user(identity["username"], identity["role"])
                audit.append("auth.login", detail={"username": identity["username"]})
                return self._json({**account, "email": identity.get("email")})

            user = self._auth()
            if user is None:
                return

            if path == "/api/users":
                # bootstrap: the first user may be created unauthenticated and
                # becomes the admin; afterwards admin-only
                if users.auth_required and user["role"] != "admin":
                    return self._json({"error": "admin only"}, 403)
                try:
                    created = users.create_user(
                        str(body.get("username") or "").strip() or "admin",
                        role=body.get("role") or ("admin" if not users.auth_required else "user"),
                        max_concurrent_jobs=int(body.get("max_concurrent_jobs", 2)),
                        max_total_steps=body.get("max_total_steps"),
                    )
                except ValueError as exc:
                    return self._json({"error": str(exc)}, 422)
                audit.append("user.create", detail={"username": created["username"]})
                return self._json(created, 201)

            if path == "/api/config/validate":
                from ..configuration import TrainingConfig

                try:
                    TrainingConfig(dict(body.get("config") or body))
                    return self._json({"valid": True})
                except Exception as exc:
                    return self._json({"valid": False, "error": str(exc)}, 422)

            if path == "/api/training/start":
                config = body.get("config") or body
                if not config.get("model_family"):
                    return self._json({"error": "config.model_family required"}, 422)
                username = user["username"]
                priority = int(body.get("priority", 4))
                if users.auth_required:
                    active = sum(
                        1 for j in keeper.jobs.values()
                        if j.state in ("pending", "running") and j.owner == username
                    )
                    org_name = orgs.org_of(username)
                    org_active = sum(
                        1 for j in keeper.jobs.values()
                        if j.state in ("pending", "running")
                        and j.owner is not None
                        and orgs.org_of(j.owner) == org_name
                    ) if org_name else 0
                    try:
                        users.check_quota(username, config, active)
                        orgs.check_quota(username, config, org_active)
                    except QuotaExceeded as exc:
                        audit.append("job.quota_denied", detail={"user": username})
                        return self._json({"error": str(exc)}, 429)
                    # approval gate: org policy or per-user flag; admins bypass
                    if user["role"] != "admin" and (
                        orgs.requires_approval(username) or users.needs_approval(username)
                    ):
                        record = approvals.submit(config, username, priority, org_name)
                        audit.append("job.approval_required",
                                     detail={"approval_id": record["approval_id"],
                                             "user": username})
                        sse.publish({"event_type": "job_approval_required",
                                     "approval_id": record["approval_id"],
                                     "owner": username})
                        return self._json(
                            {"state": "awaiting_approval",
                             "approval_id": record["approval_id"]}, 202)
                    users.record_submission(username, config)
                    orgs.record_submission(username, config)
                job = _submit_through_queue(config, username, priority, body.get("job_id"))
                audit.append("job.submit", detail={"job_id": job.job_id,
                                                   "user": username,
                                                   "priority": priority,
                                                   "model_family": config.get("model_family")})
                return self._json(job.to_dict(), 201)

            match = re.match(r"^/api/training/cancel/([\w-]+)$", path)
            if match:
                run_queue.remove(match.group(1))
                ok = keeper.cancel_job(match.group(1))
                if ok:
                    audit.append("job.cancel", detail={"job_id": match.group(1)})
                return self._json({"cancelled": ok}, 200 if ok else 404)

            match = re.match(r"^/api/training/signal/([\w-]+)$", path)
            if match:
                action = (body.get("action") or "").strip()
                if action not in ("validation", "checkpoint", "abort"):
                    return self._json({"error": "action must be validation|checkpoint|abort"}, 422)
                ok = keeper.send_signal(match.group(1), action)
                if ok:
                    audit.append("job.signal", detail={"job_id": match.group(1), "action": action})
                return self._json({"signalled": ok}, 200 if ok else 404)

            if path == "/api/events/callback":
                sse.publish(body)
                return self._json({"received": True})

            match = re.match(r"^/api/configs/([\w.-]+)$", path)
            if match:
                config = body.get("config") or body
                result = configs.save(match.group(1), dict(config))
                audit.append("config.save", detail=result)
                return self._json(result, 201)

            if path == "/api/datasets/plan":
                # parsed dataset plan (reference routes: datasets + dataset
                # blueprints): validates a multidatabackend config and returns
                # the resolved per-dataset summary without touching storage
                from ..configuration.dataloader import load_dataloader_config

                try:
                    datasets = load_dataloader_config(body.get("config") or body.get("datasets") or body)
                except Exception as exc:
                    return self._json({"valid": False, "error": str(exc)}, 422)
                return self._json(
                    {
                        "valid": True,
                        "datasets": [
                            {
                                "id": d.id,
                                "dataset_type": d.dataset_type,
                                "type": d.type,
                                "resolution": getattr(d, "resolution", None),
                                "crop": getattr(d, "crop", None),
                                "caption_strategy": getattr(d, "caption_strategy", None),
                            }
                            for d in datasets
                        ],
                    }
                )

            if path == "/api/orgs":
                if users.auth_required and user["role"] != "admin":
                    return self._json({"error": "admin only"}, 403)
                try:
                    org = orgs.create_org(
                        str(body.get("name") or ""),
                        owner=body.get("owner") or user["username"],
                        max_concurrent_jobs=body.get("max_concurrent_jobs"),
                        max_total_steps=body.get("max_total_steps"),
                        monthly_budget_usd=body.get("monthly_budget_usd"),
                        require_approval=bool(body.get("require_approval", False)),
                    )
                except ValueError as exc:
                    return self._json({"error": str(exc)}, 422)
                audit.append("org.create", detail={"name": org["name"]})
                return self._json(org, 201)

            match = re.match(r"^/api/orgs/([\w-]+)/members$", path)
            if match:
                name = match.group(1)
                if not self._org_admin(user, name):
                    return self._json({"error": "org admin only"}, 403)
                try:
                    orgs.add_member(name, str(body.get("username") or ""),
                                    body.get("role") or "member")
                except KeyError:
                    return self._json({"error": "unknown org"}, 404)
                except ValueError as exc:
                    return self._json({"error": str(exc)}, 422)
                audit.append("org.member_add",
                             detail={"org": name, "username": body.get("username")})
                return self._json(orgs.describe(name), 201)

            match = re.match(r"^/api/orgs/([\w-]+)/policy$", path)
            if match:
                name = match.group(1)
                if not self._org_admin(user, name):
                    return self._json({"error": "org admin only"}, 403)
                try:
                    orgs.set_policy(name,
                                    require_approval=body.get("require_approval"),
                                    quotas=body.get("quotas"))
                except KeyError:
                    return self._json({"error": "unknown org"}, 404)
                audit.append("org.policy", detail={"org": name})
                return self._json(orgs.describe(name))

            match = re.match(r"^/api/approvals/([\w-]+)/(approve|reject)$", path)
            if match:
                approval_id, action = match.groups()
                record = approvals.get(approval_id)
                if record is None:
                    return self._json({"error": "unknown approval"}, 404)
                allowed = user["role"] == "admin" or (
                    record.get("org") and self._org_admin(user, record["org"])
                )
                if not allowed:
                    return self._json({"error": "admin or org admin only"}, 403)
                try:
                    record = approvals.decide(approval_id, action == "approve",
                                              user["username"], body.get("reason"))
                except ValueError as exc:
                    return self._json({"error": str(exc)}, 409)
                audit.append(f"job.{action}", detail={"approval_id": approval_id,
                                                      "by": user["username"]})
                if action == "approve":
                    users.record_submission(record["owner"], record["config"])
                    orgs.record_submission(record["owner"], record["config"])
                    job = _submit_through_queue(record["config"], record["owner"],
                                                record["priority"])
                    notifications.on_job_event(
                        {"event_type": "job_approved", "job_id": job.job_id},
                        record["owner"])
                    return self._json({**record, "job_id": job.job_id})
                notifications.on_job_event(
                    {"event_type": "job_rejected", "approval_id": approval_id,
                     "reason": body.get("reason")}, record["owner"])
                return self._json(record)

            if path == "/api/pricing":
                if users.auth_required and user["role"] != "admin":
                    return self._json({"error": "admin only"}, 403)
                try:
                    pricing.set_rate(str(body.get("accelerator_type") or ""),
                                     body.get("usd_per_chip_hour"))
                except (TypeError, ValueError) as exc:
                    return self._json({"error": str(exc)}, 422)
                audit.append("pricing.set", detail=dict(body))
                return self._json(pricing.rates())

            if path == "/api/costs/estimate":
                try:
                    return self._json(pricing.estimate(body.get("config") or body))
                except KeyError as exc:
                    return self._json({"error": str(exc)}, 422)

            if path == "/api/notifications/read":
                count = notifications.mark_read(user["username"], body.get("id"))
                return self._json({"marked": count})

            if path == "/api/notifications/address":
                try:
                    notifications.set_address(user["username"], str(body.get("email") or ""))
                except ValueError as exc:
                    return self._json({"error": str(exc)}, 422)
                return self._json({"ok": True})

            if path == "/api/notifications/smtp":
                if users.auth_required and user["role"] != "admin":
                    return self._json({"error": "admin only"}, 403)
                notifications.configure_smtp(dict(body))
                audit.append("notifications.smtp", detail={"host": body.get("host")})
                return self._json({"ok": True})

            if path == "/api/inference/start":
                # checkpoint-inference job: rendered by a ``cli inference``
                # subprocess on the server's device, so the card is shared
                # through the same keeper
                checkpoint = str(body.get("checkpoint") or "").strip()
                prompt = str(body.get("prompt") or "").strip()
                if not checkpoint or not prompt:
                    return self._json({"error": "checkpoint and prompt required"}, 422)
                import sys as _sys

                output = body.get("output") or os.path.join(
                    state_dir, "inference", time.strftime("%Y%m%d-%H%M%S"))
                argv = [_sys.executable, "-m", "simpletuner_tpu_torch.cli", "inference",
                        "--checkpoint", checkpoint, "--prompt", prompt,
                        "--output", str(output),
                        "--steps", str(int(body.get("steps", 20))),
                        "--seed", str(int(body.get("seed", 42))),
                        "--device", keeper.device]
                if body.get("config"):
                    argv += ["--config", str(body["config"])]
                if body.get("resolution"):
                    argv += ["--resolution", str(int(body["resolution"]))]
                job = keeper.submit_job(
                    {"checkpoint": checkpoint, "prompt": prompt, "output_dir": str(output)},
                    owner=user["username"], kind="inference", argv=argv)
                audit.append("inference.start",
                             detail={"job_id": job.job_id, "checkpoint": checkpoint})
                return self._json(job.to_dict(), 201)

            match = re.match(r"^/api/prompt-libraries/([\w.-]+)$", path)
            if match:
                try:
                    result = prompt_libraries.save(
                        match.group(1), body.get("library") or body)
                except ValueError as exc:
                    return self._json({"error": str(exc)}, 422)
                audit.append("prompt_library.save", detail=result)
                return self._json(result, 201)

            if path == "/api/webhooks/test":
                url = str(body.get("url") or "").strip()
                if not url:
                    return self._json({"error": "url required"}, 422)
                try:
                    result = extras.webhook_test(
                        url, body.get("message") or "simpletuner-tpu webhook test")
                except Exception as exc:
                    return self._json({"sent": False, "error": str(exc)}, 502)
                audit.append("webhooks.test", detail={"url": url})
                return self._json(result)

            # ---- dataset management -------------------------------------------------------
            try:
                if path == "/api/datasets/folders":
                    result = datasets_svc.create_folder(str(body.get("name") or ""))
                    audit.append("dataset.folder", detail=result)
                    return self._json(result, 201)
                if path == "/api/datasets/captions":
                    result = datasets_svc.write_caption(
                        str(body.get("path") or ""), str(body.get("file") or ""),
                        str(body.get("text") or ""))
                    return self._json(result, 201)
                if path == "/api/datasets/scan":
                    directory = str(body.get("dir") or body.get("path") or "")
                    if not directory:
                        return self._json({"error": "dir required"}, 422)
                    full = datasets_svc.resolve(directory, allow_outside=True)
                    record = datasets_svc.scans.start(
                        full, float(body.get("resolution", 1024) or 1024),
                        str(body.get("resolution_type", "pixel_area")))
                    audit.append("dataset.scan", detail={"dir": full,
                                                         "scan_id": record["scan_id"]})
                    return self._json(record, 202)
                if path == "/api/datasets/plan/save":
                    result = datasets_svc.plan.save(body.get("datasets") or [])
                    audit.append("dataset.plan_save", detail=result)
                    return self._json(result, 201)
            except PermissionError as exc:
                return self._json({"error": str(exc)}, 403)
            except FileNotFoundError as exc:
                return self._json({"error": f"not found: {exc}"}, 404)
            except ValueError as exc:
                return self._json({"error": str(exc)}, 422)

            # ---- themes ---------------------------------------------------------------------
            match = re.match(r"^/api/themes/([\w-]+)$", path)
            if match:
                if users.auth_required and user["role"] != "admin":
                    return self._json({"error": "admin only"}, 403)
                try:
                    result = themes.save(match.group(1), body.get("theme") or body)
                except ValueError as exc:
                    return self._json({"error": str(exc)}, 422)
                audit.append("theme.save", detail=result)
                return self._json(result, 201)

            # ---- git config versioning ------------------------------------------------------
            if path.startswith("/api/git/"):
                from .git_integration import GitError as _GitError

                try:
                    if path == "/api/git/init":
                        result = git_repo.init(body.get("branch"))
                        audit.append("git.init", detail={"branch": body.get("branch")})
                        return self._json(result, 201)
                    if path == "/api/git/identity":
                        return self._json(git_repo.set_identity(
                            str(body.get("name") or ""), str(body.get("email") or "")))
                    if path == "/api/git/remote":
                        return self._json(git_repo.set_remote(str(body.get("url") or "")))
                    if path == "/api/git/snapshot":
                        result = git_repo.snapshot(body.get("message"), body.get("paths"))
                        audit.append("git.snapshot", detail=result)
                        return self._json(result, 201)
                    if path == "/api/git/revert":
                        result = git_repo.revert(str(body.get("path") or ""),
                                                 body.get("commit"))
                        audit.append("git.revert", detail=result)
                        return self._json(result)
                except _GitError as exc:
                    return self._json({"error": str(exc)}, 422)

            if path == "/api/auth/config":
                if users.auth_required and user["role"] != "admin":
                    return self._json({"error": "admin only"}, 403)
                try:
                    external_auth.configure(dict(body))
                except ExternalAuthError as exc:
                    return self._json({"error": str(exc)}, 422)
                audit.append("auth.configure",
                             detail={"providers": sorted(body.keys())})
                return self._json({"ok": True})

            return self._json({"error": "not found"}, 404)

        def _dataset_upload(self, path: str) -> None:
            """Multipart file upload / zip archive extraction into the
            datasets root (reference routes/datasets.py:640,673)."""
            length = int(self.headers.get("Content-Length", 0) or 0)
            max_bytes = int(os.environ.get("SIMPLETUNER_MAX_UPLOAD_MB", 512)) * 1024 * 1024
            if length <= 0:
                return self._json({"error": "empty body"}, 422)
            if length > max_bytes:
                return self._json({"error": f"upload exceeds {max_bytes} bytes"}, 413)
            raw = self.rfile.read(length)
            directory = self._query_param("dir") or ""
            ctype = self.headers.get("Content-Type", "")
            try:
                if path.endswith("/zip"):
                    if "multipart" in ctype:
                        parts = [p for p in parse_multipart(ctype, raw) if p[1]]
                        if not parts:
                            return self._json({"error": "no file part"}, 422)
                        raw = parts[0][2]
                    result = datasets_svc.save_zip(directory, raw)
                    audit.append("dataset.upload_zip", detail={"dir": directory,
                                                               "extracted": result["extracted"]})
                    return self._json(result, 201)
                if "multipart" not in ctype:
                    return self._json({"error": "multipart/form-data required"}, 422)
                uploaded = []
                for _field, filename, payload in parse_multipart(ctype, raw):
                    if not filename:
                        continue
                    uploaded.append(datasets_svc.save_upload(directory, filename, payload))
                if not uploaded:
                    return self._json({"error": "no file parts"}, 422)
                audit.append("dataset.upload", detail={"dir": directory,
                                                       "files": len(uploaded)})
                return self._json({"uploaded": uploaded}, 201)
            except PermissionError as exc:
                return self._json({"error": str(exc)}, 403)
            except ValueError as exc:
                return self._json({"error": str(exc)}, 422)

        # ---- PATCH ------------------------------------------------------------------------
        def do_PATCH(self):
            path = self.path.split("?")[0]
            try:
                body = self._read_body()
            except (ValueError, json.JSONDecodeError):
                return self._json({"error": "invalid json"}, 400)
            user = self._auth()
            if user is None:
                return
            if path == "/api/datasets/plan":
                try:
                    result = datasets_svc.plan.patch(body.get("dataset") or body)
                except ValueError as exc:
                    return self._json({"error": str(exc)}, 422)
                except Exception as exc:
                    return self._json({"error": str(exc)}, 422)
                audit.append("dataset.plan_patch", detail=result)
                return self._json(result)
            return self._json({"error": "not found"}, 404)

        # ---- DELETE -----------------------------------------------------------------------
        def do_DELETE(self):
            path = self.path.split("?")[0]
            user = self._auth()
            if user is None:
                return
            match = re.match(r"^/api/users/([\w.-]+)$", path)
            if match:
                if users.auth_required and user["role"] != "admin":
                    return self._json({"error": "admin only"}, 403)
                ok = users.delete_user(match.group(1))
                if ok:
                    audit.append("user.delete", detail={"username": match.group(1)})
                return self._json({"deleted": ok}, 200 if ok else 404)
            match = re.match(r"^/api/orgs/([\w-]+)/members/([\w.-]+)$", path)
            if match:
                name, member = match.groups()
                if not self._org_admin(user, name):
                    return self._json({"error": "org admin only"}, 403)
                try:
                    ok = orgs.remove_member(name, member)
                except ValueError as exc:
                    return self._json({"error": str(exc)}, 409)
                if ok:
                    audit.append("org.member_remove", detail={"org": name, "username": member})
                return self._json({"removed": ok}, 200 if ok else 404)
            match = re.match(r"^/api/orgs/([\w-]+)$", path)
            if match:
                if users.auth_required and user["role"] != "admin":
                    return self._json({"error": "admin only"}, 403)
                ok = orgs.delete_org(match.group(1))
                if ok:
                    audit.append("org.delete", detail={"name": match.group(1)})
                return self._json({"deleted": ok}, 200 if ok else 404)
            match = re.match(r"^/api/prompt-libraries/([\w.-]+)$", path)
            if match:
                ok = prompt_libraries.delete(match.group(1))
                if ok:
                    audit.append("prompt_library.delete", detail={"name": match.group(1)})
                return self._json({"deleted": ok}, 200 if ok else 404)
            match = re.match(r"^/api/datasets/plan/([\w.-]+)$", path)
            if match:
                result = datasets_svc.plan.delete(match.group(1))
                audit.append("dataset.plan_delete", detail=result)
                return self._json(result)
            return self._json({"error": "not found"}, 404)

        def _org_admin(self, user: Dict[str, Any], org_name: str) -> bool:
            """Site admins or org owner/admin may manage an org."""
            if not users.auth_required or user["role"] == "admin":
                return True
            return orgs.member_role(org_name, user["username"]) in ("owner", "admin")

    server = ThreadingHTTPServer((host, port), Handler)
    server.keeper = keeper  # type: ignore[attr-defined]
    server.sse = sse  # type: ignore[attr-defined]
    server.audit = audit  # type: ignore[attr-defined]
    server.orgs = orgs  # type: ignore[attr-defined]
    server.approvals = approvals  # type: ignore[attr-defined]
    server.notifications = notifications  # type: ignore[attr-defined]
    server.pricing = pricing  # type: ignore[attr-defined]
    server.run_queue = run_queue  # type: ignore[attr-defined]
    server.external_auth = external_auth  # type: ignore[attr-defined]
    server.datasets = datasets_svc  # type: ignore[attr-defined]
    server.themes = themes  # type: ignore[attr-defined]
    server.git_repo = git_repo  # type: ignore[attr-defined]
    return server


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser("simpletuner-tpu-torch server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8005)
    parser.add_argument("--device", default="cuda", help="torch device of every job the server spawns")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = create_server(args.host, args.port, device=args.device)
    logger.info("training API listening on %s:%d", args.host, args.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
