"""Platform CLI subcommands: users/orgs/quota/approvals/notifications/
pricing/webhooks/metrics/database/backup/audit/worker.

The torch port's copy of ``simpletuner_tpu/cli/platform.py``: the same behavior.

Reference: simpletuner/cli/__init__.py:105-715 — the reference CLI carries a
full platform tree (jobs approval, quota, notifications, webhooks, metrics,
database, backup, worker, auth/orgs/users/audit) next to the training
commands.  Each command here is a thin client over the training API server
(``--server`` / ``SIMPLETUNER_API_SERVER``, bearer token via ``--token`` /
``SIMPLETUNER_API_TOKEN``) or an operator tool over the local state dir
(database/backup/webhooks test-fire).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tarfile
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional


def _server(args) -> str:
    return args.server or os.environ.get("SIMPLETUNER_API_SERVER", "http://127.0.0.1:8005")


def _token(args) -> Optional[str]:
    return args.token or os.environ.get("SIMPLETUNER_API_TOKEN")


def _request(args, method: str, path: str, body: Optional[Dict[str, Any]] = None) -> Any:
    data = json.dumps(body).encode() if body is not None else None
    headers = {"Content-Type": "application/json"} if data else {}
    token = _token(args)
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(_server(args) + path, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as response:
            raw = response.read()
            return json.loads(raw) if raw else None
    except urllib.error.HTTPError as exc:
        detail = exc.read().decode(errors="replace")
        raise SystemExit(f"HTTP {exc.code} {path}: {detail}") from exc


def _print_json(obj: Any) -> None:
    print(json.dumps(obj, indent=2))


# ---- commands ---------------------------------------------------------------------------


def cmd_users(args, extra: List[str]) -> int:
    if args.action == "list":
        for user in _request(args, "GET", "/api/users"):
            quotas = user["quotas"]
            print(f"{user['username']:20s} {user['role']:6s} "
                  f"jobs≤{quotas.get('max_concurrent_jobs')} steps≤{quotas.get('max_total_steps')}")
    elif args.action == "create":
        result = _request(args, "POST", "/api/users", {
            "username": args.username,
            "role": args.role,
            "max_concurrent_jobs": args.max_concurrent_jobs,
            "max_total_steps": args.max_total_steps,
        })
        print(f"created {result['username']} role={result['role']}")
        print(f"token: {result['token']}")
    elif args.action == "delete":
        _print_json(_request(args, "DELETE", f"/api/users/{args.username}"))
    return 0


def cmd_orgs(args, extra: List[str]) -> int:
    if args.action == "list":
        for org in _request(args, "GET", "/api/orgs"):
            print(f"{org['name']:20s} members={len(org['members'])} "
                  f"approval={'yes' if org['require_approval'] else 'no'} "
                  f"spend=${org['usage'].get('spend_usd', 0):.2f}")
    elif args.action == "create":
        _print_json(_request(args, "POST", "/api/orgs", {
            "name": args.name, "owner": args.owner,
            "require_approval": args.require_approval,
            "max_concurrent_jobs": args.max_concurrent_jobs,
            "max_total_steps": args.max_total_steps,
            "monthly_budget_usd": args.monthly_budget_usd,
        }))
    elif args.action == "show":
        _print_json(_request(args, "GET", f"/api/orgs/{args.name}"))
    elif args.action == "delete":
        _print_json(_request(args, "DELETE", f"/api/orgs/{args.name}"))
    elif args.action == "add-member":
        _print_json(_request(args, "POST", f"/api/orgs/{args.name}/members",
                             {"username": args.username, "role": args.member_role}))
    elif args.action == "remove-member":
        _print_json(_request(args, "DELETE", f"/api/orgs/{args.name}/members/{args.username}"))
    elif args.action == "policy":
        body: Dict[str, Any] = {}
        if args.require_approval is not None:
            body["require_approval"] = args.require_approval
        quotas = {}
        if args.monthly_budget_usd is not None:
            quotas["monthly_budget_usd"] = args.monthly_budget_usd
        if args.max_total_steps is not None:
            quotas["max_total_steps"] = args.max_total_steps
        if quotas:
            body["quotas"] = quotas
        _print_json(_request(args, "POST", f"/api/orgs/{args.name}/policy", body))
    return 0


def cmd_quota(args, extra: List[str]) -> int:
    _print_json(_request(args, "GET", "/api/quota"))
    return 0


def cmd_approvals(args, extra: List[str]) -> int:
    if args.action == "list":
        path = "/api/approvals" + (f"?state={args.state}" if args.state else "")
        for record in _request(args, "GET", path):
            print(f"{record['approval_id']:14s} {record['state']:9s} "
                  f"owner={record['owner']:12s} prio={record['priority']} "
                  f"family={record['config'].get('model_family')}")
    elif args.action in ("approve", "reject"):
        result = _request(args, "POST", f"/api/approvals/{args.approval_id}/{args.action}",
                          {"reason": args.reason})
        _print_json(result)
    return 0


def cmd_notifications(args, extra: List[str]) -> int:
    if args.action == "list":
        path = "/api/notifications" + ("?unread=1" if args.unread else "")
        for record in _request(args, "GET", path):
            flag = " " if record["read"] else "*"
            stamp = time.strftime("%m-%d %H:%M", time.localtime(record["created_at"]))
            print(f"{flag} {stamp} [{record['kind']}] {record['title']}")
    elif args.action == "read":
        _print_json(_request(args, "POST", "/api/notifications/read",
                             {"id": args.id} if args.id else {}))
    elif args.action == "address":
        _print_json(_request(args, "POST", "/api/notifications/address",
                             {"email": args.email}))
    elif args.action == "smtp":
        _print_json(_request(args, "POST", "/api/notifications/smtp", {
            "host": args.host, "port": args.port, "from": args.sender,
            "starttls": args.starttls,
        }))
    return 0


def cmd_pricing(args, extra: List[str]) -> int:
    if args.action == "list":
        for accel, rate in sorted(_request(args, "GET", "/api/pricing").items()):
            print(f"{accel:8s} ${rate:.2f}/chip-hour")
    elif args.action == "set":
        _print_json(_request(args, "POST", "/api/pricing", {
            "accelerator_type": args.accelerator, "usd_per_chip_hour": args.rate}))
    elif args.action == "estimate":
        with open(args.config) as fh:
            config = json.load(fh)
        _print_json(_request(args, "POST", "/api/costs/estimate", {"config": config}))
    return 0


def cmd_webhooks(args, extra: List[str]) -> int:
    """Test-fire a webhook config (reference cli webhooks test)."""
    from ..webhooks.events import notification_event
    from ..webhooks.handler import WebhookConfig, WebhookHandler

    handler = WebhookHandler(WebhookConfig.load(args.config), job_id="webhook-test")
    if not handler.enabled:
        print("webhook config loaded but no endpoints enabled", file=sys.stderr)
        return 1
    handler.send_raw(notification_event(args.message, severity="info"))
    handler.flush()
    handler.close()
    print("test event sent")
    return 0


def cmd_metrics(args, extra: List[str]) -> int:
    req = urllib.request.Request(_server(args) + "/metrics")
    token = _token(args)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    with urllib.request.urlopen(req, timeout=30) as response:
        sys.stdout.write(response.read().decode())
    return 0


def cmd_audit(args, extra: List[str]) -> int:
    payload = _request(args, "GET", "/api/audit")
    status = "VERIFIED" if payload["verified"] else f"TAMPERED at seq {payload['first_bad_seq']}"
    print(f"audit chain: {status} ({len(payload['records'])} records)")
    if args.show:
        for record in payload["records"][-args.tail:]:
            stamp = time.strftime("%m-%d %H:%M:%S", time.localtime(record["time"]))
            print(f"{stamp} {record['action']:24s} {json.dumps(record.get('detail', {}))}")
    return payload["verified"] is not True


def cmd_database(args, extra: List[str]) -> int:
    """Local job-store maintenance over the platform state dir (reference
    cli database subcommands)."""
    from ..server.store import JobStore, default_state_dir

    state_dir = args.state_dir or default_state_dir()
    store = JobStore(state_dir)
    if args.action == "list":
        for record in store.history():
            print(f"{record['job_id']:14s} {record.get('state', '?'):11s} "
                  f"owner={record.get('owner')} created="
                  f"{time.strftime('%m-%d %H:%M', time.localtime(record.get('created_at', 0)))}")
    elif args.action == "show":
        record = store.records.get(args.job_id)
        if record is None:
            print(f"unknown job {args.job_id}", file=sys.stderr)
            return 1
        _print_json(record)
    elif args.action == "vacuum":
        cutoff = time.time() - args.keep_days * 86400
        removed = [jid for jid, rec in store.records.items()
                   if rec.get("state") in ("completed", "failed", "cancelled", "interrupted")
                   and rec.get("created_at", 0) < cutoff]
        for jid in removed:
            del store.records[jid]
        store._flush()
        print(f"removed {len(removed)} terminal job record(s) older than {args.keep_days}d")
    return 0


def cmd_backup(args, extra: List[str]) -> int:
    """Archive / restore the platform state dir (reference cli backup)."""
    from ..server.store import default_state_dir

    state_dir = args.state_dir or default_state_dir()
    if args.action == "create":
        target = args.file or time.strftime("simpletuner-state-%Y%m%d-%H%M%S.tar.gz")
        if not os.path.isdir(state_dir):
            print(f"no state dir at {state_dir}", file=sys.stderr)
            return 1
        with tarfile.open(target, "w:gz") as tar:
            tar.add(state_dir, arcname="simpletuner_state")
        print(f"wrote {target}")
    elif args.action == "restore":
        if not args.file or not os.path.exists(args.file):
            print("restore requires --file pointing at a backup archive", file=sys.stderr)
            return 2
        if os.path.isdir(state_dir) and os.listdir(state_dir) and not args.force:
            print(f"refusing to overwrite non-empty {state_dir} (use --force)", file=sys.stderr)
            return 1
        import shutil
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            with tarfile.open(args.file) as tar:
                tar.extractall(tmp, filter="data")
            source = os.path.join(tmp, "simpletuner_state")
            if not os.path.isdir(source):
                print("archive does not contain simpletuner_state/", file=sys.stderr)
                return 1
            os.makedirs(state_dir, exist_ok=True)
            for name in os.listdir(source):
                dest = os.path.join(state_dir, name)
                if os.path.isdir(dest):
                    shutil.rmtree(dest)
                elif os.path.exists(dest):
                    os.remove(dest)
                shutil.move(os.path.join(source, name), dest)
        print(f"restored into {state_dir}")
    return 0


def cmd_worker(args, extra: List[str]) -> int:
    from ..worker_agent import main as worker_main

    argv = ["--server", _server(args)]
    if args.name:
        argv += ["--worker-id", args.name]
    return worker_main(argv + extra)


def cmd_hardware(args, extra: List[str]) -> int:
    """Accelerator + host inventory (reference cli hardware / routes/hardware.py)."""
    if args.local:
        from ..server.extras import hardware_info

        info = hardware_info()
    else:
        info = _request(args, "GET", "/api/hardware")
    if args.json:
        _print_json(info)
        return 0
    print(f"backend: {info.get('backend', '?')}  processes: {info.get('process_count', 1)}")
    for dev in info.get("accelerators", []):
        mem = dev.get("memory") or {}
        used = mem.get("bytes_in_use")
        limit = mem.get("bytes_limit")
        hbm = f"  {used/1e9:.2f}/{limit/1e9:.2f} GB" if used is not None and limit else ""
        print(f"  [{dev['id']}] {dev['kind']} ({dev['platform']}){hbm}")
    host = info.get("host", {})
    if "mem_available_bytes" in host:
        print(f"host: {host['cpu_count']} cpus, "
              f"{host['mem_available_bytes']/1e9:.1f}/{host['mem_total_bytes']/1e9:.1f} GB free, "
              f"disk {host['disk']['free_bytes']/1e9:.1f} GB free")
    return 0


def cmd_checkpoints(args, extra: List[str]) -> int:
    """Checkpoint inventory for an output dir (reference routes/checkpoints.py)."""
    if args.local:
        from ..server.extras import list_checkpoints

        entries = list_checkpoints(args.output_dir)
    else:
        from urllib.parse import quote

        entries = _request(args, "GET", f"/api/checkpoints?output_dir={quote(args.output_dir)}")
    for e in entries:
        state = "complete" if e["complete"] else "PARTIAL"
        arts = ",".join(e["artifacts"]) if e["artifacts"] else "-"
        rolling = " rolling" if e["rolling"] else ""
        print(f"step {e['step']:>8d}{rolling}  {state:8s}  {arts}")
    if not entries:
        print(f"no checkpoints under {args.output_dir}", file=sys.stderr)
        return 1
    return 0


def cmd_prompt_libraries(args, extra: List[str]) -> int:
    if args.action == "list":
        for lib in _request(args, "GET", "/api/prompt-libraries"):
            print(f"{lib['name']:24s} {lib['prompts']} prompts")
    elif args.action == "show":
        _print_json(_request(args, "GET", f"/api/prompt-libraries/{args.name}"))
    elif args.action == "push":
        with open(args.file) as fh:
            library = json.load(fh)
        _print_json(_request(args, "POST", f"/api/prompt-libraries/{args.name}",
                             {"library": library}))
    elif args.action == "delete":
        _print_json(_request(args, "DELETE", f"/api/prompt-libraries/{args.name}"))
    return 0


def cmd_render(args, extra: List[str]) -> int:
    """Submit a checkpoint-inference render job to the server."""
    body: Dict[str, Any] = {
        "checkpoint": args.checkpoint, "prompt": args.prompt,
        "steps": args.steps, "seed": args.seed,
    }
    if args.resolution:
        body["resolution"] = args.resolution
    if args.config:
        body["config"] = args.config
    job = _request(args, "POST", "/api/inference/start", body)
    print(f"render job {job['job_id']} submitted (output: {job['output_dir']})")
    if not args.wait:
        return 0
    while True:
        info = _request(args, "GET", f"/api/training/status/{job['job_id']}")
        if info["state"] in ("completed", "failed", "cancelled"):
            print(f"render {info['state']}")
            return 0 if info["state"] == "completed" else 1
        time.sleep(2.0)


# ---- parser wiring ----------------------------------------------------------------------


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--server", default=None, help="API server (SIMPLETUNER_API_SERVER)")
    p.add_argument("--token", default=None, help="bearer token (SIMPLETUNER_API_TOKEN)")


def register(sub) -> None:
    p = sub.add_parser("users", help="manage server users")
    p.add_argument("action", choices=["list", "create", "delete"])
    p.add_argument("username", nargs="?", default=None)
    p.add_argument("--role", default="user", choices=["admin", "user"])
    p.add_argument("--max-concurrent-jobs", type=int, default=2)
    p.add_argument("--max-total-steps", type=int, default=None)
    _common(p)
    p.set_defaults(fn=cmd_users)

    p = sub.add_parser("orgs", help="manage organizations")
    p.add_argument("action", choices=["list", "create", "show", "delete",
                                      "add-member", "remove-member", "policy"])
    p.add_argument("name", nargs="?", default=None)
    p.add_argument("username", nargs="?", default=None)
    p.add_argument("--owner", default=None)
    p.add_argument("--member-role", default="member", choices=["owner", "admin", "member"])
    p.add_argument("--require-approval", action=argparse.BooleanOptionalAction, default=None)
    p.add_argument("--max-concurrent-jobs", type=int, default=None)
    p.add_argument("--max-total-steps", type=int, default=None)
    p.add_argument("--monthly-budget-usd", type=float, default=None)
    _common(p)
    p.set_defaults(fn=cmd_orgs)

    p = sub.add_parser("quota", help="show your quota + usage")
    _common(p)
    p.set_defaults(fn=cmd_quota)

    p = sub.add_parser("approvals", help="review pending job approvals")
    p.add_argument("action", choices=["list", "approve", "reject"])
    p.add_argument("approval_id", nargs="?", default=None)
    p.add_argument("--state", default=None, choices=["pending", "approved", "rejected"])
    p.add_argument("--reason", default=None)
    _common(p)
    p.set_defaults(fn=cmd_approvals)

    p = sub.add_parser("notifications", help="inbox + email settings")
    p.add_argument("action", choices=["list", "read", "address", "smtp"])
    p.add_argument("--unread", action="store_true")
    p.add_argument("--id", default=None)
    p.add_argument("--email", default=None)
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=25)
    p.add_argument("--sender", default="simpletuner@localhost")
    p.add_argument("--starttls", action="store_true")
    _common(p)
    p.set_defaults(fn=cmd_notifications)

    p = sub.add_parser("pricing", help="rates, overrides, cost estimates")
    p.add_argument("action", choices=["list", "set", "estimate"])
    p.add_argument("--accelerator", default=None)
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("--config", default=None, help="config.json for estimate")
    _common(p)
    p.set_defaults(fn=cmd_pricing)

    p = sub.add_parser("webhooks", help="test-fire a webhook config")
    p.add_argument("--config", required=True, help="webhook config json")
    p.add_argument("--message", default="simpletuner-tpu webhook test")
    p.set_defaults(fn=cmd_webhooks)

    p = sub.add_parser("metrics", help="fetch Prometheus metrics from the server")
    _common(p)
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("audit", help="verify + show the audit chain")
    p.add_argument("--show", action="store_true")
    p.add_argument("--tail", type=int, default=20)
    _common(p)
    p.set_defaults(fn=cmd_audit)

    p = sub.add_parser("database", help="local job-store maintenance")
    p.add_argument("action", choices=["list", "show", "vacuum"])
    p.add_argument("job_id", nargs="?", default=None)
    p.add_argument("--state-dir", default=None)
    p.add_argument("--keep-days", type=int, default=30)
    p.set_defaults(fn=cmd_database)

    p = sub.add_parser("backup", help="archive/restore the platform state dir")
    p.add_argument("action", choices=["create", "restore"])
    p.add_argument("--file", default=None)
    p.add_argument("--state-dir", default=None)
    p.add_argument("--force", action="store_true")
    p.set_defaults(fn=cmd_backup)

    p = sub.add_parser("worker", help="run a worker agent against a server")
    p.add_argument("--name", default=None)
    _common(p)
    p.set_defaults(fn=cmd_worker)

    p = sub.add_parser("hardware", help="accelerator + host inventory")
    p.add_argument("--local", action="store_true", help="inspect this machine instead of the server")
    p.add_argument("--json", action="store_true")
    _common(p)
    p.set_defaults(fn=cmd_hardware)

    p = sub.add_parser("checkpoints", help="checkpoint inventory for an output dir")
    p.add_argument("output_dir")
    p.add_argument("--local", action="store_true", help="scan the local filesystem directly")
    _common(p)
    p.set_defaults(fn=cmd_checkpoints)

    p = sub.add_parser("prompt-libraries", help="named validation prompt libraries")
    p.add_argument("action", choices=["list", "show", "push", "delete"])
    p.add_argument("name", nargs="?", default=None)
    p.add_argument("--file", default=None, help="JSON {shortname: prompt} file for push")
    _common(p)
    p.set_defaults(fn=cmd_prompt_libraries)

    p = sub.add_parser("render", help="render prompts from a checkpoint via the server")
    p.add_argument("checkpoint")
    p.add_argument("prompt")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resolution", type=int, default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--wait", action="store_true")
    _common(p)
    p.set_defaults(fn=cmd_render)
