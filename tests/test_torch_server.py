"""The port's training server against the JAX package's, on the CPU.

Each server runs in this process on its own ephemeral port and state dir
(the port's with ``device="cpu"``, so every job it spawns trains on the
CPU).  The request sequences of the JAX server tests (``test_server*.py``,
``test_platform*.py``, ``test_cli_platform.py``) go to both, and the JSON
responses must be equal once ids, tokens, times and each server's state dir
are normalised.  Routes that differ by design are named in ``DIFFERS`` and
checked for what the port answers instead: ``/api/optimizers`` (the port's
registry), ``/api/version`` and ``/api/system`` (torch, CUDA and the card),
``/api/hardware`` (the ``torch.cuda`` devices), ``/api/models/<f>/presets``
(the port's presets: ``sd3``'s, ``sdxl``'s, ``sd1x``'s, ``sd2x``'s and
``pixart_sigma``'s are the JAX ones without the mesh preset; 501 for a family
it does not train) and a job's logs
(the spawned command: ``python -m simpletuner_tpu_torch.train --config ...
--device cpu``).  On the port's server alone: a tiny-Flux job completes and
its LoRA is bitwise the one an in-process ``Trainer`` trains from the same
config; a ``deepfloyd`` job fails with a log line naming ROADMAP Queue 1 item 6;
a running job takes a checkpoint signal and is cancelled.
"""

import base64
import copy
import hashlib
import hmac
import http.client
import io
import json
import os
import re
import threading
import time
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from simpletuner_tpu.cli import configure_tui as jax_configure_tui
from simpletuner_tpu.cli import main as jax_cli
from simpletuner_tpu.server.app import create_server as jax_create_server

from simpletuner_tpu_torch.cli import main as port_cli
from simpletuner_tpu_torch.server.app import create_server

from test_torch_trainer import _seeded, _values, _write_images

# run-dependent values (ids, tokens, wall-clock times); "timestamp" is a git
# commit's time in whole seconds (``/api/git/history``), which differs between
# the two servers when their commits fall on either side of a second
VOLATILE = {"job_id", "approval_id", "token", "time", "mtime", "id", "scan_id", "hash", "prev_hash", "pid",
            "uptime_seconds", "commit", "sha", "workdir", "cost_usd", "fair_share_usage_seconds", "timestamp"}
# the JAX LyCORIS table as imported, before any test runs: a builder's module
# override writes into it (``LycorisBuilder`` copies a preset shallowly), so a
# JAX test that ran earlier in this process may have changed the live table
JAX_LYCORIS = copy.deepcopy(jax_configure_tui.LYCORIS_ALGORITHMS)
# the routes whose answers differ by design (checked on their own below)
DIFFERS = ("/api/optimizers", "/api/version", "/api/system", "/api/hardware", "/api/models/flux/presets",
           "/api/models/sd3/presets", "/api/models/sdxl/presets", "/api/models/sd1x/presets",
           "/api/models/sd2x/presets", "/api/models/pixart_sigma/presets", "/api/training/logs/<id>")


def _start(factory, state, **kwargs):
    srv = factory("127.0.0.1", 0, state_dir=str(state), **kwargs)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv


def _stop(srv):
    for job in list(srv.keeper.jobs.values()):
        if job.process is not None and job.process.poll() is None:
            job.process.kill()
            job.process.wait()
    srv.run_queue.close()
    srv.shutdown()
    srv.server_close()


def _http(port, method, path, body=None, token=None, raw=None, content_type=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    headers = {}
    if raw is not None:
        payload = raw
        headers["Content-Type"] = content_type or "application/octet-stream"
    else:
        payload = json.dumps(body) if body is not None else None
        if payload:
            headers["Content-Type"] = "application/json"
    if token:
        headers["Authorization"] = f"Bearer {token}"
    conn.request(method, path, body=payload, headers=headers)
    response = conn.getresponse()
    data = response.read()
    conn.close()
    try:
        return response.status, json.loads(data or b"null")
    except ValueError:
        return response.status, data


class Pair:
    """The two servers, a request sent to both, and the answers compared."""

    def __init__(self, tmp_path):
        # state dirs of one length: files that hold their paths have equal sizes
        self.states = {"jax": tmp_path / "j" / "state", "port": tmp_path / "p" / "state"}
        self.servers = {"jax": _start(jax_create_server, self.states["jax"]),
                        "port": _start(create_server, self.states["port"], device="cpu")}
        self.names = {"jax": {}, "port": {}}  # per side: placeholder -> value (tokens, ids)

    def close(self):
        for srv in self.servers.values():
            _stop(srv)

    def port(self, side):
        return self.servers[side].server_address[1]

    def _fill(self, side, value):
        if isinstance(value, str):
            for name, real in self.names[side].items():
                value = value.replace("{" + name + "}", str(real))
            return value.replace("{state}", str(self.states[side]))
        if isinstance(value, dict):
            return {k: self._fill(side, v) for k, v in value.items()}
        if isinstance(value, list):
            return [self._fill(side, v) for v in value]
        return value

    def _normalise(self, side, value):
        if isinstance(value, dict):
            return {k: "<v>" if (k in VOLATILE or k.endswith("_at")) and v is not None else self._normalise(side, v)
                    for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return [self._normalise(side, v) for v in value]
        if isinstance(value, str):
            value = value.replace(str(self.states[side]), "<state>")
            # a job's output dir is named by the second it started in
            value = re.sub(r"<state>/inference/\d{8}-\d{6}", "<state>/inference/<time>", value)
            for name, real in self.names[side].items():
                value = value.replace(str(real), "<" + name + ">")
            return value
        if isinstance(value, bytes):
            return self._normalise(side, value.decode(errors="replace"))
        return value

    def both(self, method, path, body=None, token=None, raw=None, content_type=None, compare=True):
        answers = {}
        for side in ("jax", "port"):
            answers[side] = _http(self.port(side), method, self._fill(side, path), self._fill(side, body),
                                  self.names[side].get(token) if token else None, raw, content_type)
        if compare:
            assert not any(path.startswith(route.replace("<id>", "")) for route in DIFFERS), path
            ours, theirs = (self._normalise(s, answers[s]) for s in ("port", "jax"))
            assert ours == theirs, (method, path)
        return answers

    def keep(self, name, answers, key):
        for side in ("jax", "port"):
            self.names[side][name] = answers[side][1][key]

    def wait(self, job, token=None, states=("completed", "failed", "cancelled"), timeout=120):
        deadline = time.time() + timeout
        while time.time() < deadline:
            answers = self.both("GET", "/api/training/status/{" + job + "}", token=token, compare=False)
            if all(a[1]["state"] in states and a[1]["finished_at"] for a in answers.values()):
                time.sleep(0.3)  # the finished event's listeners run just after finished_at is set
                return self.both("GET", "/api/training/status/{" + job + "}", token=token)
            time.sleep(0.5)
        raise AssertionError(f"job {job} did not finish")


@pytest.fixture()
def pair(tmp_path):
    servers = Pair(tmp_path)
    yield servers
    servers.close()


def _png_bytes(seed=0, size=64):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def _multipart(files):
    boundary = "stboundary42"
    out = io.BytesIO()
    for filename, payload in files:
        out.write(f"--{boundary}\r\n".encode())
        out.write(f'Content-Disposition: form-data; name="file"; filename="{filename}"\r\n'
                  "Content-Type: application/octet-stream\r\n\r\n".encode())
        out.write(payload)
        out.write(b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return f"multipart/form-data; boundary={boundary}", out.getvalue()


def _hs256(claims, secret):
    def b64(data):
        return base64.urlsafe_b64encode(data).rstrip(b"=").decode()

    head = b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = b64(json.dumps(claims).encode())
    signature = hmac.new(secret.encode(), f"{head}.{body}".encode(), hashlib.sha256).digest()
    return f"{head}.{body}.{b64(signature)}"


# ---- the JAX request sequences, sent to both servers ---------------------------------------------


def test_basic_routes_and_a_failing_job(pair):
    """test_server.py: health, listings, config validation, a failing job, 404s, events, UI, metrics, audit."""
    pair.both("GET", "/api/models")
    pair.both("GET", "/api/fields")
    ok = {"config": {"model_family": "flux", "optimizer": "adamw", "learning_rate": 1e-4, "max_train_steps": 10}}
    assert pair.both("POST", "/api/config/validate", ok)["port"] == (200, {"valid": True})
    bad = {"config": {**ok["config"], "optimizer": "nope"}}
    assert pair.both("POST", "/api/config/validate", bad)["port"][0] == 422
    job = pair.both("POST", "/api/training/start",
                    {"config": {"model_family": "definitely-not-a-model", "optimizer": "adamw",
                                "learning_rate": 1e-4, "max_train_steps": 1}})
    assert job["port"][0] == 201
    pair.keep("job", job, "job_id")
    status = pair.wait("job")
    assert status["port"][1]["state"] == "failed" and status["port"][1]["return_code"] not in (0, None)
    pair.both("GET", "/api/training/jobs")
    assert pair.both("POST", "/api/training/start", {"config": {}})["port"][0] == 422
    assert pair.both("GET", "/api/training/status/nope")["port"][0] == 404
    pair.both("POST", "/api/events/callback", {"event_type": "training_status", "global_step": 5})
    for path in ("/", "/static/app.js", "/static/style.css", "/static/../app.py"):
        pair.both("GET", path)
    pair.both("GET", "/metrics")
    # this job fails too; the queue is read once it has ended on both sides
    # (read while one side's job still ran, slots_free differed: 1 against 0)
    pair.keep("job2", pair.both("POST", "/api/training/start",
                                {"config": {"model_family": "flux", "max_train_steps": 1}}), "job_id")
    pair.wait("job2")
    pair.both("GET", "/api/audit")
    pair.both("GET", "/api/queue")


def test_auth_quota_orgs_and_approvals(pair):
    """test_server_auth.py and test_platform_services.py: bearer auth, quotas, orgs, approvals, notifications."""
    pair.both("GET", "/api/models")
    pair.keep("root", pair.both("POST", "/api/users", {"username": "root"}), "token")
    assert pair.both("GET", "/api/models")["port"][0] == 401
    pair.both("GET", "/health")
    pair.keep("alice", pair.both("POST", "/api/users", {"username": "alice", "max_concurrent_jobs": 1,
                                                        "max_total_steps": 5}, token="root"), "token")
    assert pair.both("POST", "/api/users", {"username": "bob"}, token="alice")["port"][0] == 403
    pair.both("GET", "/api/users", token="alice")
    pair.both("GET", "/api/users", token="root")
    config = {"model_family": "flux", "model_type": "lora", "max_train_steps": 10, "model_arch_preset": "tiny"}
    assert pair.both("POST", "/api/training/start", {"config": config}, token="alice")["port"][0] == 429
    job = pair.both("POST", "/api/training/start", {"config": {**config, "max_train_steps": 3}}, token="alice")
    pair.keep("job", job, "job_id")
    pair.both("GET", "/api/quota", token="alice")
    assert pair.both("POST", "/api/training/start", {"config": {**config, "max_train_steps": 3}},
                     token="alice")["port"][0] == 429
    # the tiny job has no dataset and fails on its own within seconds: wait for
    # that on both sides before the cancel, which would otherwise race it (a
    # SIGTERM on one side against an exit code of 1 on the other)
    pair.wait("job", token="alice", states=("failed",))
    pair.both("POST", "/api/training/cancel/{job}", {}, token="alice")
    pair.wait("job", token="alice")  # its notification lands before the next listing on both sides
    # an org with an approval policy
    pair.both("POST", "/api/orgs", {"name": "research", "require_approval": True, "monthly_budget_usd": 100.0},
              token="root")
    pair.both("POST", "/api/orgs/research/members", {"username": "alice"}, token="root")
    pair.both("GET", "/api/orgs", token="root")
    gated = {"model_family": "definitely-not-a-model", "max_train_steps": 1}
    pair.keep("approval", pair.both("POST", "/api/training/start", {"config": gated}, token="alice"), "approval_id")
    assert pair.both("POST", "/api/approvals/{approval}/approve", {}, token="alice")["port"][0] == 403
    pair.both("GET", "/api/approvals?state=pending", token="root")
    record = pair.both("POST", "/api/approvals/{approval}/approve", {}, token="root")
    pair.keep("approved_job", record, "job_id")
    pair.both("GET", "/api/training/status/{approved_job}", token="root", compare=False)
    assert pair.both("POST", "/api/approvals/{approval}/reject", {}, token="root")["port"][0] == 409
    pair.both("POST", "/api/training/cancel/{approved_job}", {}, token="root")
    pair.wait("approved_job", token="root")
    pair.both("GET", "/api/notifications", token="alice")
    pair.keep("approval2", pair.both("POST", "/api/training/start", {"config": gated}, token="alice"),
              "approval_id")
    pair.both("POST", "/api/approvals/{approval2}/reject", {"reason": "budget"}, token="root")
    pair.both("GET", "/api/notifications?unread=1", token="alice")
    pair.both("POST", "/api/notifications/read", {}, token="alice")
    # org quota and member management
    pair.keep("bob", pair.both("POST", "/api/users", {"username": "bob"}, token="root"), "token")
    pair.both("POST", "/api/orgs", {"name": "capped", "max_total_steps": 5, "owner": "bob"}, token="root")
    pair.both("POST", "/api/training/start", {"config": {"model_family": "flux", "max_train_steps": 50}}, token="bob")
    pair.both("DELETE", "/api/orgs/capped/members/bob", token="root")
    pair.both("POST", "/api/orgs/capped/members", {"username": "root", "role": "admin"}, token="root")
    pair.both("DELETE", "/api/orgs/capped", token="root")
    # pricing
    pair.both("GET", "/api/pricing", token="root")
    estimate = {"model_family": "flux", "max_train_steps": 3600, "estimated_step_seconds": 1.0, "num_chips": 8,
                "accelerator_type": "v5e"}
    pair.both("POST", "/api/costs/estimate", {"config": estimate}, token="root")
    pair.both("POST", "/api/costs/estimate", {"config": {**estimate, "accelerator_type": "h100"}}, token="root")
    pair.both("POST", "/api/pricing", {"accelerator_type": "v5e", "usd_per_chip_hour": 2.0}, token="root")
    # external auth: OIDC (HS256) and the file-backed directory
    oidc = {"issuer": "https://idp.test", "audience": "simpletuner", "hs256_secret": "s3cret",
            "admin_groups": ["admins"]}
    pair.both("POST", "/api/auth/config", {"oidc": oidc}, token="root")
    claims = {"iss": "https://idp.test", "aud": "simpletuner", "exp": time.time() + 300,
              "preferred_username": "carol", "email": "carol@example.com", "groups": ["admins"]}
    pair.both("POST", "/api/auth/oidc", {"id_token": _hs256(claims, "s3cret")})
    pair.both("POST", "/api/auth/oidc", {"id_token": _hs256({**claims, "exp": time.time() - 10}, "s3cret")})
    pair.both("POST", "/api/auth/oidc", {"id_token": _hs256(claims, "other")})
    pair.both("GET", "/api/audit", token="root")


def test_configs_extras_datasets_themes_and_git(pair, tmp_path, monkeypatch):
    """test_platform.py, test_server_extras.py and test_server_platform.py."""
    monkeypatch.setattr(jax_configure_tui, "LYCORIS_ALGORITHMS", JAX_LYCORIS)
    pair.both("POST", "/api/configs/demo", {"config": {"model_family": "flux"}})
    pair.both("POST", "/api/configs/demo", {"config": {"model_family": "sdxl"}})
    for path in ("/api/configs", "/api/configs/demo", "/api/configs/demo?version=1", "/api/configs/demo/versions"):
        pair.both("GET", path)
    plan = [{"id": "train", "type": "local", "dataset_type": "image", "instance_data_dir": "/data"},
            {"id": "embeds", "type": "local", "dataset_type": "text_embeds", "default": True}]
    pair.both("POST", "/api/datasets/plan", {"config": plan})
    # checkpoints inventory
    out = tmp_path / "out"
    (out / "checkpoint-2").mkdir(parents=True)
    (out / "checkpoint-2" / ".checkpoint_complete").write_text("")
    (out / "checkpoint-2" / "pytorch_lora_weights.safetensors").write_bytes(b"x")
    (out / "rolling-checkpoint-3").mkdir()
    pair.both("GET", f"/api/checkpoints?output_dir={out}")
    pair.both("GET", "/api/checkpoints")
    # prompt libraries
    pair.both("POST", "/api/prompt-libraries/portraits", {"library": {"prompts": ["a", "b"]}})
    pair.both("GET", "/api/prompt-libraries")
    pair.both("GET", "/api/prompt-libraries/portraits")
    pair.both("POST", "/api/prompt-libraries/bad", {"library": {}})
    pair.both("DELETE", "/api/prompt-libraries/portraits")
    pair.both("GET", "/api/prompt-libraries/portraits")
    pair.both("GET", "/api/lycoris/presets")
    # the dataset viewer
    data_dir = tmp_path / "ds"
    data_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(data_dir / f"img_{i}.png")
        (data_dir / f"img_{i}.txt").write_text(f"caption {i}")
    pair.both("GET", f"/api/datasets/viewer?dir={data_dir}&limit=2&thumbnails=1")
    pair.both("GET", f"/api/datasets/viewer?dir={data_dir}&offset=2&limit=2")
    pair.both("GET", "/api/datasets/viewer?dir=/nope/nothing")
    # a webhook test-fired at each server's own callback route
    answers = {side: _http(pair.port(side), "POST", "/api/webhooks/test",
                           {"url": f"http://127.0.0.1:{pair.port(side)}/api/events/callback", "message": "hello"})
               for side in ("jax", "port")}
    assert answers["port"][0] == answers["jax"][0] == 200
    pair.both("POST", "/api/webhooks/test", {})
    # dataset management
    pair.both("POST", "/api/datasets/folders", {"name": "myset"})
    pair.both("GET", "/api/datasets/browse")
    ctype, body = _multipart([("a.png", _png_bytes(1)), ("b.png", _png_bytes(2)), ("a.txt", b"a caption")])
    pair.both("POST", "/api/datasets/upload?dir=myset", raw=body, content_type=ctype)
    pair.both("GET", "/api/datasets/detect?path=myset")
    pair.both("GET", "/api/datasets/captions/status?path=myset")
    pair.both("POST", "/api/datasets/captions", {"path": "myset", "file": "b.png", "text": "second"})
    pair.both("GET", "/api/datasets/captions/get?path=myset&file=b.png")
    ctype, body = _multipart([("../evil.png", _png_bytes(3))])
    pair.both("POST", "/api/datasets/upload?dir=myset", raw=body, content_type=ctype)
    archive = io.BytesIO()
    with zipfile.ZipFile(archive, "w") as zf:
        zf.writestr("x.png", _png_bytes(4))
        zf.writestr("x.txt", "zipped")
    pair.both("POST", "/api/datasets/upload/zip?dir=zipset", raw=archive.getvalue(), content_type="application/zip")
    pair.both("GET", "/api/datasets/browse?path=../../etc")
    scan = pair.both("POST", "/api/datasets/scan", {"dir": "myset", "resolution": 64})
    pair.keep("scan", scan, "scan_id")
    deadline = time.time() + 60
    while time.time() < deadline:
        states = pair.both("GET", "/api/datasets/scan/status?scan_id={scan}", compare=False)
        if all(a[1]["state"] != "running" for a in states.values()):
            break
        time.sleep(0.2)
    pair.both("GET", "/api/datasets/scan/status?scan_id={scan}")
    _compare_viewer_summary(pair, "myset")
    datasets = [{"id": "train", "type": "local", "dataset_type": "image", "instance_data_dir": "/data"},
                {"id": "embeds", "type": "local", "dataset_type": "text_embeds", "default": True}]
    pair.both("POST", "/api/datasets/plan/save", {"datasets": datasets})
    pair.both("GET", "/api/datasets/plan")
    pair.both("PATCH", "/api/datasets/plan", {"dataset": {**datasets[0], "resolution": 512}})
    pair.both("DELETE", "/api/datasets/plan/embeds")
    pair.both("GET", "/api/datasets/plan")
    # themes
    for path in ("/api/themes", "/api/themes/dark", "/api/themes/dark/theme.css", "/api/themes/nope"):
        pair.both("GET", path)
    pair.both("POST", "/api/themes/corp", {"name": "Corp", "variables": {"--accent": "#123456"}})
    pair.both("POST", "/api/themes/dark", {"variables": {}})
    pair.both("GET", "/api/themes")
    # git config versioning
    pair.both("GET", "/api/git/status")
    pair.both("POST", "/api/git/init", {})
    pair.both("POST", "/api/git/identity", {"name": "T", "email": "t@example.com"})
    pair.both("POST", "/api/configs/run1", {"config": {"model_family": "flux", "learning_rate": 1e-4}})
    pair.both("POST", "/api/git/snapshot", {"message": "first"})
    pair.both("GET", "/api/git/history")
    pair.both("POST", "/api/inference/start", {"prompt": "x"})


def _folder_bytes(folder):
    return sum(os.path.getsize(os.path.join(base, name)) for base, _, names in os.walk(folder) for name in names)


def _compare_viewer_summary(pair, name):
    """``total_bytes`` sums every file of the folder, the scan's
    ``.st_buckets.json`` too, whose ``updated_at`` is ``time.time()`` written
    as its shortest repr: one digit more or less from run to run.  So each
    side's ``total_bytes`` is held exactly to its own folder, and the two
    answers, each with its bucket cache's size taken off, are compared whole."""
    answers = pair.both("GET", f"/api/datasets/viewer/summary?path={name}", compare=False)
    for side, (status, summary) in answers.items():
        folder = pair.states[side] / "datasets" / name
        assert status == 200 and summary["total_bytes"] == _folder_bytes(folder), side
        summary["total_bytes"] -= os.path.getsize(folder / ".st_buckets.json")
    assert pair._normalise("port", answers["port"]) == pair._normalise("jax", answers["jax"])


def test_viewer_summary_bytes_follow_the_bucket_cache_timestamp(tmp_path, monkeypatch):
    """The run-dependent part of the viewer summary: the scan's bucket cache
    written at two times whose shortest reprs differ in length gives
    ``total_bytes`` that differ by exactly that length, in both packages."""
    import importlib

    stamps = (1792238038.25, 1792238038.2251427)  # reprs of 13 and 18 characters
    for package in ("simpletuner_tpu", "simpletuner_tpu_torch"):
        local = importlib.import_module(f"{package}.data.backends.local")
        buckets = importlib.import_module(f"{package}.data.buckets")
        metadata = importlib.import_module(f"{package}.data.metadata")
        service = importlib.import_module(f"{package}.server.datasets").DatasetService(str(tmp_path / package))
        folder = os.path.join(service.root, "set")
        os.makedirs(folder)
        for i in range(2):
            with open(os.path.join(folder, f"img_{i}.png"), "wb") as handle:
                handle.write(_png_bytes(i))
        sizes = []
        for stamp in stamps:  # what ScanRunner.start's thread runs, at a fixed time
            meta = metadata.MetadataBackend(
                "scan", local.LocalDataBackend("scan", instance_data_dir=folder),
                buckets.BucketConfig(resolution=64, resolution_type="pixel_area"), instance_data_dir=folder,
                cache_file=os.path.join(folder, ".st_buckets.json"),
                metadata_file=os.path.join(folder, ".st_metadata.json"))
            meta.discover()
            monkeypatch.setattr(metadata.time, "time", lambda stamp=stamp: stamp)
            meta.save_cache()
            monkeypatch.undo()
            sizes.append(service.summary("set")["total_bytes"])
        assert sizes[1] - sizes[0] == len(repr(stamps[1])) - len(repr(stamps[0])) == 5, package


def test_cli_platform_commands_against_both_servers(pair, capsys):
    """test_cli_platform.py: the platform CLI of each package against its server; same output once normalised."""
    outputs = {}
    for side, cli in (("jax", jax_cli), ("port", port_cli)):
        url = f"http://127.0.0.1:{pair.port(side)}"
        assert cli(["users", "create", "root", "--role", "admin", "--server", url]) == 0
        token = capsys.readouterr().out.split("token:")[1].strip()
        common = ["--server", url, f"--token={token}"]  # a minted token may start with "-"
        lines = []
        for argv in (["users", "create", "alice"], ["users", "list"], ["quota"],
                     ["orgs", "create", "lab", "--owner", "alice", "--require-approval"], ["orgs", "list"],
                     ["orgs", "add-member", "lab", "root", "--member-role", "admin"], ["orgs", "show", "lab"],
                     ["pricing", "list"], ["pricing", "set", "--accelerator", "v5e", "--rate", "9.99"], ["metrics"],
                     ["approvals", "list", "--state", "pending"], ["audit"]):
            assert cli(argv + common) == 0, argv
            out = capsys.readouterr().out.replace(token, "<token>").replace(url, "<url>")
            lines.append(re.sub(r"token: \S+", "token: <token>", out))
        outputs[side] = lines
    assert outputs["port"] == outputs["jax"]


def test_cli_takes_a_token_that_starts_with_a_dash(pair, capsys, monkeypatch):
    """``secrets.token_urlsafe`` starts one token in 64 with "-": both
    servers mint such a token (the minting monkeypatched in both
    ``server/accounts.py`` modules), argparse reads the split ``--token <t>``
    as an option and exits 2 in both CLIs, and the ``--token=<t>`` form gives
    both servers the same output."""
    import importlib

    token = "-dAsH_token_0123456789abcdefABCDEF"
    for package in ("simpletuner_tpu", "simpletuner_tpu_torch"):
        accounts = importlib.import_module(f"{package}.server.accounts")
        monkeypatch.setattr(accounts.secrets, "token_urlsafe", lambda nbytes=None: token)
    outputs = {}
    for side, cli in (("jax", jax_cli), ("port", port_cli)):
        url = f"http://127.0.0.1:{pair.port(side)}"
        assert cli(["users", "create", "root", "--role", "admin", "--server", url]) == 0
        assert capsys.readouterr().out.split("token:")[1].strip() == token
        with pytest.raises(SystemExit) as split:
            cli(["quota", "--server", url, "--token", token])
        assert split.value.code == 2 and "--token: expected one argument" in capsys.readouterr().err
        lines = []
        for argv in (["quota"], ["users", "list"], ["orgs", "list"], ["audit"]):
            assert cli(argv + ["--server", url, f"--token={token}"]) == 0, argv
            lines.append(capsys.readouterr().out.replace(url, "<url>"))
        outputs[side] = lines
    assert outputs["port"] == outputs["jax"] and "root" in outputs["port"][1]


def test_routes_that_differ_by_design(pair):
    answers = pair.both("GET", "/api/optimizers", compare=False)
    from simpletuner_tpu_torch.training.optimizers import optimizer_names

    assert answers["port"] == (200, list(optimizer_names())) and "prodigy" in answers["jax"][1]
    version = pair.both("GET", "/api/version", compare=False)["port"][1]
    assert version["torch"] == torch.__version__ and version["cuda"] == torch.version.cuda
    hardware = pair.both("GET", "/api/hardware", compare=False)["port"][1]
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert hardware["device_count"] == len(hardware["accelerators"]) == count
    assert hardware["backend"] == ("cuda" if count else "cpu")
    system = pair.both("GET", "/api/system", compare=False)["port"][1]
    assert system["version"] == version and system["state_dir"] == str(pair.states["port"])
    presets = pair.both("GET", "/api/models/flux/presets", compare=False)
    assert presets["port"][0] == 200 and [p["name"] for p in presets["port"][1]] == ["speed", "balanced", "memory"]
    sd3 = pair.both("GET", "/api/models/sd3/presets", compare=False)
    assert sd3["port"][0] == sd3["jax"][0] == 200
    jax_presets = [(p["name"], p["config"]) for p in sd3["jax"][1] if p["name"] != "multichip"]  # a mesh: item 5
    assert [(p["name"], p["config"]) for p in sd3["port"][1]] == jax_presets and len(jax_presets) == 3
    # chroma and longcat_image answer with Flux's presets (the JAX Flux adds a TPU v5e one)
    for family in ("chroma", "longcat_image"):
        assert pair.both("GET", f"/api/models/{family}/presets", compare=False)["port"] == presets["port"], family
    for family in ("sdxl", "sd1x", "sd2x", "pixart_sigma", "auraflow", "wan", "ltxvideo", "lumina2",
                   "kandinsky5_image", "kandinsky5_video", "hunyuanvideo", "qwen_image", "mageflow", "z_image",
                   "hidream", "flux2", "kolors", "z_image_omni", "zlab_i1", "boogu_image", "krea2", "cosmos", "anima",
                   "omnigen", "ernie", "ideogram", "longcat_video", "sana", "sanavideo", "cosmos3", "ltxvideo2",
                   "ace_step", "wan_s2v"):
        answers = pair.both("GET", f"/api/models/{family}/presets", compare=False)
        assert answers["port"][0] == answers["jax"][0] == 200
        assert [(p["name"], p["config"]) for p in answers["port"][1]] == [
            (p["name"], p["config"]) for p in answers["jax"][1] if p["name"] != "multichip"], family
    assert pair.both("GET", "/api/models/deepfloyd/presets", compare=False)["port"] == (
        501, {"error": "model_family='deepfloyd' is not ported (only flux, sd3, sdxl, sd1x, sd2x, pixart_sigma, "
                       "auraflow, wan, ltxvideo, chroma, lumina2, kandinsky5_image, kandinsky5_video, "
                       "hunyuanvideo, qwen_image, mageflow, z_image, hidream, flux2, kolors, longcat_image, "
                       "z_image_omni, zlab_i1, boogu_image, krea2, cosmos, anima, omnigen, ernie, ideogram, "
                       "longcat_video, sana, sanavideo, cosmos3, ltxvideo2, ace_step, wan_s2v; ROADMAP Queue 1 "
                       "item 6)"})
    pair.both("GET", "/api/models/nope/presets")  # unknown: 404 on both
    job = pair.both("POST", "/api/inference/start",
                    {"checkpoint": "/nope/checkpoint-1", "prompt": "a cat", "steps": 1})
    assert job["port"][1]["kind"] == "inference"
    keeper_job = pair.servers["port"].keeper.get_job(job["port"][1]["job_id"])
    assert keeper_job.argv[1:4] == ["-m", "simpletuner_tpu_torch.cli", "inference"]
    assert keeper_job.argv[-2:] == ["--device", "cpu"]
    info = _wait(pair.port("port"), job["port"][1]["job_id"])  # a bogus checkpoint: the child fails fast
    assert info["state"] == "failed" and info["return_code"] != 0


# ---- the port's server alone: real jobs -----------------------------------------------------------


@pytest.fixture()
def port_server(tmp_path):
    srv = _start(create_server, tmp_path / "state", device="cpu")
    yield srv, srv.server_address[1]
    _stop(srv)


def _wait(port, job_id, timeout=180):
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, info = _http(port, "GET", f"/api/training/status/{job_id}")
        if info["state"] in ("completed", "failed", "cancelled"):
            return info
        time.sleep(0.3)
    raise AssertionError(f"job {job_id} did not finish")


def _seed_text_cache(root, captions):
    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend

    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "flux")
    rng = np.random.default_rng(5)
    for caption in captions:
        cache.save(caption, {"t5_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                             "pooled_embeds": rng.standard_normal(32).astype(np.float32),
                             "attention_mask": (np.arange(16) < 4).astype(np.int32)})


def test_a_tiny_flux_job_trains_the_in_process_lora(port_server, tmp_path):
    """The job the server spawns (``--device cpu``) and an in-process
    ``Trainer`` of the same config write the same LoRA, bitwise; the text
    cache is seeded, as the tiny tokenizer hashes words per process."""
    from simpletuner_tpu_torch.models.checkpoint_layouts import flux_checkpoint_shapes
    from simpletuner_tpu_torch.models.flux import Flux
    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.weight_import import load_safetensors_file, save_safetensors
    from simpletuner_tpu_torch.training.trainer import Trainer

    srv, port = port_server
    _write_images(tmp_path / "data")
    _seed_text_cache(tmp_path, [f"photo {i}" for i in range(4)])
    flux_path = str(tmp_path / "flux.safetensors")
    save_safetensors(_seeded(flux_checkpoint_shapes(Flux(TrainingConfig(_values(tmp_path, "x"))).arch), seed=3),
                     flux_path)
    values = {name: _values(tmp_path, name, max_train_steps=3, checkpointing_steps=None,
                            pretrained_model_name_or_path=flux_path) for name in ("inproc", "job")}
    threads = torch.get_num_threads()
    Trainer(config=values["inproc"], device="cpu").run()
    status, job = _http(port, "POST", "/api/training/start", {"config": values["job"]})
    assert status == 201
    info = _wait(port, job["job_id"])
    _, logs = _http(port, "GET", f"/api/training/logs/{job['job_id']}?tail=2000")
    assert info["state"] == "completed" and info["return_code"] == 0, "\n".join(logs["logs"][-30:])
    name = "checkpoint-3/pytorch_lora_weights.safetensors"
    ours = load_safetensors_file(str(tmp_path / "job" / name))
    theirs = load_safetensors_file(str(tmp_path / "inproc" / name))
    assert sorted(ours) == sorted(theirs) and all(torch.equal(ours[k], theirs[k]) for k in ours), threads
    with open(tmp_path / "job" / "simpletuner-tpu-metrics.jsonl") as a, \
            open(tmp_path / "inproc" / "simpletuner-tpu-metrics.jsonl") as b:
        assert [json.loads(x)["loss"] for x in a] == [json.loads(x)["loss"] for x in b]
    events = [e["event_type"] for e in srv.sse._history if e.get("job_id") == job["job_id"]]
    assert events[:2] == ["job_queued", "job_started"] and events[-1] == "job_finished"


def test_an_unported_family_fails_naming_its_item(port_server, tmp_path):
    _, port = port_server
    _write_images(tmp_path / "data")
    status, job = _http(port, "POST", "/api/training/start",
                        {"config": _values(tmp_path, "out", model_family="deepfloyd")})
    info = _wait(port, job["job_id"])
    _, logs = _http(port, "GET", f"/api/training/logs/{job['job_id']}?tail=200")
    assert info["state"] == "failed" and info["return_code"] != 0
    assert any("ROADMAP Queue 1 item 6" in line for line in logs["logs"])


def test_signal_and_cancel_a_running_job(port_server, tmp_path):
    _, port = port_server
    _write_images(tmp_path / "data")
    _seed_text_cache(tmp_path, [f"photo {i}" for i in range(4)])
    status, job = _http(port, "POST", "/api/training/start",
                        {"config": _values(tmp_path, "out", max_train_steps=100000, checkpointing_steps=None)})
    job_id = job["job_id"]
    metrics = tmp_path / "out" / "simpletuner-tpu-metrics.jsonl"
    deadline = time.time() + 120
    while not (metrics.exists() and metrics.read_text()) and time.time() < deadline:
        time.sleep(0.2)
    assert _http(port, "POST", f"/api/training/signal/{job_id}", {"action": "checkpoint"}) == (200, {"signalled": True})
    assert _http(port, "POST", f"/api/training/signal/{job_id}", {"action": "nope"})[0] == 422
    while not any(p.name.startswith("checkpoint-") for p in (tmp_path / "out").iterdir()) and time.time() < deadline:
        time.sleep(0.2)
    assert any(p.name.startswith("checkpoint-") for p in (tmp_path / "out").iterdir())
    assert _http(port, "POST", f"/api/training/cancel/{job_id}", {}) == (200, {"cancelled": True})
    info = _wait(port, job_id)
    assert info["state"] == "cancelled"
    assert _http(port, "POST", f"/api/training/signal/{job_id}", {"action": "checkpoint"})[0] == 404


def test_two_job_slots_run_two_jobs_at_once(tmp_path):
    """``create_server(max_concurrent_jobs=2)`` (the chip script's server
    phase) dispatches a second job while the first runs: two jobs of an
    unported family, submitted back to back, overlap in time; the default
    server has one slot."""
    default = _start(create_server, tmp_path / "default", device="cpu")
    try:
        assert default.keeper.max_concurrent == 1
    finally:
        _stop(default)
    srv = _start(create_server, tmp_path / "state", device="cpu", max_concurrent_jobs=2)
    try:
        port = srv.server_address[1]
        assert srv.keeper.max_concurrent == 2
        _write_images(tmp_path / "data")
        jobs = [_http(port, "POST", "/api/training/start",
                      {"config": _values(tmp_path, f"out{i}", model_family="deepfloyd")})[1]["job_id"] for i in range(2)]
        infos = [_wait(port, job) for job in jobs]
        assert [info["state"] for info in infos] == ["failed", "failed"]
        assert infos[1]["started_at"] < infos[0]["finished_at"] and infos[0]["started_at"] < infos[1]["finished_at"]
    finally:
        _stop(srv)
