"""Unified CLI of the torch port: ``simpletuner-tpu-torch`` /
``python -m simpletuner_tpu_torch.cli``.

Counterpart of ``simpletuner_tpu/cli/__init__.py``, with its whole
subcommand tree.  Training commands: ``train``, ``validate-config``,
``inference``, ``examples``, ``models``, ``optimizers``, ``configure``,
``docs``, ``version``.  Platform commands (server/jobs + the tree in
``cli/platform.py``): ``server``, ``jobs``, ``users``, ``orgs``, ``quota``,
``approvals``, ``notifications``, ``pricing``, ``webhooks``, ``metrics``,
``audit``, ``database``, ``backup``, ``worker`` and the rest.

Device handling: ``train`` hands ``--config`` and the remaining argv to
``simpletuner_tpu_torch.train.main`` (so ``--device cpu`` reaches it);
``inference`` and ``server`` take ``--device`` (default ``cuda``; the server
hands it to every job it spawns).  Nothing falls back to the CPU: without a
card the default ``cuda`` raises.  ``models`` lists every family of the JAX
registry (``flux`` and ``sd3`` train; any other family fails when it trains,
naming ROADMAP Queue 1 item 6); ``optimizers`` lists the port's registry; ``version --full`` reports
torch, CUDA and the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _cmd_train(args, extra: List[str]) -> int:
    from ..train import main as train_main

    argv = extra
    if args.config:
        argv = ["--config", args.config] + argv
    return train_main(argv)


def _cmd_validate_config(args, extra: List[str]) -> int:
    from ..configuration import TrainingConfig
    from ..configuration.dataloader import load_dataloader_config

    try:
        config = TrainingConfig.from_file(args.config)
    except Exception as exc:
        print(f"INVALID: {exc}", file=sys.stderr)
        return 1
    print(f"config OK: model_family={config.get('model_family')}")
    mdb = config.get("data_backend_config")
    if mdb:
        try:
            datasets = load_dataloader_config(mdb)
            print(f"dataloader OK: {len(datasets)} dataset(s): {[d.id for d in datasets]}")
        except Exception as exc:
            print(f"INVALID dataloader config: {exc}", file=sys.stderr)
            return 1
    return 0


def _cmd_inference(args, extra: List[str]) -> int:
    from ..inference import run_inference
    from ..train import configure_logging

    configure_logging()

    return run_inference(
        checkpoint=args.checkpoint,
        config_path=args.config,
        prompt=args.prompt,
        output=args.output,
        steps=args.steps,
        resolution=args.resolution,
        seed=args.seed,
        device=args.device,
    )


def _cmd_examples(args, extra: List[str]) -> int:
    from .examples import EXAMPLES, write_example

    if args.name:
        path = write_example(args.name, args.output_dir)
        print(f"wrote {path}")
        return 0
    for name, meta in EXAMPLES.items():
        print(f"{name:32s} {meta['description']}")
    return 0


def _cmd_models(args, extra: List[str]) -> int:
    from ..models.registry import ModelRegistry

    for family in ModelRegistry.families():
        meta = ModelRegistry.metadata(family)
        print(f"{family:16s} modality={meta.get('modality', '?'):6s} prediction={meta.get('prediction', '?')}")
    return 0


def _cmd_optimizers(args, extra: List[str]) -> int:
    from ..training.optimizers import optimizer_names

    for name in optimizer_names():
        print(name)
    return 0


def _cmd_configure(args, extra: List[str]) -> int:
    import sys

    if getattr(args, "simple", False) or not sys.stdin.isatty():
        # linear prompt wizard (scriptable; also the non-tty fallback)
        from .configure import run_wizard

        run_wizard(args.output_dir)
        return 0
    from .configure_tui import run_tui

    path = run_tui(
        output_path=f"{args.output_dir}/config.json", load=getattr(args, "load", None)
    )
    if path:
        print(f"wrote {path}")
    return 0


def _cmd_server(args, extra: List[str]) -> int:
    from ..server.app import main as server_main

    return server_main(["--host", args.host, "--port", str(args.port), "--device", args.device])


def _cmd_jobs(args, extra: List[str]) -> int:
    """Jobs client against the training API server (reference cli jobs
    subcommands: list/submit/cancel/logs)."""
    import os
    import urllib.request

    def request(method, path, body=None):
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} if data else {}
        token = args.token or os.environ.get("SIMPLETUNER_API_TOKEN")
        if token:
            headers["Authorization"] = f"Bearer {token}"
        req = urllib.request.Request(
            args.server + path, data=data, method=method, headers=headers,
        )
        with urllib.request.urlopen(req, timeout=30) as response:
            return json.loads(response.read() or b"null")

    if args.action == "list":
        for job in request("GET", "/api/training/jobs"):
            print(f"{job['job_id']:14s} {job['state']:10s} rc={job['return_code']}")
        return 0
    if args.action == "submit":
        if not args.config:
            print("submit requires --config", file=sys.stderr)
            return 2
        config = json.load(open(args.config))
        job = request("POST", "/api/training/start",
                      {"config": config, "priority": args.priority})
        if job.get("state") == "awaiting_approval":
            print(f"awaiting approval: {job['approval_id']}")
        else:
            print(job["job_id"])
        return 0
    if not args.job_id:
        print(f"{args.action} requires a job id", file=sys.stderr)
        return 2
    if args.action == "status":
        print(json.dumps(request("GET", f"/api/training/status/{args.job_id}"), indent=2))
    elif args.action == "logs":
        for line in request("GET", f"/api/training/logs/{args.job_id}?tail={args.tail}")["logs"]:
            print(line)
    elif args.action == "cancel":
        print(request("POST", f"/api/training/cancel/{args.job_id}"))
    elif args.action == "signal":
        print(request("POST", f"/api/training/signal/{args.job_id}", {"action": args.signal_action}))
    return 0


def _cmd_docs(args, extra: List[str]) -> int:
    from ..configuration.doc_generator import write_options_doc

    path = write_options_doc(args.output)
    print(f"wrote {path}")
    return 0


def _cmd_version(args, extra: List[str]) -> int:
    from .. import __version__

    if getattr(args, "full", False):
        from ..server.extras import version_info

        for name, ver in version_info().items():
            print(f"{name:20s} {ver}")
        return 0
    print(__version__)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("simpletuner-tpu-torch", description="diffusion training on CUDA (PyTorch)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="run a training job")
    p.add_argument("--config", default=None, help="config.json/toml/env path")
    p.set_defaults(fn=_cmd_train)

    p = sub.add_parser("validate-config", help="check a config without running")
    p.add_argument("--config", required=True)
    p.set_defaults(fn=_cmd_validate_config)

    p = sub.add_parser("inference", help="render images from a trained checkpoint")
    p.add_argument("--checkpoint", required=True, help="checkpoint dir (output of training)")
    p.add_argument("--config", default=None, help="training config used for the run")
    p.add_argument("--prompt", required=True)
    p.add_argument("--output", default="inference_output")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--resolution", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="torch device; 'cpu' for tests and tiny runs")
    p.set_defaults(fn=_cmd_inference)

    p = sub.add_parser("examples", help="list or materialize example configs")
    p.add_argument("name", nargs="?", default=None)
    p.add_argument("--output-dir", default="config")
    p.set_defaults(fn=_cmd_examples)

    p = sub.add_parser("models", help="list model families")
    p.set_defaults(fn=_cmd_models)

    p = sub.add_parser("optimizers", help="list optimizer choices")
    p.set_defaults(fn=_cmd_optimizers)

    p = sub.add_parser("configure", help="interactive config wizard (curses TUI)")
    p.add_argument("--output-dir", default="config")
    p.add_argument("--load", default=None, help="existing config.json to edit")
    p.add_argument("--simple", action="store_true", help="linear prompts instead of the TUI")
    p.set_defaults(fn=_cmd_configure)

    p = sub.add_parser("server", help="run the training API server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8005)
    p.add_argument("--device", default="cuda", help="torch device of every job the server spawns")
    p.set_defaults(fn=_cmd_server)

    p = sub.add_parser("jobs", help="manage jobs on a training API server")
    p.add_argument("action", choices=["list", "submit", "status", "logs", "cancel", "signal"])
    p.add_argument("job_id", nargs="?", default=None)
    p.add_argument("--server", default="http://127.0.0.1:8005")
    p.add_argument("--token", default=None, help="bearer token (SIMPLETUNER_API_TOKEN)")
    p.add_argument("--config", default=None, help="config path for submit")
    p.add_argument("--priority", type=int, default=4, help="queue priority 0-9")
    p.add_argument("--signal-action", default="checkpoint", choices=["validation", "checkpoint", "abort"])
    p.add_argument("--tail", type=int, default=50)
    p.set_defaults(fn=_cmd_jobs)

    p = sub.add_parser("docs", help="generate OPTIONS.md from the field registry")
    p.add_argument("--output", default="OPTIONS.md")
    p.set_defaults(fn=_cmd_docs)

    from .platform import register as register_platform

    register_platform(sub)

    p = sub.add_parser("version", help="print version")
    p.add_argument("--full", action="store_true", help="include dependency versions")
    p.set_defaults(fn=_cmd_version)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    return args.fn(args, extra)


if __name__ == "__main__":
    sys.exit(main())
