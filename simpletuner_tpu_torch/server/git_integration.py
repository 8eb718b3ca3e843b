"""Git-backed config versioning for the server's config store.

The torch port's copy of ``simpletuner_tpu/server/git_integration.py``: the same behavior.

Reference: simpletuner_sdk/server/routes/git.py (status :78, init :98,
identity :132, history :140, diff :152, snapshot :165, revert :182) backed by
services/git_config_service.py + git_repo_service.py — version the configs
directory as a git repo so config edits are auditable and revertable.

Stdlib subprocess over the git CLI; every call is scoped to the configs
directory (never the process CWD) and network operations (push/pull) require
an explicit remote to be configured first.
"""

from __future__ import annotations

import os
import subprocess
from typing import Any, Dict, List, Optional


class GitError(RuntimeError):
    pass


class GitConfigRepo:
    def __init__(self, config_dir: str):
        self.config_dir = config_dir

    def _git(self, *args: str, check: bool = True) -> subprocess.CompletedProcess:
        try:
            proc = subprocess.run(
                ["git", "-C", self.config_dir, *args],
                capture_output=True, text=True, timeout=60,
            )
        except FileNotFoundError:
            raise GitError("git binary not available")
        except subprocess.TimeoutExpired:
            raise GitError(f"git {' '.join(args[:2])} timed out")
        if check and proc.returncode != 0:
            raise GitError(proc.stderr.strip() or f"git {' '.join(args[:2])} failed")
        return proc

    @property
    def repo_present(self) -> bool:
        return os.path.isdir(os.path.join(self.config_dir, ".git"))

    def status(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "git_available": True, "repo_present": self.repo_present,
            "config_dir": self.config_dir, "branch": None, "remote": None,
            "dirty_paths": [], "user_name": None, "user_email": None,
            "identity_configured": False,
        }
        try:
            self._git("--version")
        except GitError:
            out["git_available"] = False
            return out
        if not self.repo_present:
            return out
        out["branch"] = self._git("rev-parse", "--abbrev-ref", "HEAD",
                                  check=False).stdout.strip() or None
        out["remote"] = self._git("remote", "get-url", "origin",
                                  check=False).stdout.strip() or None
        porcelain = self._git("status", "--porcelain", check=False).stdout
        out["dirty_paths"] = [line[3:] for line in porcelain.splitlines() if line.strip()]
        out["user_name"] = self._git("config", "user.name", check=False).stdout.strip() or None
        out["user_email"] = self._git("config", "user.email", check=False).stdout.strip() or None
        out["identity_configured"] = bool(out["user_name"] and out["user_email"])
        return out

    def init(self, branch: Optional[str] = None) -> Dict[str, Any]:
        os.makedirs(self.config_dir, exist_ok=True)
        if not self.repo_present:
            self._git("init", *(["-b", branch] if branch else []))
        return self.status()

    def set_identity(self, name: str, email: str) -> Dict[str, Any]:
        if not name or not email:
            raise GitError("name and email required")
        self._git("config", "user.name", name)
        self._git("config", "user.email", email)
        return self.status()

    def set_remote(self, url: str) -> Dict[str, Any]:
        if self._git("remote", check=False).stdout.strip():
            self._git("remote", "set-url", "origin", url)
        else:
            self._git("remote", "add", "origin", url)
        return self.status()

    def snapshot(self, message: Optional[str] = None,
                 paths: Optional[List[str]] = None) -> Dict[str, Any]:
        """Stage + commit config changes (reference snapshot :165)."""
        if not self.repo_present:
            self.init()
        if not self.status()["identity_configured"]:
            self._git("config", "user.name", "simpletuner-server")
            self._git("config", "user.email", "server@localhost")
        for p in (paths or ["."]):
            # refuse path escapes: snapshots only version the config dir
            if os.path.isabs(p) or ".." in p.split(os.sep):
                raise GitError(f"path outside config dir: {p}")
            self._git("add", p)
        if not self._git("status", "--porcelain", check=False).stdout.strip():
            return {"committed": False, "reason": "nothing to commit"}
        self._git("commit", "-m", message or "config snapshot")
        sha = self._git("rev-parse", "HEAD").stdout.strip()
        return {"committed": True, "commit": sha}

    def history(self, path: Optional[str] = None, limit: int = 20) -> List[Dict[str, Any]]:
        if not self.repo_present:
            return []
        args = ["log", f"-{max(1, min(limit, 200))}",
                "--pretty=format:%H%x1f%an%x1f%at%x1f%s"]
        if path:
            args += ["--", path]
        proc = self._git(*args, check=False)
        entries = []
        for line in proc.stdout.splitlines():
            parts = line.split("\x1f")
            if len(parts) == 4:
                entries.append({"commit": parts[0], "author": parts[1],
                                "timestamp": int(parts[2]), "message": parts[3]})
        return entries

    def diff(self, path: Optional[str] = None, commit: Optional[str] = None) -> str:
        if not self.repo_present:
            return ""
        args = ["diff"]
        if commit:
            args.append(commit)
        if path:
            args += ["--", path]
        return self._git(*args, check=False).stdout

    def revert(self, path: str, commit: Optional[str] = None) -> Dict[str, Any]:
        """Restore one config file from a commit (reference revert :182)."""
        if not path:
            raise GitError("path required")
        self._git("checkout", commit or "HEAD", "--", path)
        return {"reverted": path, "from": commit or "HEAD"}
