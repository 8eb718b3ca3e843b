"""Profiling & resource guards.

Counterpart of ``simpletuner_tpu/training/profiling.py``.  ``DiskGuard`` and
``parse_size_threshold`` are copies.  ``ProfilerSession`` traces the same
configured step window (``profile_steps``: "N" for N..N+5, or "N-M") with
``torch.profiler`` where the JAX one runs ``jax.profiler``; it writes a
Chrome trace and a ``summary.json`` (the window's wall milliseconds, the
device's busy milliseconds (the union of its kernel and copy intervals), the
sum of its kernel times, the idle share and the host ops with the most self
time) under ``<output_dir>/profile``.
``device_memory_report`` reads ``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)


def device_busy_ms(profile) -> float:
    """Milliseconds the card spent in kernels and copies over a
    ``torch.profiler`` window: the union of the device events' intervals, so
    work that overlaps on two streams counts once."""
    spans = []
    for event in profile.events():
        if event.device_type == torch.autograd.DeviceType.CUDA and event.time_range.elapsed_us() > 0:
            spans.append((event.time_range.start, event.time_range.end))
    busy, end = 0.0, None
    for start, stop in sorted(spans):
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e3


class ProfilerSession:
    """``torch.profiler`` trace over a step window (view the trace in Perfetto
    or chrome://tracing)."""

    def __init__(self, config: Any, output_dir: str):
        self.log_dir = os.path.join(output_dir, "profile")
        raw = config.get("profile_steps") if hasattr(config, "get") else None
        self.start_step: Optional[int] = None
        self.stop_step: Optional[int] = None
        if raw:
            if isinstance(raw, str) and "-" in raw:
                start, stop = raw.split("-", 1)
                self.start_step, self.stop_step = int(start), int(stop)
            else:
                self.start_step = int(raw)
                self.stop_step = self.start_step + 5
        self._profile = None
        self._started = 0.0
        self.summary: Optional[Dict[str, Any]] = None

    @property
    def enabled(self) -> bool:
        return self.start_step is not None

    @property
    def _active(self) -> bool:
        return self._profile is not None

    def step(self, global_step: int) -> None:
        if not self.enabled:
            return
        if not self._active and global_step == self.start_step:
            os.makedirs(self.log_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            self._profile = torch.profiler.profile(activities=activities)
            self._profile.__enter__()
            self._started, self._first = time.perf_counter(), global_step
            logger.info("profiler trace started at step %d -> %s", global_step, self.log_dir)
        elif self._active and global_step >= (self.stop_step or 0):
            self._stop(global_step)
            logger.info("profiler trace stopped at step %d", global_step)

    def _stop(self, global_step: int) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - self._started) * 1e3
        profile, self._profile = self._profile, None
        profile.__exit__(None, None, None)
        busy = device_busy_ms(profile)
        averages = profile.key_averages()
        kernel_ms = sum(e.device_time_total for e in averages if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        host = sorted((e for e in averages if e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:10]
        self.summary = {"steps": [self._first, global_step], "wall_ms": wall_ms, "device_busy_ms": busy,
                        "device_kernel_ms": kernel_ms, "idle_share": 1.0 - busy / wall_ms if wall_ms > 0 else None,
                        "host_self_ms": {e.key: e.self_cpu_time_total / 1e3 for e in host}}
        profile.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
        with open(os.path.join(self.log_dir, "summary.json"), "w") as handle:
            json.dump(self.summary, handle)

    def close(self) -> None:
        if self._active:
            self._stop(self.stop_step or 0)


def device_memory_report() -> Dict[str, Any]:
    """Per-device memory stats (reference _report_cuda_usage, trainer.py:2587)."""
    report = {}
    if not torch.cuda.is_available():
        return report
    for index in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(index)
        if stats:
            report[f"cuda:{index}"] = {
                "bytes_in_use": stats.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                "bytes_limit": torch.cuda.get_device_properties(index).total_memory,
            }
    return report


def parse_size_threshold(threshold: Any) -> Optional[int]:
    """Parse a human-readable size ('100G', '50M', '1T', plain bytes) to bytes.

    Reference semantics: helpers/training/disk_space.py:37-75 (None/'' disables).
    """
    if threshold in (None, "", "None"):
        return None
    import re

    text = str(threshold).strip().upper()
    match = re.match(r"^(\d+(?:\.\d+)?)\s*([KMGT]?)B?$", text)
    if not match:
        raise ValueError(
            f"Invalid disk_low_threshold format: {threshold!r}. "
            "Expected '100G', '50M', '1T', '500K', or plain bytes."
        )
    multipliers = {"": 1, "K": 1024, "M": 1024 ** 2, "G": 1024 ** 3, "T": 1024 ** 4}
    return int(float(match.group(1)) * multipliers[match.group(2)])


class DiskGuard:
    """Free-space thresholds before checkpoint writes.

    Reference helpers/training/disk_space.py: ``disk_low_threshold`` is a
    human-readable size, ``disk_low_action`` ∈ {stop, wait, script}, with
    ``disk_low_script`` run as a cleanup hook; re-checked after the script.
    The legacy ``disk_space_threshold_gb``/``disk_space_action`` (warn|stop)
    knobs from earlier rounds remain as a fallback path.
    """

    def __init__(self, config: Any, output_dir: str):
        self.output_dir = output_dir
        self.threshold_bytes = parse_size_threshold(config.get("disk_low_threshold"))
        self.action = (config.get("disk_low_action") or "stop").lower()
        if self.action not in ("stop", "wait", "script"):
            raise ValueError(
                f"Unsupported disk_low_action {self.action!r}; expected stop, wait or script"
            )
        self.script = config.get("disk_low_script")
        if self.action == "script" and self.threshold_bytes and not self.script:
            raise ValueError("disk_low_action is 'script' but no disk_low_script configured")
        self.wait_interval = float(config.get("disk_low_wait_interval", 30) or 30)
        # legacy knobs (warn|stop on a GB float) used when no disk_low_threshold
        self.legacy_threshold_gb = float(config.get("disk_space_threshold_gb", 5.0) or 5.0)
        self.legacy_action = (config.get("disk_space_action") or "warn").lower()

    def free_bytes(self) -> int:
        path = self.output_dir
        while not os.path.exists(path):
            parent = os.path.dirname(path) or "/"
            if parent == path:
                break
            path = parent
        return shutil.disk_usage(path).free

    def free_gb(self) -> float:
        return self.free_bytes() / 1e9

    def check_before_checkpoint(self) -> bool:
        """False → the caller must skip the checkpoint (or abort on 'stop')."""
        if self.threshold_bytes is not None:
            self._check_reference_mode()
            return True
        free = self.free_gb()
        if free >= self.legacy_threshold_gb:
            return True
        message = f"low disk space: {free:.1f} GB free < {self.legacy_threshold_gb:.1f} GB threshold"
        if self.legacy_action == "stop":
            raise RuntimeError(message + " (disk_space_action=stop)")
        logger.warning("%s; skipping checkpoint", message)
        return False

    def _check_reference_mode(self) -> None:
        import subprocess
        import time

        free = self.free_bytes()
        if free >= self.threshold_bytes:
            return
        human = f"{free / 1024 ** 3:.1f}GB available, threshold {self.threshold_bytes / 1024 ** 3:.1f}GB"
        if self.action == "stop":
            raise RuntimeError(f"Disk space critically low: {human}. Training stopped.")
        if self.action == "wait":
            logger.warning("Disk space low (%s); waiting for space...", human)
            while self.free_bytes() < self.threshold_bytes:
                time.sleep(self.wait_interval)
            logger.info("Disk space recovered; resuming")
            return
        # script: run cleanup hook, then re-check and stop if still low
        logger.warning("Disk space low (%s); running cleanup script %s", human, self.script)
        try:
            subprocess.run([str(self.script)], check=True)
        except (OSError, subprocess.CalledProcessError) as exc:
            raise RuntimeError(f"disk_low_script failed: {exc}") from exc
        free = self.free_bytes()
        if free < self.threshold_bytes:
            raise RuntimeError(
                f"Disk space still low after cleanup script: {free / 1024 ** 3:.1f}GB free"
            )
