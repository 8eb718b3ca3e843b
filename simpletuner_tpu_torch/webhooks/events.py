"""Typed webhook event constructors.

Reference: helpers/webhooks/events.py:46-277 — structured events consumed by
the WebUI SSE stream and Discord webhooks: ``lifecycle_stage``,
``training_status`` (+progress/ETA), ``notification``, ``error``,
``checkpoint``, ``gpu_fault`` (the TPU analogue here is ``device_fault``).

The torch port's own copy of ``simpletuner_tpu/webhooks/events.py``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional


def _base(event_type: str, job_id: Optional[str] = None) -> Dict[str, Any]:
    return {
        "event_type": event_type,
        "timestamp": time.time(),
        "job_id": job_id,
    }


def lifecycle_stage_event(
    stage: str,
    status: str = "running",
    job_id: Optional[str] = None,
    detail: Optional[str] = None,
) -> Dict[str, Any]:
    event = _base("lifecycle_stage", job_id)
    event.update({"stage": stage, "status": status, "detail": detail})
    return event


def training_status_event(
    global_step: int,
    max_train_steps: int,
    epoch: int,
    loss: Optional[float] = None,
    learning_rate: Optional[float] = None,
    iterations_per_second: Optional[float] = None,
    eta_seconds: Optional[float] = None,
    job_id: Optional[str] = None,
    extra_metrics: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    event = _base("training_status", job_id)
    progress = global_step / max_train_steps if max_train_steps else 0.0
    event.update(
        {
            "global_step": global_step,
            "max_train_steps": max_train_steps,
            "epoch": epoch,
            "progress": progress,
            "loss": loss,
            "learning_rate": learning_rate,
            "iterations_per_second": iterations_per_second,
            "eta_seconds": eta_seconds,
        }
    )
    if extra_metrics:
        event["metrics"] = extra_metrics
    return event


def notification_event(message: str, severity: str = "info", job_id: Optional[str] = None) -> Dict[str, Any]:
    event = _base("notification", job_id)
    event.update({"message": message, "severity": severity})
    return event


def error_event(message: str, exception: Optional[BaseException] = None, job_id: Optional[str] = None) -> Dict[str, Any]:
    event = _base("error", job_id)
    event.update(
        {
            "message": message,
            "exception_type": type(exception).__name__ if exception else None,
            "exception_message": str(exception) if exception else None,
        }
    )
    return event


def checkpoint_event(path: str, global_step: int, rolling: bool = False, job_id: Optional[str] = None) -> Dict[str, Any]:
    event = _base("checkpoint", job_id)
    event.update({"path": path, "global_step": global_step, "rolling": rolling})
    return event


def device_fault_event(message: str, details: Optional[Dict[str, Any]] = None, job_id: Optional[str] = None) -> Dict[str, Any]:
    """TPU analogue of the reference's gpu_fault event (events.py:199)."""
    event = _base("device_fault", job_id)
    event.update({"message": message, "details": details or {}})
    return event


def validation_event(
    global_step: int,
    prompt: str,
    image_path: Optional[str] = None,
    job_id: Optional[str] = None,
) -> Dict[str, Any]:
    event = _base("validation", job_id)
    event.update({"global_step": global_step, "prompt": prompt, "image_path": image_path})
    return event


def validation_preview_event(
    prompt: str,
    sampling_step: int,
    total_steps: int,
    image_base64: str,
    job_id: Optional[str] = None,
) -> Dict[str, Any]:
    """Streamed Tiny-AutoEncoder preview during validation sampling
    (reference helpers/training/validation.py:1633 ValidationPreviewer)."""
    event = _base("validation.preview", job_id)
    event.update(
        {
            "prompt": prompt,
            "sampling_step": sampling_step,
            "total_steps": total_steps,
            "image": {"src": f"data:image/png;base64,{image_base64}", "mime_type": "image/png"},
        }
    )
    return event
