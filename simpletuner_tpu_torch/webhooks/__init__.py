from .events import (
    checkpoint_event,
    error_event,
    lifecycle_stage_event,
    notification_event,
    training_status_event,
)
from .handler import WebhookHandler

__all__ = [
    "WebhookHandler",
    "lifecycle_stage_event",
    "training_status_event",
    "notification_event",
    "error_event",
    "checkpoint_event",
]
