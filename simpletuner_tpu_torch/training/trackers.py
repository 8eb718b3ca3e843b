"""Experiment trackers (reference: ``report_to`` wiring, trainer.py:485-540 +
per-step ``accelerator.log`` at trainer.py:7009).

Backends: ``tensorboard`` (tensorboardX), ``wandb`` (if installed), ``jsonl``
(always-available local metrics log), ``none``.  Custom drop-in trackers load
from a module path like the reference's custom-trackers directory.

The torch port's own copy of ``simpletuner_tpu/training/trackers.py``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class BaseTracker:
    name = "base"

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        raise NotImplementedError

    def log_images(self, images, captions, step: int) -> None:
        pass

    def finish(self) -> None:
        pass


class JSONLTracker(BaseTracker):
    name = "jsonl"

    def __init__(self, output_dir: str, run_name: str = "train"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, f"{run_name}-metrics.jsonl")
        self._handle = open(self.path, "a")

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        record = {"step": step, "time": time.time()}
        for key, value in metrics.items():
            record[key] = float(value) if hasattr(value, "item") or isinstance(value, (int, float)) else value
        self._handle.write(json.dumps(record) + "\n")
        self._handle.flush()

    def finish(self) -> None:
        self._handle.close()


class TensorBoardTracker(BaseTracker):
    name = "tensorboard"

    def __init__(self, output_dir: str, run_name: str = "train"):
        from tensorboardX import SummaryWriter

        self.writer = SummaryWriter(os.path.join(output_dir, "tensorboard", run_name))

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        for key, value in metrics.items():
            try:
                self.writer.add_scalar(key, float(value), step)
            except (TypeError, ValueError):
                pass

    def log_images(self, images, captions, step: int) -> None:
        import numpy as np

        for i, image in enumerate(images):
            arr = np.asarray(image)
            if arr.ndim == 3 and arr.shape[-1] in (1, 3, 4):
                arr = arr.transpose(2, 0, 1)
            self.writer.add_image(f"validation/{i}", arr, step)

    def finish(self) -> None:
        self.writer.close()


class WandbTracker(BaseTracker):
    name = "wandb"

    def __init__(self, project: str, run_name: Optional[str], config: Optional[Dict] = None):
        import wandb

        self.run = wandb.init(project=project, name=run_name, config=config or {})

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        self.run.log(dict(metrics), step=step)

    def log_images(self, images, captions, step: int) -> None:
        import wandb

        self.run.log(
            {"validation": [wandb.Image(img, caption=c) for img, c in zip(images, captions)]},
            step=step,
        )

    def finish(self) -> None:
        self.run.finish()


def build_trackers(config, output_dir: str) -> List[BaseTracker]:
    report_to = (getattr(config, "report_to", None) or "none").lower()
    run_name = getattr(config, "tracker_run_name", None) or "simpletuner-tpu"
    project = getattr(config, "tracker_project_name", None) or "simpletuner-tpu"
    trackers: List[BaseTracker] = [JSONLTracker(output_dir, run_name)]
    # --logging_dir overrides where tracker files land (reference cmd_args)
    output_dir = str(getattr(config, "logging_dir", None) or output_dir)
    for name in report_to.replace("+", ",").split(","):
        name = name.strip()
        if name in ("", "none", "jsonl"):
            continue
        try:
            if name == "tensorboard":
                trackers.append(TensorBoardTracker(output_dir, run_name))
            elif name == "wandb":
                trackers.append(WandbTracker(project, run_name, config.to_dict() if hasattr(config, "to_dict") else None))
            elif name.endswith(".py") or "/" in name:
                tracker = _load_custom_tracker(name, config, output_dir)
                if tracker is not None:
                    trackers.append(tracker)
            else:
                logger.warning("unknown tracker %r; skipping", name)
        except Exception as exc:
            logger.warning("tracker %r unavailable: %s", name, exc)
    return trackers


def _load_custom_tracker(path: str, config, output_dir: str):
    """Drop-in tracker module (reference: custom-trackers/<name>.py loaded at
    trainer.py:485-540) — the module must expose ``Tracker(config, output_dir)``
    with log/log_images/finish."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("custom_tracker", path)
    if spec is None or spec.loader is None:
        logger.warning("cannot load custom tracker %s", path)
        return None
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Tracker(config, output_dir)
