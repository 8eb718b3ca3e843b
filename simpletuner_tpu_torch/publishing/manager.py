"""PublishingManager: the model card and the post-checkpoint hooks.

Counterpart of ``simpletuner_tpu/publishing/manager.py``: ``write_model_card``
(the card of ``publishing/metadata.py``), ``run_post_checkpoint_script`` and
``on_checkpoint``, as the JAX manager has them.  Hub and provider uploads
(``push_to_hub``, ``push_checkpoints_to_hub``, S3 / Azure / Dropbox) are not
ported: a config that asks for one is refused when the manager is built.
"""

from __future__ import annotations

import logging
import os
import subprocess
from typing import List, Optional

from .metadata import build_model_card

logger = logging.getLogger(__name__)

# config keys that ask for an upload, which the port does not make
UPLOAD_KEYS = ("push_to_hub", "push_checkpoints_to_hub", "publishing_config")


class PublishingManager:
    def __init__(self, model, config, output_dir: str):
        for key in UPLOAD_KEYS:
            if config.get(key):
                raise NotImplementedError(f"{key}: uploads are not ported (ROADMAP Queue 1 item 4j)")
        self.model = model
        self.config = config
        self.output_dir = output_dir

    # ---- model card ---------------------------------------------------------------------
    def write_model_card(
        self,
        path: Optional[str] = None,
        validation_prompts: Optional[List[str]] = None,
        validation_images: Optional[List[str]] = None,
        train_steps: Optional[int] = None,
    ) -> str:
        card = build_model_card(
            self.model, self.config, validation_prompts, validation_images, train_steps
        )
        path = path or os.path.join(self.output_dir, "README.md")
        with open(path, "w") as handle:
            handle.write(card)
        return path

    # ---- post-checkpoint user script (reference script_runner.py) --------------------------
    def run_post_checkpoint_script(self, checkpoint_path: str) -> None:
        script = self.config.get("post_checkpoint_script")
        if not script:
            return
        try:
            subprocess.run(
                [str(script), checkpoint_path],
                check=False,
                timeout=float(self.config.get("post_checkpoint_script_timeout", 600) or 600),
            )
        except Exception as exc:
            logger.warning("post-checkpoint script failed: %s", exc)

    def on_checkpoint(self, checkpoint_path: str, final: bool = False) -> None:
        """What follows a checkpoint: the user script (uploads are refused
        when the manager is built)."""
        self.run_post_checkpoint_script(checkpoint_path)
