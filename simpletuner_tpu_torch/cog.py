"""Cog (Replicate) packaging runner.

Reference behavior: simpletuner/cog.py — an orchestration layer that stages a
user-supplied training-data archive into a local dataset dir, materializes a
minimal multidatabackend config pointing at it, runs training, and packages
the output directory for return to the Cog caller.  The torch port's copy of
``simpletuner_tpu/cog.py`` keeps the same staging/packaging contract around
``python -m simpletuner_tpu_torch.train`` (on the card);
the ``cog`` library itself is only needed by ``predict.py`` (the Replicate
entrypoint) and is import-gated there.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile
import uuid
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional


class CogRunner:
    """Stage data → build config → train → package outputs."""

    def __init__(self, workdir: Optional[str] = None):
        self.workdir = Path(workdir or tempfile.mkdtemp(prefix="st_cog_"))
        self.workdir.mkdir(parents=True, exist_ok=True)

    # ---- staging --------------------------------------------------------------------
    def stage_archive(self, archive: str) -> Path:
        """Unpack a .zip/.tar(.gz) of images+captions into a dataset dir."""
        dataset = self.workdir / f"dataset_{uuid.uuid4().hex[:8]}"
        dataset.mkdir()
        archive_path = Path(archive)
        if not archive_path.exists():
            raise FileNotFoundError(f"training data archive not found: {archive}")
        if zipfile.is_zipfile(archive_path):
            with zipfile.ZipFile(archive_path) as zf:
                zf.extractall(dataset)
        elif tarfile.is_tarfile(archive_path):
            with tarfile.open(archive_path) as tf:
                tf.extractall(dataset, filter="data")
        else:
            raise ValueError(
                f"unsupported archive format {archive_path.suffix!r} (zip/tar/tar.gz)"
            )
        # flatten a single top-level directory (common zip layout)
        entries = [p for p in dataset.iterdir() if not p.name.startswith(".")]
        if len(entries) == 1 and entries[0].is_dir():
            inner = entries[0]
            for child in inner.iterdir():
                shutil.move(str(child), dataset / child.name)
            inner.rmdir()
        return dataset

    def dataset_config(self, dataset_dir: Path, resolution: int = 1024,
                      caption_strategy: str = "textfile") -> List[Dict[str, Any]]:
        cache = self.workdir / "cache"
        return [
            {
                "id": "cog-data",
                "type": "local",
                "dataset_type": "image",
                "instance_data_dir": str(dataset_dir),
                "resolution": resolution,
                "resolution_type": "pixel_area",
                "crop": True,
                "crop_style": "center",
                "crop_aspect": "square",
                "caption_strategy": caption_strategy,
                "cache_dir_vae": str(cache / "vae"),
                "text_embeds": "cog-embeds",
            },
            {
                "id": "cog-embeds",
                "type": "local",
                "dataset_type": "text_embeds",
                "default": True,
                "cache_dir": str(cache / "text"),
            },
        ]

    # ---- training -------------------------------------------------------------------
    def train(self, config: Dict[str, Any], data_archive: Optional[str] = None,
              log_fn=print) -> Path:
        """Run a training job; returns the output directory."""
        config = dict(config)
        if data_archive:
            dataset_dir = self.stage_archive(data_archive)
            config["data_backend_config"] = self.dataset_config(
                dataset_dir,
                resolution=int(config.get("resolution") or 1024),
                caption_strategy=str(config.get("caption_strategy") or "textfile"),
            )
        output_dir = Path(config.get("output_dir") or (self.workdir / "output"))
        config["output_dir"] = str(output_dir)
        config.setdefault("report_to", "none")
        config_path = self.workdir / "config.json"
        config_path.write_text(json.dumps(config, indent=2))

        proc = subprocess.Popen(
            [sys.executable, "-m", "simpletuner_tpu_torch.train", "--config", str(config_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for line in proc.stdout:  # type: ignore[union-attr]
            log_fn(line.rstrip("\n"))
        proc.wait()
        if proc.returncode != 0:
            raise RuntimeError(f"training failed with exit code {proc.returncode}")
        return output_dir

    # ---- packaging ------------------------------------------------------------------
    def package(self, output_dir: Path, archive_path: Optional[str] = None) -> Path:
        """Tar the training outputs (checkpoints, exports, validation images)."""
        target = Path(archive_path or (self.workdir / "training_output.tar.gz"))
        with tarfile.open(target, "w:gz") as tar:
            tar.add(output_dir, arcname="training_output")
        return target
