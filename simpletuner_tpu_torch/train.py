"""Training entry of the torch port.  Usage::

    python -m simpletuner_tpu_torch.train --config config/config.json [--device cuda|cpu]

Counterpart of ``simpletuner_tpu/train.py``: logging as the JAX entry sets it
up (``SIMPLETUNER_LOG_LEVEL``, ``SIMPLETUNER_TRAINING_LOOP_LOG_LEVEL``), the
config from ``--config`` under ``--key value`` flags, then ``Trainer.run()``;
a failure exits non-zero.  ``--device`` defaults to ``cuda`` (a missing card
raises); ``cpu`` runs the eager step, for tests and tiny runs.  Multi-host
runs are not ported (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from .configuration.args import TrainingConfig
from .training.trainer import Trainer


def configure_logging() -> None:
    """Log to stderr at ``SIMPLETUNER_LOG_LEVEL`` (default INFO), the loop at
    ``SIMPLETUNER_TRAINING_LOOP_LOG_LEVEL``."""
    level = getattr(logging, os.environ.get("SIMPLETUNER_LOG_LEVEL", "INFO").upper(), logging.INFO)
    logging.basicConfig(level=level, format="%(asctime)s [%(levelname)s] %(name)s: %(message)s", force=True)
    loop_level = os.environ.get("SIMPLETUNER_TRAINING_LOOP_LOG_LEVEL")
    if loop_level:
        logging.getLogger("simpletuner_tpu_torch.training.trainer").setLevel(
            getattr(logging, loop_level.upper(), logging.INFO)
        )


def main(argv=None) -> int:
    configure_logging()
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda", help="torch device; 'cpu' for tests and tiny runs")
    known, rest = parser.parse_known_args(argv)
    try:
        if os.environ.get("SIMPLETUNER_MULTIHOST") or int(os.environ.get("SIMPLETUNER_NUM_PROCESSES", "1")) > 1:
            raise NotImplementedError("multi-process training is not ported (ROADMAP Queue 1 item 5)")
        config = TrainingConfig.from_cli(rest)
        trainer = Trainer(config=config, device=known.device, exit_on_error=True)
        trainer.run()
    except SystemExit:
        raise
    except Exception:
        logging.getLogger(__name__).exception("training failed")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
