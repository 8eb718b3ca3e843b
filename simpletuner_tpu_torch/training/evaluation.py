"""Evaluation: the held-out eval loss.

Counterpart of ``simpletuner_tpu/training/evaluation.py::EvalLoss``: the
loss over the eval split (datasets with ``dataset_type: eval``, and training
datasets carved out by ``eval_dataset_id``), without an optimizer update,
through the model's ``loss_fn`` under ``torch.no_grad``; on the card its
forward runs the flash forward kernel.  At most ``max_batches`` batches per
dataset (``num_eval_images``), each drawn ``draws_per_batch`` times
(``eval_timesteps``), and the mean over every draw.  Draw ``d`` of batch
``c`` takes its noise and timesteps from the evaluator's own
``torch.Generator``, seeded from (``seed``, ``c * 1009 + d``) as the JAX
evaluator folds ``c * 1009 + d`` into its fixed key, so the metric is the
same in every run; the generator is never the one a captured train step
draws from.  The trainer hands ``execute_eval`` the module of
``train_state.render_view`` (the counterpart of ``TrainState.variables``).

Not ported: ``CLIPScoreEvaluator``, which the JAX trainer does not wire and
which needs a CLIP vision tower the port lacks (ROADMAP Queue 1 item 4b).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..data.dataset import collate_batch
from .validation import resolve_device

logger = logging.getLogger(__name__)


def eval_seed(seed: int, index: int) -> int:
    """The generator seed of eval draw ``index`` (``count * 1009 + draw``): a
    function of (``seed``, ``index``) alone."""
    return ((int(seed) * 1_000_003 + 0xE7A1) * 1_000_033 + int(index)) % 2**63


def eval_dataset_id_set(eval_dataset_ids) -> set:
    """``eval_dataset_id`` (None, one id or a list) as a set of ids."""
    if not eval_dataset_ids:
        return set()
    return {eval_dataset_ids} if isinstance(eval_dataset_ids, str) else set(eval_dataset_ids)


class EvalLoss:
    """Loss over the eval split with a fixed generator (the same across runs)."""

    def __init__(
        self,
        model,
        bundles: List,
        seed: int = 1234,
        max_batches: int = 8,
        eval_dataset_ids=None,
        draws_per_batch: int = 1,
        device="cuda",
    ):
        self.model = model
        ids = eval_dataset_id_set(eval_dataset_ids)
        # eval split = dataset_type=eval OR a training dataset carved out via
        # eval_dataset_id (the data plane keeps those out of the train iterator)
        self.bundles = [
            b for b in bundles
            if b.config.dataset_type == "eval" or (ids and getattr(b, "id", None) in ids)
        ]
        self.seed = seed
        self.max_batches = max_batches
        # eval_timesteps: draws per batch average the noise/timestep variance out
        self.draws_per_batch = max(1, int(draws_per_batch))
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)

    @property
    def enabled(self) -> bool:
        return bool(self.bundles)

    def _device_batch(self, raw: Dict) -> Dict[str, torch.Tensor]:
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in raw.items()
            if isinstance(v, np.ndarray) and v.dtype.kind in "fiub"
        }

    @torch.no_grad()
    def execute_eval(self, module: nn.Module) -> Optional[float]:
        if not self.enabled:
            return None
        losses = []
        for bundle in self.bundles:
            count = 0
            for samples in iter(bundle.sampler):
                batch = self._device_batch(collate_batch(samples, bundle, self.model))
                for draw in range(self.draws_per_batch):
                    self.generator.manual_seed(eval_seed(self.seed, count * 1009 + draw))
                    loss, _ = self.model.loss_fn(module, self.generator, batch)
                    losses.append(float(loss))
                count += 1
                if count >= self.max_batches:
                    break
        return float(np.mean(losses)) if losses else None
