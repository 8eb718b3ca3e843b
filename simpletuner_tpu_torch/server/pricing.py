"""Cost / pricing service: per-chip-hour rates, estimates, spend accounting.

The torch port's copy of ``simpletuner_tpu/server/pricing.py``: the same behavior.

Reference behavior: simpletuner_sdk/server/services cloud cost/pricing
(SURVEY.md §2.7 "cost/pricing") — the platform prices jobs against a rate
table, shows an estimate before dispatch, and accrues actual spend from run
time.  rates are $/chip-hour keyed by accelerator type; estimates
derive from ``max_train_steps`` × an estimated step time (explicit in config,
else from the model family's acceleration presets, else a default); actuals
accrue from wall-clock duration on job completion.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

from .store import default_state_dir

# Public on-demand list prices (us-central), $/chip-hour. Overridable at
# runtime via set_rate and persisted with the platform state.
DEFAULT_RATES: Dict[str, float] = {
    "v4": 3.22,
    "v5e": 1.20,
    "v5p": 4.20,
    "v6e": 2.70,
    "cpu": 0.0,
}
DEFAULT_STEP_SECONDS = 1.0


class PricingTable:
    def __init__(self, root: Optional[str] = None):
        base = root or default_state_dir()
        os.makedirs(base, exist_ok=True)
        self.path = os.path.join(base, "pricing.json")
        self._lock = threading.Lock()
        self._rates = dict(DEFAULT_RATES)
        if os.path.exists(self.path):
            with open(self.path) as fh:
                self._rates.update(json.load(fh))

    def rates(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._rates)

    def set_rate(self, accelerator: str, usd_per_chip_hour: float) -> None:
        rate = float(usd_per_chip_hour)
        if rate < 0:
            raise ValueError("rate must be non-negative")
        with self._lock:
            self._rates[accelerator] = rate
            tmp = self.path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(self._rates, fh, indent=2)
            os.replace(tmp, self.path)

    def rate_for(self, accelerator: str) -> float:
        with self._lock:
            if accelerator not in self._rates:
                raise KeyError(
                    f"no rate for accelerator {accelerator!r}; "
                    f"known: {sorted(self._rates)}"
                )
            return self._rates[accelerator]

    # ---- estimates ------------------------------------------------------------------
    def estimate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Pre-dispatch cost estimate from the training config."""
        accelerator = str(config.get("accelerator_type") or "v5e")
        chips = int(config.get("num_chips") or 1)
        steps = int(config.get("max_train_steps") or 0)
        step_seconds = config.get("estimated_step_seconds")
        if step_seconds is None:
            step_seconds = self._preset_step_seconds(config) or DEFAULT_STEP_SECONDS
        hours = steps * float(step_seconds) / 3600.0
        rate = self.rate_for(accelerator)
        return {
            "accelerator_type": accelerator,
            "num_chips": chips,
            "steps": steps,
            "estimated_step_seconds": float(step_seconds),
            "estimated_hours": hours,
            "usd_per_chip_hour": rate,
            "estimated_cost_usd": hours * chips * rate,
        }

    @staticmethod
    def _preset_step_seconds(config: Dict[str, Any]) -> Optional[float]:
        """Per-family step-time estimate: presets are a list of named entries
        (ModelFoundation.get_acceleration_presets); an entry may carry an
        ``estimated_step_seconds`` hint for cost estimation."""
        family = config.get("model_family")
        if not family:
            return None
        try:
            from ..models.registry import ModelRegistry

            presets = ModelRegistry.get(family).get_acceleration_presets()
        except Exception:
            return None
        wanted = str(config.get("acceleration_preset") or "balanced")
        for preset in presets:
            if preset.get("name") == wanted and "estimated_step_seconds" in preset:
                return float(preset["estimated_step_seconds"])
        return None

    def actual_cost(self, config: Dict[str, Any], duration_seconds: float) -> float:
        accelerator = str(config.get("accelerator_type") or "v5e")
        chips = int(config.get("num_chips") or 1)
        try:
            rate = self.rate_for(accelerator)
        except KeyError:
            rate = 0.0
        return duration_seconds / 3600.0 * chips * rate
