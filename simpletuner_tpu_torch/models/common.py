"""Model-family base class, the part the inference path needs.

Counterpart of ``simpletuner_tpu/models/common.py::ModelFoundation``: the
static family contract (flavour, prediction type, VAE factors) and
:meth:`denoise_fn`.  Where the JAX methods take a Flax ``variables`` tree, the
port takes the ``nn.Module`` that holds its weights.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn


class ModelFoundation:
    NAME: str = "base"
    PREDICTION_TYPE: str = "flow_matching"
    REQUIRES_VAE: bool = True
    DEFAULT_FLAVOUR: Optional[str] = None
    VAE_SCALING_FACTOR: float = 1.0
    VAE_SHIFT_FACTOR: float = 0.0

    def __init__(self, config: Any):
        self.config = config
        self.flavour = getattr(config, "model_flavour", None) or self.DEFAULT_FLAVOUR

    @property
    def is_flow(self) -> bool:
        prediction = getattr(self.config, "prediction_type", None) or self.PREDICTION_TYPE
        return prediction == "flow_matching"

    @property
    def prediction_type(self) -> str:
        return getattr(self.config, "prediction_type", None) or self.PREDICTION_TYPE

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def denoise_fn(
        self, module: nn.Module, conditioning: Dict[str, torch.Tensor]
    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        """Returns f(latents, t) -> model_pred for the sampling loop."""

        def fn(latents: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            prepared = dict(conditioning)
            prepared["noisy_latents"] = latents
            prepared["timesteps"] = torch.full(
                (latents.shape[0],), float(t), dtype=torch.float32, device=latents.device
            )
            return self.model_predict(module, prepared)

        return fn
