"""Families assembled from ported blocks.

Counterpart of ``simpletuner_tpu/models/extended/model.py``:

* ``BooguImage`` rides the Lumina2 Next-DiT verbatim (2304 wide, 26 layers,
  24 query / 8 kv heads of 96; the Gemma-2 text encoder at 256 tokens), with
  Lumina2's importer and adapter key map.  The JAX family takes Lumina2's
  consistent RoPE axes where the published class defaults disagree with its
  head dim, and ports neither its prompt-tuning nor its instruction-reasoner
  sidecars; nor does the port.
* ``WanS2V`` (speech-to-video) is Wan's DiT (the ``s2v-14b`` flavour builds
  ``WanConfig.b14()``) whose cross-attention context is the text followed by
  the clip's audio features: the data plane pairs each clip's same-stem WAV
  (``audio: {pair_with_video: true}``) into ``audio_embeds`` (B, frames,
  ``s2v_audio_feature_dim``), which ``get_model_inputs`` zero-pads (or cuts)
  to the text width and joins after the text tokens.  A render carries audio
  features only where its batch does: the validation payload has none, so
  the renders are text-only, as in the JAX package.  Wan's importer and key
  map serve it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..lumina2.model import Lumina2
from ..wan.model import Wan


class BooguImage(Lumina2):
    NAME = "boogu_image"
    DEFAULT_FLAVOUR = "v0.1"
    HUGGINGFACE_PATHS = {"v0.1": "boogu/boogu-image-v0.1"}


class WanS2V(Wan):
    NAME = "wan_s2v"
    DEFAULT_FLAVOUR = "s2v-14b"
    HUGGINGFACE_PATHS = {"s2v-14b": "Wan-AI/Wan2.2-S2V-14B"}

    def __init__(self, config: Any, arch=None):
        super().__init__(config, arch=arch)
        self.audio_feature_dim = int(getattr(config, "s2v_audio_feature_dim", 64) or 64)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        batch = super().example_batch(batch_size, resolution, device=device)
        batch["audio_embeds"] = torch.zeros((batch_size, 16, self.audio_feature_dim), device=device)
        return batch

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        inputs = super().get_model_inputs(prepared)
        if "audio_embeds" in prepared:
            context = inputs["context"]
            audio = prepared["audio_embeds"].to(context.dtype)
            text_dim = context.shape[-1]
            if audio.shape[-1] < text_dim:  # zero-pad the features to the text width
                audio = F.pad(audio, (0, text_dim - audio.shape[-1]))
            elif audio.shape[-1] > text_dim:
                audio = audio[..., :text_dim]
            inputs["context"] = torch.cat([context, audio], dim=1)
        return inputs

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cond = super().inference_conditioning(batch)
        if "audio_embeds" in batch:
            cond["audio_embeds"] = batch["audio_embeds"]
        return cond
