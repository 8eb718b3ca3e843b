"""Families assembled from ported blocks.

Counterpart of ``simpletuner_tpu/models/extended/model.py``, of which only
``BooguImage`` is ported: Boogu-Image rides the Lumina2 Next-DiT verbatim
(2304 wide, 26 layers, 24 query / 8 kv heads of 96; the Gemma-2 text
encoder at 256 tokens), with Lumina2's importer and adapter key map.  The
JAX family takes Lumina2's consistent RoPE axes where the published class
defaults disagree with its head dim, and ports neither its prompt-tuning nor
its instruction-reasoner sidecars; nor does the port.  ``WanS2V`` waits for
the audio data plane (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

from ..lumina2.model import Lumina2


class BooguImage(Lumina2):
    NAME = "boogu_image"
    DEFAULT_FLAVOUR = "v0.1"
    HUGGINGFACE_PATHS = {"v0.1": "boogu/boogu-image-v0.1"}
