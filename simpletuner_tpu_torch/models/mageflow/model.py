"""MageFlow and Z-Image families.

Counterpart of ``simpletuner_tpu/models/mageflow/model.py``: both ride the
Qwen-Image DiT (``models/qwen_image``) with ``txt_rope=False`` (their text
tokens are not rotated), its diffusers importer and its adapter key map,
conditioned on Qwen states (the ``qwen2.5`` spec at 4096 tokens from
``text_encoder``, the qwen2 layout with qkv biases at the sizes of the
file's ``config.json``).  MageFlow is 12 blocks at 3072 wide over
``in_channels=128``, Z-Image 19 blocks over ``in_channels=64``; both read
2560-wide Qwen features.

Mirrored as the JAX families keep them (ROADMAP Queue 3): MageFlow's
``LATENT_CHANNEL_COUNT`` is 32 while the trainer builds the 16-channel
``VAEConfig.flux()`` for every family with 16 channels or more, so its
published arch cannot take the latents its VAE makes (the packed 64
features meet ``img_in``'s 128 and the step fails, in both packages); its
tiny preset works.  Z-Image inherits MageFlow's text spec.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..common import TextEncoderSpec
from ..qwen_image.model import QwenImage
from ..qwen_image.transformer import QwenImageConfig


class MageFlow(QwenImage):
    NAME = "mageflow"
    DEFAULT_FLAVOUR = "v1"
    HUGGINGFACE_PATHS = {"v1": "MageFlow/mageflow-4b"}
    LATENT_CHANNEL_COUNT = 32  # DC-AE latents, 2x2-packed to in_channels=128
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="qwen", family="qwen2.5", subfolder="text_encoder", max_length=4096),
    )

    def __init__(self, config: Any, arch: Optional[QwenImageConfig] = None):
        if arch is None:
            if getattr(config, "model_arch_preset", None) == "tiny":
                arch = dataclasses.replace(QwenImageConfig.tiny(), txt_rope=False)
            else:
                arch = QwenImageConfig(in_channels=128, hidden_size=3072, num_heads=24, head_dim=128, depth=12,
                                       txt_in_features=2560, txt_rope=False)
        super().__init__(config, arch=arch)


class ZImage(MageFlow):
    NAME = "z_image"
    DEFAULT_FLAVOUR = "turbo"
    HUGGINGFACE_PATHS = {"turbo": "Tongyi-MAI/Z-Image-Turbo"}
    LATENT_CHANNEL_COUNT = 16

    def __init__(self, config: Any, arch: Optional[QwenImageConfig] = None):
        if arch is None and getattr(config, "model_arch_preset", None) != "tiny":
            arch = QwenImageConfig(in_channels=64, hidden_size=3072, num_heads=24, head_dim=128, depth=19,
                                   txt_in_features=2560, txt_rope=False)
        super().__init__(config, arch=arch)
