"""LTX-Video family.

Counterpart of ``simpletuner_tpu/models/ltxvideo/model.py``: ``LTXVideo``
subclasses the port's ``Wan`` for the video-family machinery (``encode_text``
keeping the mask that ``collate_text_embeds`` drops, ``get_model_inputs``,
``model_predict``, ``inference_conditioning``, ``example_batch``) with the
faithful LTX DiT of ``transformer.py``: ``LTXConfig()`` for ``2b-0.9.5`` (the
default), the 13B arch (4096 wide, 48 blocks of 32 x 128, cross 4096) for
``13b-0.9.7``, ``tiny`` under the tiny preset; T5-XXL at 128 tokens read
from ``text_encoder`` (the tokenizer from ``tokenizer_2``, as the JAX T5
spec reads it); 128 latent channels of the causal video VAE at LTX's config
(``video_vae_config``: 32x spatial, 8x temporal, unscaled); no I2V channel
concat (``is_i2v`` is False: LTX conditions through frame 0's timestep).

``prepare_batch`` adds LTX's first-frame paths to the flow preparation:
``ltx_protect_first_frame`` trains frame 0 at sigma 0 (the clean frame), and
otherwise ``ltx_i2v_prob`` (default 0.1) gives each sample, with that
probability, a frame 0 whose sigma and noise scale down by a fraction drawn
in [0, ``ltx_partial_noise_fraction``).  Either way the sigmas ride
``timesteps`` per latent frame, (B, T), into the DiT's per-frame
conditioning, so the default LTX step takes the per-frame path.  The two
uniform draws per sample (the gate's, then the fraction's) come from the
step's generator after the noise and the sigmas; a batch may carry them as
``override_i2v_draws`` (2, B).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..common import TextEncoderSpec
from ..video_vae import VideoVAEConfig
from ..wan.model import Wan
from .transformer import LTXConfig, LTXTransformer


class LTXVideo(Wan):
    """The video-family machinery of Wan with the LTX DiT."""

    NAME = "ltxvideo"
    DEFAULT_FLAVOUR = "2b-0.9.5"
    HUGGINGFACE_PATHS = {
        "2b-0.9.5": "Lightricks/LTX-Video-0.9.5",
        "13b-0.9.7": "Lightricks/LTX-Video-0.9.7-dev",
    }
    TEXT_ENCODER_CONFIGURATION = (
        TextEncoderSpec(name="t5-xxl", family="t5-xxl", subfolder="text_encoder", max_length=128),
    )
    LATENT_CHANNEL_COUNT = 128

    def __init__(self, config: Any, arch: Optional[LTXConfig] = None):
        if arch is None:
            if getattr(config, "model_arch_preset", None) == "tiny":
                arch = LTXConfig.tiny()
            elif getattr(config, "model_flavour", None) == "13b-0.9.7":
                arch = LTXConfig.b13()
            else:
                arch = LTXConfig()
        super().__init__(config, arch=arch)

    @property
    def is_i2v(self) -> bool:
        return False  # LTX conditions through frame 0's timestep, not a channel concat

    @property
    def latent_channels(self) -> int:
        return self.arch.in_channels

    def create_module(self) -> LTXTransformer:
        """The DiT (``build_module``): remat of every block."""
        return self.build_module(LTXTransformer)

    def prepare_batch(self, generator: torch.Generator, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The flow preparation, then frame 0's sigma (and under
        ``ltx_i2v_prob`` its noise) scaled per sample; ``timesteps`` (B, T)."""
        batch = dict(batch)
        override = batch.pop("override_i2v_draws", None)
        prepared = super().prepare_batch(generator, batch)
        protect = bool(getattr(self.config, "ltx_protect_first_frame", False))
        prob = float(getattr(self.config, "ltx_i2v_prob", 0.0) or 0.0)
        latents = prepared["latents"]
        if not (protect or prob > 0) or latents.dim() != 5 or latents.shape[1] <= 1:
            return prepared
        frac = float(getattr(self.config, "ltx_partial_noise_fraction", 0.05) or 0.05)
        b, t = latents.shape[:2]
        frame_sig = prepared["sigmas"][:, None].expand(b, t)
        mask0 = torch.zeros((b, t), dtype=torch.float32, device=latents.device)
        mask0[:, 0] = 1.0
        noise = prepared["noise"]
        if protect:
            alpha = 1.0 - mask0  # frame 0 at sigma 0; the noise untouched
        else:
            draws = torch.rand((2, b, 1), generator=generator, device=latents.device, dtype=torch.float32)
            if override is not None:
                draws = override.float().reshape(2, b, 1)
            gate = (draws[0] < prob).to(torch.float32)
            alpha = 1.0 - mask0 * gate * (draws[1] * frac)
            noise = noise * alpha[:, :, None, None, None]
        frame_sig = frame_sig * alpha
        s5 = frame_sig[:, :, None, None, None]
        lat32 = latents.to(torch.float32)
        prepared["noise"] = noise
        prepared["noisy_latents"] = (1.0 - s5) * lat32 + s5 * noise
        prepared["target"] = noise - lat32
        prepared["timesteps"] = frame_sig
        return prepared

    def video_vae_config(self) -> VideoVAEConfig:
        if getattr(self.config, "model_arch_preset", None) == "tiny":
            return VideoVAEConfig(latent_channels=8, base_channels=8, channel_multipliers=(1, 2),
                                  temporal_downsample=(True, True), num_res_blocks=1)
        # LTX's causal VAE: 32x spatial, 8x temporal, 128 latent channels
        return VideoVAEConfig(latent_channels=128, base_channels=64, channel_multipliers=(1, 2, 4, 8, 8, 8),
                              temporal_downsample=(False, True, True, True, False, False), num_res_blocks=2)
