"""Cosmos3 family.

Counterpart of ``simpletuner_tpu/models/cosmos3/model.py``: the omni MoT of
``transformer.py`` (``Cosmos3Config()``, 15.2B parameters, or ``tiny``
under the tiny preset) over 48-channel video latents (B, T, H, W, C),
2 x 2-patchified in (t, h, w, p, q, c) order behind the text prefix.  There
is no text encoder: ``encode_text`` gives 64 token ids per prompt, from the
tokenizer in a local model directory (``transformers.AutoTokenizer`` on
``pretrained_model_name_or_path``) or else from the salted ``hash`` of each
word (so they differ between processes, as in the JAX family), padded with
0; the collate keeps only ``text_ids``.  The pads are attended: the
understanding pathway has no padding mask.  Flow matching: the module takes
sigma x 1000 for every generation token and its vision prediction is the
velocity; the logits are discarded.  The mRoPE ids are made on the host
once per grid and device (a captured step copies nothing).

Where the JAX package stops, the port stops: neither package has a video
VAE for 48 latent channels, so ``video_vae_config`` raises (the JAX family
has none, and its ``Trainer.run()`` and validation render stop there); the
family trains through ``build_train_step`` and renders as a sampler loop
without a decode.  ``load_sound_tokenizer`` reads the AVAE audio codec,
which no trainer path calls.  ``DEFAULT_LORA_TARGET`` is read by no code, as
in the JAX package, and the per-layer intermediates tap is refused by name
(ROADMAP Queue 1 item 4h).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..common import ModelFoundation
from .transformer import (
    Cosmos3Config,
    Cosmos3OmniTransformer,
    cosmos3_patchify,
    cosmos3_position_ids,
    cosmos3_unpatchify,
)

COSMOS3_TEXT_LENGTH = 64


class Cosmos3(ModelFoundation):
    NAME = "cosmos3"
    PREDICTION_TYPE = "flow_matching"
    MODEL_TYPE = "transformer"
    MODALITY = "video"
    LATENT_CHANNEL_COUNT = 48
    DEFAULT_RESOLUTION = 704
    DEFAULT_FLAVOUR = "predict2-2b-video"
    HUGGINGFACE_PATHS = {
        "predict2-2b-video": "nvidia/Cosmos-Predict2-2B-Video2World",
        "predict2-14b-video": "nvidia/Cosmos-Predict2-14B-Video2World",
        "predict2-2b-image": "nvidia/Cosmos-Predict2-2B-Text2Image",
    }
    TEXT_ENCODER_CONFIGURATION = ()  # the backbone embeds the token ids itself
    DEFAULT_LORA_TARGET = ("attn_gen_q", "attn_gen_k", "attn_gen_v", "attn_gen_out")

    def __init__(self, config: Any, arch: Optional[Cosmos3Config] = None):
        super().__init__(config)
        if arch is not None:
            self.arch = arch
        elif getattr(config, "model_arch_preset", None) == "tiny":
            self.arch = Cosmos3Config.tiny()
        else:
            self.arch = Cosmos3Config()
        self._tokenizer = None
        self._positions: Dict[Tuple[int, int, int, int, torch.device], torch.Tensor] = {}

    @property
    def latent_channels(self) -> int:
        return self.arch.latent_channel

    def check_user_config(self) -> None:
        if getattr(self.config, "prediction_type", None) not in (None, "flow_matching"):
            raise ValueError("cosmos3 is a flow-matching family")

    def video_vae_config(self):
        raise NotImplementedError(
            "cosmos3: neither package has a video VAE for 48 latent channels (the JAX family defines no "
            "video_vae_config, so its Trainer.run() and validation render stop at the same place; ROADMAP "
            "Queue 3); train through build_train_step on cached latents"
        )

    @staticmethod
    def load_sound_tokenizer(path: str, tiny: bool = False, device: str = "cuda"):
        """The AVAE waveform <-> latent codec of the sound submodality, its
        weights imported from ``path`` (``Cosmos3AVAEAudioTokenizer``
        layout), on ``device``."""
        from ..weight_bridge import load_flax_params
        from .audio_tokenizer import (
            Cosmos3AudioTokenizer,
            Cosmos3AudioTokenizerConfig,
            load_cosmos3_audio_tokenizer,
        )

        cfg = Cosmos3AudioTokenizerConfig.tiny() if tiny else Cosmos3AudioTokenizerConfig()
        with torch.device(device):
            module = Cosmos3AudioTokenizer(cfg)
        return load_flax_params(module, load_cosmos3_audio_tokenizer(cfg, path)["params"]).eval()

    def create_module(self) -> Cosmos3OmniTransformer:
        """The MoT (``build_module``): remat of every layer."""
        return self.build_module(Cosmos3OmniTransformer)

    def example_batch(self, batch_size: int = 1, resolution: int = 64, device=None) -> Dict[str, torch.Tensor]:
        del resolution
        return {
            "latents": torch.zeros((batch_size, 2, 4, 4, self.arch.latent_channel), device=device),
            "text_ids": torch.ones((batch_size, 6), dtype=torch.int32, device=device),
        }

    def position_ids(self, und_len: int, t: int, h: int, w: int, device) -> torch.Tensor:
        """:func:`cosmos3_position_ids` (3, S) int32 on ``device``, made once per grid and device."""
        key = (und_len, t, h, w, torch.device(device))
        if key not in self._positions:
            ids = cosmos3_position_ids(self.arch, und_len, t, h, w).astype(np.int32)
            self._positions[key] = torch.from_numpy(ids).to(device)
        return self._positions[key]

    def get_model_inputs(self, prepared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        noisy = prepared["noisy_latents"]  # (B, T, H, W, C)
        batch, t, h, w, _ = noisy.shape
        text_ids = prepared["text_ids"].to(torch.int32)
        und_len = text_ids.shape[1]
        pos = self.position_ids(und_len, t, h, w, noisy.device)
        gen_len = pos.shape[1] - und_len
        # sigma x 1000 per generation token; the module scales it by 1e-3
        sigmas = prepared["timesteps"].to(torch.float32) * 1000.0
        return {
            "text_ids": text_ids,
            "vision_tokens": cosmos3_patchify(noisy, self.arch.latent_patch_size),
            "position_ids": pos[None].expand(batch, 3, pos.shape[1]),
            "timesteps": sigmas[:, None].expand(batch, gen_len),
        }

    def model_predict(self, module: nn.Module, prepared: Dict[str, torch.Tensor]) -> torch.Tensor:
        vision_pred, _logits = module(**self.get_model_inputs(prepared))
        _, t, h, w, _ = prepared["noisy_latents"].shape
        return cosmos3_unpatchify(vision_pred, t, h, w, self.arch.latent_patch_size)

    def model_predict_with_intermediates(self, module: nn.Module, prepared: Dict[str, torch.Tensor]):
        raise NotImplementedError("the cosmos3 per-layer intermediates tap (CREPA) is not ported "
                                  "(ROADMAP Queue 1 item 4h)")

    def inference_conditioning(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"text_ids": batch["text_ids"]}

    # ---- host-side text handling ---------------------------------------------------------
    def encode_text(self, prompts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """64 token ids per prompt (0-padded) and the JAX family's mask."""
        max_len = COSMOS3_TEXT_LENGTH
        rows = []
        tokenizer = self._resolve_tokenizer()
        for prompt in prompts:
            if tokenizer is not None:
                ids = list(tokenizer(prompt, truncation=True, max_length=max_len)["input_ids"])
            else:
                ids = [1 + (hash(word) % (self.arch.vocab_size - 2)) for word in str(prompt).split()][:max_len]
            ids = ids + [0] * (max_len - len(ids))
            # the JAX family's mask counts the padded ids: every entry is 1
            rows.append({"text_ids": np.asarray(ids, np.int32),
                         "attention_mask": np.asarray([1] * min(len(ids), max_len), np.int64)})
        return rows

    def _resolve_tokenizer(self):
        """``AutoTokenizer`` of a local ``pretrained_model_name_or_path`` (an
        absolute path), else None (the hash ids); a failed load is None too."""
        if self._tokenizer is not None:
            return self._tokenizer
        path = getattr(self.config, "pretrained_model_name_or_path", None)
        if not path or not str(path).startswith("/"):
            return None
        try:
            from transformers import AutoTokenizer  # only with a local tokenizer

            self._tokenizer = AutoTokenizer.from_pretrained(path)
        except Exception:  # any failure falls back to the hash ids, as in the JAX family
            self._tokenizer = None
        return self._tokenizer

    def collate_text_embeds(self, embeds: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {"text_ids": np.stack([np.asarray(e["text_ids"]) for e in embeds])}
