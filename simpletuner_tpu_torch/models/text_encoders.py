"""Text encoders (CLIP-L/G, T5) behind one interface.

Counterpart of the CLIP and T5 paths of ``simpletuner_tpu/models/text_encoders.py``:
``TextEncoder`` (``tokenize``, and ``encode`` returning numpy
``last_hidden_state``, ``attention_mask`` and ``pooled``), the deterministic
``_TinyTokenizer`` for tests, and ``load_text_encoders`` for ``clip-l``,
``clip-g``, ``t5`` and ``t5-xxl``.  The models are the port's own
(``models/clip.py``, ``models/t5.py``), on the device the caller names.
Without a pretrained path (or with ``tiny``) the JAX package builds its tiny
random configs; the port builds the same configs with seeded weights.  With a
path, the weights come from the HF torch-layout subfolders and the tokenizers
load lazily through ``transformers``, only then.  The tiny tokenizer keeps
the salted ``hash`` of the JAX one (text_encoders.py:111), so its ids differ
between processes.  The decoder-LLM encoders (text_encoders.py:122-264) are
not ported.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .clip import CLIPTextConfig, CLIPTextModel, load_clip_text
from .common import TextEncoderSpec
from .t5 import T5Config, T5EncoderModel, load_t5_encoder


class TextEncoder:
    """One tokenizer and one encoder module; ``encode`` returns numpy arrays."""

    def __init__(self, spec: TextEncoderSpec, model: nn.Module, tokenizer):
        self.spec = spec
        self.model = model
        self.tokenizer = tokenizer

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def tokenize(self, prompts: Sequence[str]):
        return self.tokenizer(
            list(prompts),
            padding="max_length",
            max_length=self.spec.max_length,
            truncation=True,
            return_tensors="np",
        )

    @torch.no_grad()
    def encode(self, prompts: Sequence[str]) -> Dict[str, np.ndarray]:
        tokens = self.tokenize(prompts)
        ids = torch.as_tensor(np.asarray(tokens["input_ids"]), device=self.device)
        mask = torch.as_tensor(np.asarray(tokens["attention_mask"]), device=self.device)
        out = self.model(ids, mask)
        result: Dict[str, np.ndarray] = {
            "last_hidden_state": out["last_hidden_state"].to(torch.float32).cpu().numpy(),
            "attention_mask": np.asarray(tokens["attention_mask"]),
        }
        if "pooler_output" in out:
            result["pooled"] = out["pooler_output"].to(torch.float32).cpu().numpy()
        return result


class _TinyTokenizer:
    """Deterministic hash tokenizer for tests (no downloads)."""

    def __init__(self, max_length: int):
        self.max_length = max_length

    def __call__(self, prompts, padding=None, max_length=None, truncation=True, return_tensors="np"):
        max_length = max_length or self.max_length
        ids = np.zeros((len(prompts), max_length), np.int32)
        mask = np.zeros((len(prompts), max_length), np.int32)
        for row, prompt in enumerate(prompts):
            words = str(prompt).split()[: max_length - 1]
            for col, word in enumerate(words):
                ids[row, col] = (hash(word) % 900) + 10
                mask[row, col] = 1
            ids[row, len(words)] = 1  # eos
            mask[row, len(words)] = 1
        return {"input_ids": ids, "attention_mask": mask}


@torch.no_grad()
def init_encoder(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Seeded weights for an encoder built without a checkpoint: T5 at HF's
    T5 initialisation scale (``T5EncoderModel.reset_parameters``); CLIP with
    N(0, 0.02) embeddings and dense weights, zero biases, unit norm weights."""
    if isinstance(module, T5EncoderModel):
        module.reset_parameters(generator)
        return module
    for sub in module.modules():
        if isinstance(sub, (nn.Linear, nn.Embedding)):
            sub.weight.normal_(0.0, 0.02, generator=generator)
        if isinstance(sub, nn.Linear) and sub.bias is not None:
            sub.bias.zero_()
        if isinstance(sub, nn.LayerNorm):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
    return module


def _tokenizer(kind: str, path: str, subfolder: str):
    import transformers  # only with a pretrained tokenizer path

    return getattr(transformers, kind).from_pretrained(path, subfolder=subfolder)


def _build_clip(spec: TextEncoderSpec, path: Optional[str], tiny: bool, device, generator):
    if tiny or path is None:
        config = CLIPTextConfig.tiny(hidden_size=32 if spec.family == "clip-l" else 64,
                                     max_position_embeddings=max(spec.max_length, 77))
        with torch.device(device):
            model = init_encoder(CLIPTextModel(config), generator).eval()
        return TextEncoder(spec, model, _TinyTokenizer(spec.max_length))
    model = load_clip_text(os.path.join(path, spec.subfolder or ""), device=device)
    return TextEncoder(spec, model, _tokenizer("CLIPTokenizer", path, spec.tokenizer_subfolder or "tokenizer"))


def _build_t5(spec: TextEncoderSpec, path: Optional[str], tiny: bool, device, generator):
    if tiny or path is None:
        with torch.device(device):
            model = init_encoder(T5EncoderModel(T5Config.tiny()), generator).eval()
        return TextEncoder(spec, model, _TinyTokenizer(spec.max_length))
    model = load_t5_encoder(os.path.join(path, spec.subfolder or ""), device=device)
    return TextEncoder(spec, model, _tokenizer("T5TokenizerFast", path, spec.tokenizer_subfolder or "tokenizer_2"))


_LOADERS = {
    "clip-l": _build_clip,
    "clip-g": _build_clip,
    "t5-xxl": _build_t5,
    "t5": _build_t5,
}


def load_text_encoders(
    specs: Sequence[TextEncoderSpec],
    pretrained_path: Optional[str] = None,
    tiny: bool = False,
    device="cuda",
) -> List[TextEncoder]:
    """One encoder per spec, in f32 on ``device`` (the trainer casts them to
    ``text_encoder_precision``); weights seeded from 0 without a path."""
    generator = torch.Generator(device=torch.device(device)).manual_seed(0)
    encoders = []
    for spec in specs:
        load = _LOADERS.get(spec.family)
        if load is None:
            raise NotImplementedError(f"text encoder family {spec.family!r} is not ported (clip-l, clip-g, t5, t5-xxl)")
        encoders.append(load(spec, pretrained_path, tiny, device, generator))
    return encoders
