"""Text encoders (CLIP-L/G, T5, the decoder LLMs) behind one interface.

Counterpart of ``simpletuner_tpu/models/text_encoders.py``: ``TextEncoder``
(``tokenize``, and ``encode`` returning numpy ``last_hidden_state``,
``attention_mask`` and ``pooled``), ``LLMTextEncoder`` (the decoder-LLM
hidden states, pooled at the last valid token, and
``encode_with_hidden_states``), the deterministic ``_TinyTokenizer`` for
tests, and ``load_text_encoders`` for ``clip-l``, ``clip-g``, ``t5``,
``t5-xxl`` and every decoder-LLM family name of ``_LLM_ARCHES`` (gemma,
qwen, llama, mistral, chatglm).  The models are the port's own
(``models/clip.py``, ``models/t5.py``, ``models/llm_encoder.py``), on the
device the caller names.
Without a pretrained path (or with ``tiny``) the JAX package builds its tiny
random configs; the port builds the same configs with seeded weights.  With a
path, the weights come from the HF torch-layout subfolders and the tokenizers
load lazily through ``transformers``, only then.  The tiny tokenizer keeps
the salted ``hash`` of the JAX one (text_encoders.py:111), so its ids differ
between processes.  An LLM's config is its preset with the subfolder's
``config.json`` laid over it (``_llm_config_from_hf_dir``), and its
tokenizer comes from ``tokenizer_subfolder or "tokenizer"`` through
``transformers.AutoTokenizer`` (the subfolder itself when that dir is
missing), loaded only then.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .clip import CLIPTextConfig, CLIPTextModel, load_clip_text
from .common import TextEncoderSpec
from .llm_encoder import LLMEncoder, LLMEncoderConfig, llm_params_from_hf
from .t5 import T5Config, T5EncoderModel, load_t5_encoder
from .weight_bridge import load_flax_params
from .weight_import import read_safetensors


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


class LLMTextEncoder(TextEncoder):
    """Decoder-LLM hidden-state encoder (gemma / qwen / llama / mistral /
    chatglm) behind the CLIP / T5 ``encode`` interface: the final-norm hidden
    states, the mask, and ``pooled``, the last non-padding token's state (the
    causal LM convention)."""

    def __init__(self, spec: TextEncoderSpec, model: LLMEncoder, tokenizer):
        super().__init__(spec, model, tokenizer)
        self.config = model.config

    @torch.no_grad()
    def _run(self, prompts: Sequence[str], output_hidden_states: bool = False):
        tokens = self.tokenize(prompts)
        ids = torch.as_tensor(np.asarray(tokens["input_ids"]), device=self.device)
        mask = torch.as_tensor(np.asarray(tokens["attention_mask"]), device=self.device)
        return self.model(ids, mask, output_hidden_states=output_hidden_states), np.asarray(tokens["attention_mask"])

    def encode(self, prompts: Sequence[str]) -> Dict[str, np.ndarray]:
        hidden, mask = self._run(prompts)
        hidden = hidden.to(torch.float32).cpu().numpy()
        last = np.maximum(mask.sum(axis=1) - 1, 0)
        pooled = hidden[np.arange(hidden.shape[0]), last]
        return {"last_hidden_state": hidden, "attention_mask": mask, "pooled": pooled}

    def encode_with_hidden_states(self, prompts: Sequence[str]) -> Dict[str, Any]:
        """The per-layer taps (embeddings first, the transformers
        ``output_hidden_states`` convention) beside the final state."""
        (final, taps), mask = self._run(prompts, output_hidden_states=True)
        return {
            "last_hidden_state": final.to(torch.float32).cpu().numpy(),
            "hidden_states": tuple(t.to(torch.float32).cpu().numpy() for t in taps),
            "attention_mask": mask,
        }


# text-encoder family name -> LLM layout, and the layout's preset
_LLM_ARCHES = {
    "gemma": "gemma2",
    "gemma-2": "gemma2",
    "qwen": "qwen2",
    "qwen2": "qwen2",
    "qwen2.5": "qwen2",
    "qwen2.5-vl": "qwen2",
    "llama": "llama",
    "llama-3": "llama",
    "mistral": "mistral",
    "mistral-3": "mistral",
    "chatglm": "chatglm",
}

_LLM_PRESETS = {
    "gemma2": "gemma2_2b",
    "qwen2": "qwen25_7b",
    "llama": "llama3_8b",
    "mistral": "mistral3_24b",
    "chatglm": "chatglm3_6b",
}


def _llm_config_from_hf_dir(arch: str, path: str) -> LLMEncoderConfig:
    """The layout's preset with an HF ``config.json``'s sizes laid over it."""
    with open(os.path.join(path, "config.json")) as handle:
        hf = json.load(handle)
    preset = getattr(LLMEncoderConfig, _LLM_PRESETS[arch])()
    heads = hf.get("num_attention_heads", preset.num_heads)
    return dataclasses.replace(
        preset,
        vocab_size=hf.get("vocab_size", preset.vocab_size),
        hidden_size=hf.get("hidden_size", preset.hidden_size),
        intermediate_size=hf.get("intermediate_size", hf.get("ffn_hidden_size", preset.intermediate_size)),
        num_layers=hf.get("num_hidden_layers", hf.get("num_layers", preset.num_layers)),
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", hf.get("multi_query_group_num", preset.num_kv_heads)),
        head_dim=hf.get("head_dim", hf.get("hidden_size", preset.hidden_size) // heads),
        rope_theta=hf.get("rope_theta", preset.rope_theta),
        rms_eps=hf.get("rms_norm_eps", hf.get("layernorm_epsilon", preset.rms_eps)),
    )


def _build_llm(spec: TextEncoderSpec, path: Optional[str], tiny: bool, device, generator):
    arch = _LLM_ARCHES[spec.family]
    if tiny or path is None:
        with torch.device(device):
            model = LLMEncoder(LLMEncoderConfig.tiny(arch))
        model.reset_parameters(generator)
        return LLMTextEncoder(spec, model.eval(), _TinyTokenizer(spec.max_length))
    sub = os.path.join(path, spec.subfolder) if spec.subfolder else path
    sub = sub if os.path.isdir(sub) else path
    config = _llm_config_from_hf_dir(arch, sub)
    with torch.device(device):
        model = LLMEncoder(config)
    load_flax_params(model, llm_params_from_hf(read_safetensors(sub), config))
    tok_dir = os.path.join(path, spec.tokenizer_subfolder or "tokenizer")
    import transformers  # only with a pretrained tokenizer path

    tokenizer = transformers.AutoTokenizer.from_pretrained(tok_dir if os.path.isdir(tok_dir) else sub)
    return LLMTextEncoder(spec, model.eval(), tokenizer)


_LOADERS = {
    "clip-l": _build_clip,
    "clip-g": _build_clip,
    "t5-xxl": _build_t5,
    "t5": _build_t5,
    **{family: _build_llm for family in _LLM_ARCHES},
}


def load_text_encoders(
    specs: Sequence[TextEncoderSpec],
    pretrained_path: Optional[str] = None,
    tiny: bool = False,
    device="cuda",
) -> List[TextEncoder]:
    """One encoder per spec on ``device``: CLIP and T5 in f32 (the trainer
    casts them to ``text_encoder_precision``), a decoder LLM with its weights
    in bf16, its compute dtype, and its norm scales in f32; weights seeded
    from 0 without a path."""
    generator = torch.Generator(device=torch.device(device)).manual_seed(0)
    encoders = []
    for spec in specs:
        load = _LOADERS.get(spec.family)
        if load is None:
            raise NotImplementedError(f"text encoder family {spec.family!r} is not ported ({', '.join(_LOADERS)})")
        encoders.append(load(spec, pretrained_path, tiny, device, generator))
    return encoders
