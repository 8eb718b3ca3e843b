"""Ideogram prompt upsampling: turn a short idea into a structured JSON caption.

Counterpart of ``simpletuner_tpu/models/ideogram/prompt_enhancer.py``: an LM
head makes the head-less Qwen3-VL text trunk generative, and
:func:`upsample_prompt` runs the chat-templated generation as a host-side
loop over the whole trunk and the head for each new token (no KV cache,
O(n^2) in the generated length, as the JAX loop runs it: a validation-time
path over a handful of prompts).  The result then passes through the
auto-json path (``prompting.maybe_convert_prompt_to_ideogram_json``).

:func:`load_enhancer_head` reads a local safetensors file or a folder of
them; where the JAX function would download a hub id, the port refuses it by
name (pre-download the head and pass its path as
``ideogram_prompt_enhancer_head_id``).  Greedy decoding (temperature 0) is
the JAX loop's token for token; sampling draws from the port's own
``torch.Generator`` seeded with ``seed``, so sampled tokens differ from
``jax.random.categorical``'s (ROADMAP Queue 3).
"""

from __future__ import annotations

import logging
import math
import os
from typing import Any, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

PROMPT_UPSAMPLE_TEMPERATURE = 1.0
DEFAULT_MAX_NEW_TOKENS = 1024

# the JAX package's restatement of the caption system message (the exact
# upstream prompt ships with the enhancer head repo)
CAPTION_SYSTEM_MESSAGE = (
    "Rewrite the user's idea as ONE minified single-line JSON caption for an "
    "image renderer and output NOTHING else. Schema, keys in this order: "
    '{"high_level_description":"...","compositional_deconstruction":'
    '{"background":"...","elements":[{"type":"obj","desc":"..."} or '
    '{"type":"text","text":"VERBATIM","desc":"..."}]}}. '
    "The core subject must appear as the first obj element; descriptions are "
    "concrete and 25-55 words; quoted text becomes its own verbatim text "
    "element; use double quotes and no trailing commas."
)

CAPTION_USER_TEMPLATE = (
    "TARGET IMAGE ASPECT RATIO: {aspect_ratio} (width:height).\nUser idea: {original_prompt}"
)


def load_enhancer_head(head_id: str, hidden_size: Optional[int] = None) -> torch.Tensor:
    """The LM-head kernel (hidden, vocab) f32 from a local safetensors file or
    a local folder (its first ``.safetensors`` file, by name); the file holds
    ``lm_head.weight`` (or ``weight``) as (vocab, hidden)."""
    from ..weight_import import load_safetensors_file

    candidates = []
    if os.path.isfile(head_id):
        candidates.append(head_id)
    elif os.path.isdir(head_id):
        candidates.extend(os.path.join(head_id, name) for name in sorted(os.listdir(head_id))
                          if name.endswith(".safetensors"))
    else:
        raise RuntimeError(
            f"--ideogram_prompt_upsample needs the enhancer head {head_id!r}, which is not a local file or "
            "folder, and the port downloads nothing.  Pre-download it and pass a local path via "
            "--ideogram_prompt_enhancer_head_id."
        )
    if not candidates:
        raise FileNotFoundError(f"no .safetensors found for ideogram prompt enhancer head at {head_id!r}")
    weights = load_safetensors_file(candidates[0])
    for key in ("lm_head.weight", "weight"):
        if key in weights:
            kernel = weights[key].to(torch.float32).t().contiguous()  # -> (hidden, vocab)
            if hidden_size is not None and kernel.shape[0] != hidden_size:
                raise ValueError(f"enhancer head hidden size {kernel.shape[0]} does not match "
                                 f"the text encoder ({hidden_size})")
            return kernel
    raise KeyError(f"enhancer head {candidates[0]!r} has no lm_head.weight (keys: {sorted(weights)[:8]})")


def _chat_tokens(tokenizer, prompt: str, aspect_ratio: str) -> np.ndarray:
    user = CAPTION_USER_TEMPLATE.format(aspect_ratio=aspect_ratio, original_prompt=prompt)
    if hasattr(tokenizer, "apply_chat_template") and getattr(tokenizer, "chat_template", None):
        text = tokenizer.apply_chat_template(
            [{"role": "system", "content": CAPTION_SYSTEM_MESSAGE}, {"role": "user", "content": user}],
            add_generation_prompt=True,
            tokenize=False,
        )
        encoded = tokenizer(text, return_tensors="np", add_special_tokens=False)
    else:
        encoded = tokenizer(f"{CAPTION_SYSTEM_MESSAGE}\n\n{user}\n", return_tensors="np")
    return np.asarray(encoded["input_ids"][0], np.int32)


@torch.no_grad()
def upsample_prompt(
    text_encoder: Any,
    head_kernel: Any,
    prompt: str,
    height: int = 1024,
    width: int = 1024,
    temperature: float = PROMPT_UPSAMPLE_TEMPERATURE,
    max_new_tokens: int = DEFAULT_MAX_NEW_TOKENS,
    seed: int = 0,
) -> str:
    """Generate the upsampled caption text for one prompt: the trunk's
    final-norm state of the last token through the head (f32) each step,
    greedy at temperature 0, sampled from the softmax otherwise."""
    tokenizer = text_encoder.tokenizer
    g = math.gcd(int(width), int(height)) or 1
    ids = _chat_tokens(tokenizer, prompt, f"{int(width) // g}:{int(height) // g}")
    device = text_encoder.device
    head = torch.as_tensor(np.asarray(head_kernel) if not torch.is_tensor(head_kernel) else head_kernel,
                           dtype=torch.float32).to(device)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    eos = tokenizer.eos_token_id
    current = torch.as_tensor(ids, device=device)
    out_ids = []
    for _ in range(int(max_new_tokens)):
        hidden = text_encoder.model(current[None], torch.ones_like(current)[None])
        logits = hidden[0, -1].to(torch.float32) @ head
        if temperature and temperature > 0:
            probs = torch.softmax(logits / float(temperature), dim=-1)
            token = int(torch.multinomial(probs, 1, generator=generator))
        else:
            token = int(torch.argmax(logits))
        if eos is not None and token == eos:
            break
        out_ids.append(token)
        current = torch.cat([current, torch.tensor([token], dtype=current.dtype, device=device)])
    text = tokenizer.decode(out_ids, skip_special_tokens=True)
    logger.info("ideogram prompt upsample: %r -> %r", prompt[:60], text[:120])
    return text.strip()
